"""The system under test: the engine of ``timewarp_tpu_torch`` that a
configuration names, built from the configuration's file, and its state
read as plain tensors. The only module of the benchmark that imports the
program.
"""

from __future__ import annotations

import importlib

import torch

#: the program's link classes by the configuration's ``kind``
LINK_CLASSES = {"fixed": "FixedDelay", "uniform": "UniformDelay",
                "lognormal": "LogNormalDelay", "quantize": "Quantize"}
#: counters of ``EngineState`` that the reference keeps too
COUNTERS = ("overflow", "bad_dst", "bad_delay", "short_delay", "route_drop",
            "fault_dropped", "delivered", "steps", "time")


def import_program() -> None:
    """Import the program's engine modules (the set-up span
    ``import_program``)."""
    importlib.import_module("timewarp_tpu_torch.interp.torch_engine.engine")


def build_kernels(device) -> None:
    """Build (first run in a checkout) or find the program's CUDA
    kernels, and load them: the set-up span ``kernels``."""
    if torch.device(device).type != "cuda":
        return
    from timewarp_tpu_torch.utils import build
    for name in build.SOURCES:
        build.library(name)


def program_link(spec: dict):
    delays = importlib.import_module("timewarp_tpu_torch.net.delays")
    args = {k: v for k, v in spec.items() if k != "kind"}
    if "inner" in args:
        args["inner"] = program_link(args["inner"])
    return getattr(delays, LINK_CLASSES[spec["kind"]])(**args)


def scenario(config: dict):
    sc = config["scenario"]
    family = importlib.import_module(
        f"timewarp_tpu_torch.models.{sc['family']}")
    return getattr(family, sc["family"])(sc["n"], **sc["params"])


def build_engine(config: dict, seeds, device):
    """The configuration's engine: solo with ``seeds[0]``, or a fleet of
    ``len(seeds)`` worlds, one seed each."""
    module, cls = config["engine"]["class"].split(":")
    engine_cls = getattr(importlib.import_module(module), cls)
    kwargs = dict(config["engine"]["kwargs"])
    kwargs["window"] = config["window"]
    if len(seeds) > 1:
        from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
        kwargs["batch"] = BatchSpec(seeds=tuple(int(s) for s in seeds))
    else:
        kwargs["seed"] = int(seeds[0])
    return engine_cls(scenario(config), program_link(config["link"]),
                      device=device, **kwargs)


def state_dict(st, worlds: int) -> dict:
    """An ``EngineState`` as the reference's dict, every leaf with a
    world axis."""
    def w(x):
        return x if worlds > 1 else x.unsqueeze(0)
    out = {f"states.{k}": w(v) for k, v in st.states.items()}
    for k in ("wake", "mb_rel", "mb_src", "mb_payload") + COUNTERS:
        out[k] = w(getattr(st, k))
    return out

