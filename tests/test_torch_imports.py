"""The port stands alone: importing ``timewarp_tpu_torch`` (every module
of it) in a fresh interpreter leaves ``jax`` and the reference package
``timewarp_tpu`` out of ``sys.modules``; no source file of the port, nor
``chip_smoke.py``, imports either (the run-mode planes' packages ``obs``,
``integrity``, ``dispatch``, ``speculate`` and ``controlled.py`` also
imported first and alone); and every engine (``TorchEngine``,
``FusedSparseEngine``, ``EdgeEngine``, ``FusedRingEngine``) runs on the
card by default, raising on a machine without CUDA unless the caller
passes ``device="cpu"``.

Tolerance: exact (membership and source checks).
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "timewarp_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _is_reference(name: str) -> bool:
    # the port's own name starts with "timewarp_tpu": match the reference
    # package and its submodules exactly
    return name == "timewarp_tpu" or name.startswith("timewarp_tpu.")


def _is_jax(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name.startswith("jaxlib.")


def test_import_leaves_jax_and_reference_out():
    mods = _modules()
    for m in ("interp.torch_engine.engine", "models.ping_pong",
              "models.socket_state", "net.links",
              "interp.torch_engine.batched", "faults", "faults.apply",
              "faults.schedule", "faults.properties", "utils.checkpoint",
              "obs", "obs.metrics", "obs.telemetry", "obs.flight",
              "integrity", "integrity.checks", "integrity.digest",
              "integrity.inject", "integrity.runner", "dispatch",
              "dispatch.trace", "dispatch.controller",
              "interp.torch_engine.controlled",
              "interp.torch_engine.planes", "speculate", "speculate.plane",
              "speculate.policy", "speculate.equiv", "speculate.runner"):
        assert f"timewarp_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'timewarp_tpu' or m.startswith('timewarp_tpu.')]\n"
        "print(len(bad), sorted(bad)[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


@pytest.mark.parametrize("mod", ["obs", "integrity", "dispatch", "speculate",
                                 "interp.torch_engine.controlled"])
def test_plane_packages_import_alone(mod):
    """Each run-mode plane's package, imported first and alone in a fresh
    interpreter (the plane modules copied from the reference keep their
    own copies of what they need), loads neither."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('timewarp_tpu_torch.{mod}')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'timewarp_tpu' or m.startswith('timewarp_tpu.')]\n"
        "print(len(bad), sorted(bad)[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_sources_import_neither_jax_nor_reference():
    """The package's sources and ``chip_smoke.py``, the script that drives
    the port on the card."""
    offenders = []
    smoke = PKG.parent / "chip_smoke.py"
    assert smoke.exists()
    for path in [*PKG.rglob("*.py"), smoke]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}: {n}" for n in names
                          if _is_jax(n) or _is_reference(n)]
    assert not offenders


def test_engine_raises_without_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import FixedDelay
    sc = gossip(64, burst=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(sc, FixedDelay(5_000), window="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(sc, FixedDelay(5_000), window="auto", device="cuda")
    eng = TorchEngine(sc, FixedDelay(5_000), window="auto", device="cpu")
    assert eng.device.type == "cpu"
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedSparseEngine(sc, FixedDelay(5_000), window="auto")
    assert FusedSparseEngine(sc, FixedDelay(5_000), window="auto",
                             device="cpu").device.type == "cpu"
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import \
        EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    from timewarp_tpu_torch.models.token_ring import token_ring
    ring = token_ring(64, n_tokens=64, think_us=0, with_observer=False)
    for cls in (EdgeEngine, FusedRingEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(ring, FixedDelay(500))
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(ring, FixedDelay(500), device="cuda")
        assert cls(ring, FixedDelay(500), device="cpu").device.type == "cpu"
