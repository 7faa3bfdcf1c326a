"""Card-in-the-loop parity artifact: the oracle on the CPU against the
port's engines on the card.

The twin of ``tools/parity_tpu.py`` for ``timewarp_tpu_torch``: the same
nine configs (builders, links, budgets and knobs), the same columns and
the same digest, each row run by the port's ``SuperstepOracle`` on the
CPU and by ``TorchEngine`` (``EdgeEngine`` on ``token-ring-64-fixed``) on
``--device``. Integer-only link models, so equality is exact across
devices.

Columns, each with the reference's rule:

- **main**: the oracle's trace against the engine's, bit for bit; a
  shorter engine trace is legitimate only when the step cap was hit.
- **fused_sparse**: ``FusedSparseEngine`` with the row's knobs but
  ``route_cap``, against the general engine; a constructor refusal
  records its reason (the text before the first ``" ("``).
- **faulted** (``gossip-64-drop``): a crash, reset crash, partition and
  degradation schedule through the oracle and the engine; trace and
  ``fault_dropped``.
- **batched**: a 3-world fleet (seeds 0, 1, 2); world 0 against the
  solo column, worlds 1 and 2 against their solo runs.

Every digest, ``supported`` flag, superstep count, delivered count and
truncation flag is then held against the reference's committed
``PARITY_TPU.json`` (read as data). One stated exception: the
reference's fused engine refuses a node count that is not a multiple of
1024 (a TPU lane-tiling rule the port does not copy); on such a row the
port's fused column runs on K3 and its digest must equal the row's
``engine_sha``, the reason kept under ``reference_refused``. A
difference sets ``ok`` false and is listed under ``reference_mismatch``.
Each row records its wall and the launches of K1, K2 and K3 by column.

Usage::

    python3 tools/parity_cuda.py                 # the card; writes PARITY_CUDA.json
    python3 tools/parity_cuda.py --device cpu --self-check
    python3 tools/parity_cuda.py --configs ping-pong,socket-state-4 ...

``--self-check`` runs everything and writes nothing; ``--out PATH``
writes elsewhere. The artifact's JSON is also printed on one line, then
the last line ``{"parity_cuda_ok": ..., "engine_platform": ...}``. Exits
nonzero on any mismatch, and without a card unless given
``--device cpu``.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

#: the reference's artifact, read as data
REFERENCE = os.path.join(ROOT, "PARITY_TPU.json")
#: this tool's artifact
ARTIFACT = os.path.join(ROOT, "PARITY_CUDA.json")
COLUMNS = ("fused_sparse", "faulted", "batched")
#: the reference's fused refusal that the port does not copy
LANE_RULE = "n_nodes must be a multiple of 1024"
NO_WORLD_AXIS = ("engine has no world axis (batch=BatchSpec is the "
                 "general engine's lever)")
KERNELS = ("fire_compact", "mailbox_insert", "sample_insert")


def trace_sha(tr) -> str:
    """The reference's digest: sha256 over the eight trace fields, the
    first 16 hex digits."""
    h = hashlib.sha256()
    for f in ("times", "fired_count", "fired_hash", "recv_count",
              "recv_hash", "sent_count", "sent_hash", "overflow"):
        h.update(np.ascontiguousarray(getattr(tr, f)).tobytes())
    return h.hexdigest()[:16]


def configs() -> dict:
    """name -> (scenario, link, engine kind, steps, engine knobs): the
    reference tool's nine rows, built from the port's models."""
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.models.ping_pong import ping_pong
    from timewarp_tpu_torch.models.praos import praos
    from timewarp_tpu_torch.models.socket_state import socket_state
    from timewarp_tpu_torch.models.token_ring import (token_ring,
                                                      token_ring_links)
    from timewarp_tpu_torch.net.delays import (FixedDelay, Quantize,
                                               UniformDelay, WithDrop)
    wlink = Quantize(UniformDelay(3_000, 9_000), 1_000)  # min delay 3 ms
    return {
        "ping-pong": (
            ping_pong(rounds=50), UniformDelay(500, 2_000),
            "general", 400, {}),
        "token-ring-64-fixed": (
            token_ring(64, n_tokens=16, think_us=2_000, bootstrap_us=1000,
                       end_us=400_000, with_observer=False, mailbox_cap=6),
            FixedDelay(1_500), "edge", 600, {}),
        "token-ring-64-observer": (
            token_ring(64, n_tokens=8, think_us=3_000, bootstrap_us=1000,
                       end_us=300_000, with_observer=True, mailbox_cap=16),
            token_ring_links(64), "general", 600, {}),
        "gossip-64-drop": (
            gossip(64, fanout=6, think_us=3_000, gossip_interval=1_000,
                   end_us=5_000_000),
            WithDrop(UniformDelay(2_000, 30_000), 0.15), "general", 800, {}),
        "gossip-64-burst-windowed": (
            gossip(64, fanout=4, think_us=700, burst=True,
                   end_us=400_000, mailbox_cap=16),
            wlink, "general", 600, {"window": 3_000}),
        "praos-48-burst-windowed-routecap": (
            praos(48, slot_us=20_000, n_slots=6, leader_prob=2.0 / 48,
                  fanout=4, burst=True, mailbox_cap=16),
            wlink, "general", 600, {"window": 3_000, "route_cap": 96}),
        "socket-state-4": (
            socket_state(n_clients=3, seed=24, send_interval_us=50_000,
                         server_life_us=120_000),
            wlink, "general", 400, {}),
        "socket-state-1024-windowed": (
            socket_state(n_clients=1023, seed=1,
                         send_interval_us=20_000,
                         server_life_us=2_000_000, mailbox_cap=64),
            wlink, "general", 250, {"window": 3_000}),
        "gossip-1024-burst-windowed": (
            gossip(1024, fanout=4, think_us=700, burst=True,
                   end_us=400_000, mailbox_cap=16),
            wlink, "general", 600, {"window": 3_000}),
    }


def fault_schedule():
    """The faulted column's schedule (``gossip-64-drop`` only)."""
    from timewarp_tpu_torch.faults import (FaultSchedule, LinkWindow,
                                           NodeCrash, Partition)
    return FaultSchedule((
        NodeCrash(3, 200_000, 900_000, reset_state=True),
        NodeCrash(17, 100_000, 500_000),
        Partition((tuple(range(32)), tuple(range(32, 64))),
                  300_000, 1_200_000),
        LinkWindow(None, None, 1_500_000, 2_500_000,
                   scale=2.0, extra_us=1_000),
    ))


class _Launches:
    """K1-K3 launches by column (the wrappers' counts, which only a
    launch on the card moves)."""

    def __init__(self):
        self.by_column = {}

    def __call__(self, column, fn):
        from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
        before = {k: ci.LAUNCHES[k] for k in KERNELS}
        try:
            return fn()
        finally:
            got = self.by_column.setdefault(column, dict.fromkeys(KERNELS, 0))
            for k in KERNELS:
                got[k] += ci.LAUNCHES[k] - before[k]


def _compare(entry, key, a, b, a_name, b_name, limit=None):
    """``assert_traces_equal`` into ``entry``: ``equal`` and, on a
    difference, ``mismatch``. Returns whether they agreed."""
    from timewarp_tpu_torch.trace.events import (TraceMismatch,
                                                 assert_traces_equal)
    try:
        assert_traces_equal(a, b, a_name, b_name, limit=limit)
    except TraceMismatch as e:
        entry[key] = False
        entry["mismatch"] = str(e)
        return False
    entry[key] = True
    return True


def run_row(name: str, device="cuda", columns=COLUMNS,
            reference=REFERENCE) -> dict:
    """One config's entry, the reference tool's keys and rules, on
    ``device`` (the oracle on the CPU). ``columns`` names the extra
    columns to run (the main one always runs); ``reference`` is the
    reference's artifact (a path or its parsed dict; None: no check).
    Adds ``wall_s``, ``oracle_wall_s``, ``launches`` by column, and
    ``reference_mismatch`` when a field differs from the reference's."""
    import torch

    from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import \
        EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    dev = torch.device(device)
    plat = dev.type
    t0 = time.perf_counter()
    sc, link, kind, steps, ekw = configs()[name]
    eng_cls = EdgeEngine if kind == "edge" else TorchEngine
    count = _Launches()

    otrace = SuperstepOracle(sc, link, window=ekw.get("window", 1),
                             device="cpu").run(20 * steps)
    oracle_wall = time.perf_counter() - t0
    _, etrace = count("main", lambda: eng_cls(sc, link, device=dev,
                                              **ekw).run(steps))
    entry = {
        "supersteps": len(etrace),
        "delivered": etrace.total_delivered(),
        "oracle_sha": trace_sha(otrace),
        "engine_sha": trace_sha(etrace),
    }
    truncated = len(etrace) == steps and len(otrace) > steps
    entry["truncated_at_step_cap"] = truncated
    _compare(entry, "equal", otrace, etrace, "oracle-cpu", f"engine-{plat}",
             limit=steps if truncated else None)

    if "fused_sparse" in columns:
        fkw = {k: v for k, v in ekw.items() if k != "route_cap"}
        try:
            fused = FusedSparseEngine(sc, link, device=dev, **fkw)
        except ValueError as e:
            entry["fused_sparse"] = {"supported": False,
                                     "reason": str(e).split(" (")[0]}
        else:
            _, ftrace = count("fused_sparse", lambda: fused.run(steps))
            fent = {"supported": True, "sha": trace_sha(ftrace)}
            _compare(fent, "equal", etrace, ftrace, f"general-{plat}",
                     f"fused-sparse-{plat}")
            entry["fused_sparse"] = fent

    if "faulted" in columns and name == "gossip-64-drop":
        fsched = fault_schedule()
        fo = SuperstepOracle(sc, link, faults=fsched, device="cpu")
        fotrace = fo.run(20 * steps)
        fstate, fetrace = count("faulted", lambda: TorchEngine(
            sc, link, faults=fsched, device=dev).run(steps))
        fent = {"supported": True, "sha": trace_sha(fetrace),
                "fault_dropped": int(fstate.fault_dropped)}
        if _compare(fent, "equal", fotrace, fetrace, "oracle-cpu",
                    f"faulted-engine-{plat}") and \
                fo.fault_dropped_total != fent["fault_dropped"]:
            fent["equal"] = False
            fent["mismatch"] = (f"fault_dropped diverged: oracle "
                                f"{fo.fault_dropped_total} vs engine "
                                f"{fent['fault_dropped']}")
        entry["faulted"] = fent

    if "batched" in columns:
        if eng_cls is TorchEngine:
            _, btr = count("batched", lambda: TorchEngine(
                sc, link, batch=BatchSpec(seeds=(0, 1, 2)), device=dev,
                **ekw).run(steps))
            bent = {"supported": True, "sha": [trace_sha(t) for t in btr]}
            ok = _compare(bent, "equal", etrace, btr[0], f"solo-{plat}",
                          f"batched-w0-{plat}")
            for b in (1, 2):
                if not ok:
                    break
                _, strc = count("batched", lambda b=b: TorchEngine(
                    sc, link, seed=b, device=dev, **ekw).run(steps))
                ok = _compare(bent, "equal", strc, btr[b],
                              f"solo-seed{b}-{plat}",
                              f"batched-w{b}-{plat}")
            entry["batched"] = bent
        else:
            entry["batched"] = {"supported": False, "reason": NO_WORLD_AXIS}

    entry["wall_s"] = time.perf_counter() - t0
    entry["oracle_wall_s"] = oracle_wall
    entry["launches"] = count.by_column
    if reference is not None:
        if isinstance(reference, str):
            with open(reference) as f:
                reference = json.load(f)
        diff = reference_diff(entry, reference["configs"][name], columns)
        if diff:
            entry["reference_mismatch"] = diff
    return entry


def reference_diff(entry, ref, columns=COLUMNS) -> dict:
    """Every field of ``entry`` that differs from the reference's entry
    ``ref``, over the main column and ``columns`` (those the row ran):
    ``{field: {"port": x, "reference": y}}``. Records the reference's
    1024-lane refusal under ``entry["fused_sparse"]["reference_refused"]``."""
    diff = {}

    def same(field, got, want):
        if got != want:
            diff[field] = {"port": got, "reference": want}

    for f in ("supersteps", "delivered", "truncated_at_step_cap",
              "oracle_sha", "engine_sha"):
        same(f, entry[f], ref[f])
    for col in columns:
        got, want = entry.get(col), ref.get(col)
        if got is None or want is None:
            same(col, "absent" if got is None else "present",
                 "absent" if want is None else "present")
            continue
        if (col == "fused_sparse" and not want["supported"]
                and want["reason"] == LANE_RULE):
            # the TPU's lane rule: the port runs the row on K3, and the
            # column's law (fused = general) pins its digest
            got["reference_refused"] = want["reason"]
            same(f"{col}.supported", got["supported"], True)
            same(f"{col}.sha", got.get("sha"), ref["engine_sha"])
            continue
        for k in ("supported", "sha", "fault_dropped", "reason"):
            if k in want or k in got:
                same(f"{col}.{k}", got.get(k), want.get(k))
    return diff


def row_ok(entry) -> bool:
    """Every law of the row held and it equals the reference."""
    return (entry["equal"] and "reference_mismatch" not in entry
            and all(entry[c].get("equal", True) for c in COLUMNS
                    if c in entry))


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    import torch

    from timewarp_tpu_torch.cli import require_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--self-check", action="store_true",
                    help="run every comparison and write nothing")
    ap.add_argument("--configs", default=None,
                    help="comma-separated row names (default: all nine)")
    ap.add_argument("--reference", default=REFERENCE,
                    help="the reference's artifact to hold the rows to")
    ap.add_argument("--out", default=ARTIFACT)
    a = ap.parse_args(argv)
    dev = torch.device(require_device(a.device))
    with open(a.reference) as f:
        reference = json.load(f)
    names = list(configs()) if a.configs is None else a.configs.split(",")
    out = {"engine_platform": dev.type, "oracle_platform": "cpu",
           "configs": {}, "ok": True,
           "device": nvidia_smi() if dev.type == "cuda" else "cpu",
           "torch": torch.__version__}
    for name in names:
        entry = run_row(name, dev, reference=reference)
        out["configs"][name] = entry
        out["ok"] = out["ok"] and row_ok(entry)
        words = []
        for col in COLUMNS:
            c = entry.get(col)
            if c is not None:
                words.append(f"{col} " + ("out of scope" if not c["supported"]
                                          else "OK" if c["equal"]
                                          else "MISMATCH"))
        ref_word = ("reference MISMATCH "
                    + ",".join(entry["reference_mismatch"])
                    if "reference_mismatch" in entry else "= reference")
        print(f"{name}: {'OK' if entry['equal'] else 'MISMATCH'} "
              f"({entry['supersteps']} supersteps, {entry['delivered']} "
              f"delivered, {', '.join(words)}; {ref_word}; "
              f"wall_s={entry['wall_s']:.3f} launches={entry['launches']})",
              flush=True)
    if not a.self_check:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    print(json.dumps(out))
    print(json.dumps({"parity_cuda_ok": out["ok"],
                      "engine_platform": dev.type}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
