"""Multi-device artifact: the port's four sharded engines over NCCL, one
card a rank, each run held bit for bit against its one-device run.

The twin of ``__graft_entry__.py``'s ``dryrun_multichip`` for
``timewarp_tpu_torch``, as ``tools/parity_cuda.py`` is the twin of
``tools/parity_tpu.py``. The reference runs one ``shard_map`` program per
device with its collectives on the devices (``ppermute``,
``all_to_all``, ``psum``); here ``parallel.launch.spawn`` starts one
rank per card, rank r on ``cuda:r``, and every collective of
``MeshComm`` runs on device tensors through NCCL. Rows, in order:

1. ``dryrun_ring``: ``ShardedEdgeEngine``, token ring of 32·N nodes,
   ``UniformDelay(200, 900)``, 20 supersteps (delivery by ``roll``)
   against ``EdgeEngine``: trace, every leaf, ``delivered`` > 0,
   ``overflow`` 0, a shard width of 32 on every rank;
2. ``dryrun_all2all``: ``ShardedEngine``, gossip of 16·N nodes, fanout
   4, 60 supersteps (the ``all_to_all`` exchange) against
   ``TorchEngine``;
3. ``dryrun_windowed``: ``ShardedEngine(window=2_000)``, burst gossip of
   16·N nodes on ``Quantize(UniformDelay(2_000, 6_000), 1_000)``, 60
   supersteps, against ``TorchEngine(window=2_000)``; ``short_delay`` 0;
4. steady gossip at 2^20 (chip_smoke phase 52): ``ShardedFusedSparseEngine``
   (K1′ once per superstep on every rank) and ``ShardedEngine``, 64
   supersteps, and the verified legs, against ``TorchEngine``;
5. the dense ring at 2^20 (phase 53): ``ShardedEdgeEngine`` against
   ``EdgeEngine``;
6. the chaos fleet, 8 worlds of 100 000 nodes (phase 54):
   ``ShardedBatchedEngine`` to quiescence, ``run_verified`` and
   ``run_stream``, against the one-device fleet and its drivers;
7. weak scaling: ``ShardedFusedSparseEngine`` on steady gossip at 2^20
   nodes a rank against ``TorchEngine`` at 2^20·N on one card;
8. the transport baseline: row 4's fused engine over gloo ranks, one
   card a rank (every collective through host buffers).

Rows 4-6 run chip_smoke's own rank functions and checks
(``chip_smoke.phase_sharded``), rows 7 and 8 the same with one engine.
Every law is exact: a row is equal when every leaf of the gathered
state, every counter and the trace equal the one-device run's. Each row
records its wall per superstep and supersteps, the shares of the
superstep spent in the exchange and in the reductions, the idle share of
each rank's card (NCCL's kernels, which wait on the other ranks, apart)
and, where it runs K1′, K1′'s time beside its bound.

Usage::

    python3 tools/multichip_cuda.py --ranks 4 --out MULTICHIP_CUDA.json
    python3 tools/multichip_cuda.py --ranks 4 --dist-backend gloo \\
        --device cpu --out /tmp/multichip.json     # rows 1-3 on the CPU

``--rows`` picks rows (default: 1-8 on the card, 1-3 on the CPU; rows
4-8 run at full width and only on the card). ``--dist-backend nccl`` (the
default) needs one card a rank and refuses ``--device cpu``; nothing
falls back to gloo. Writes the JSON to ``--out`` (the reference record's
keys ``n_devices``, ``rc``, ``ok``, ``skipped``, ``tail``, plus
``backend``, ``device``, ``topology``, ``torch`` and ``rows``), prints a
line a row and last ``{"multichip_cuda_ok": ...}``; exits 1 when any row
differs, and without a card unless given ``--device cpu``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
for _p in (ROOT, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from parity_cuda import trace_sha  # noqa: E402

ROWS = {1: "dryrun_ring", 2: "dryrun_all2all", 3: "dryrun_windowed",
        4: "steady_gossip", 5: "dense_ring", 6: "chaos_fleet",
        7: "weak_scaling", 8: "transport_baseline"}
#: the rows that run at small shapes, on the CPU too
DRYRUN_ROWS = (1, 2, 3)
#: dryrun_multichip's supersteps (rows 2 and 3 run three times as many)
DRYRUN_STEPS = 20
#: the nodes a rank holds in row 7
WEAK_N_LOCAL = 1 << 20


def dryrun_config(row, n_ranks):
    """Row ``row`` of 1-3 at ``n_ranks`` ranks: ``(scenario, link,
    supersteps, engine kwargs)`` (``__graft_entry__.py:76-118``)."""
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.net.delays import Quantize, UniformDelay
    link = UniformDelay(200, 900)
    if row == 1:
        return token_ring(32 * n_ranks, n_tokens=32 * n_ranks,
                          think_us=1_000, bootstrap_us=1_000,
                          end_us=1 << 50, with_observer=False,
                          mailbox_cap=4), link, DRYRUN_STEPS, {}
    if row == 2:
        return gossip(16 * n_ranks, fanout=4, think_us=2_000,
                      gossip_interval=1_000, end_us=400_000,
                      mailbox_cap=8), link, DRYRUN_STEPS * 3, {}
    return gossip(16 * n_ranks, fanout=4, think_us=700, burst=True,
                  end_us=400_000, mailbox_cap=16), \
        Quantize(UniformDelay(2_000, 6_000), 1_000), DRYRUN_STEPS * 3, \
        {"window": 2_000}


def rank_dryrun(device, rows, started=None, profile=True):
    """Rows ``rows`` of 1-3 in one rank (the target of ``spawn``): each
    sharded engine through ``run``, timed by chip_smoke's ``_rank_run``
    with the kernels' launches counted over it; the trace, the rank's
    shard width and, on rank 0, the gathered state. The collectives are
    warmed first (chip_smoke ``warm_transport``). The construction
    lint is off here (a rank's first trace costs seconds): the
    one-device engines lint the same scenarios. ``started`` (the
    caller's ``time.time()`` at the spawn) times the rank's start;
    ``profile`` false skips the profiled supersteps (no idle share)."""
    import torch.distributed as dist
    from chip_smoke import _rank_run, warm_transport
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.sharded import (
        ShardedEdgeEngine, ShardedEngine)
    from timewarp_tpu_torch.interp.torch_engine.state_io import (
        edge_state_to_numpy, state_to_numpy)
    from timewarp_tpu_torch.parallel import make_mesh
    D, rank = dist.get_world_size(), dist.get_rank()
    if started is not None:
        print(f"rank {rank}: started and joined the group "
              f"{time.time() - started} s after the spawn", flush=True)
    mesh = make_mesh()
    warm_transport(device)
    out = {}
    for row in rows:
        t0 = time.perf_counter()
        sc, link, steps, kw = dryrun_config(row, D)
        cls = ShardedEdgeEngine if row == 1 else ShardedEngine
        eng = cls(sc, link, mesh, lint="off", device=device, **kw)
        built = time.perf_counter() - t0
        ci.reset_launches()
        (st, tr), rec = _rank_run(
            f"row {row} {ROWS[row]} {cls.__name__} n={sc.n_nodes}",
            lambda: eng.run(steps), eng.comm, lambda r: len(r[1]),
            (lambda r: eng.run_quiet(16, r[0])) if profile else None)
        g = eng.gather_state(st)
        g = edge_state_to_numpy(g) if row == 1 else state_to_numpy(g, sc)
        out[row] = dict(rec, trace=tr, shard_width=int(st.wake.shape[-1]),
                        state=g if rank == 0 else None)
        print(f"rank {rank} row {row}: built in {built} s, run, profiled "
              f"and gathered in {time.perf_counter() - t0 - built} s",
              flush=True)
    return out


def run_dryrun_rows(device, n_ranks, backend, rows=DRYRUN_ROWS,
                    threads=None, profile=True):
    """Rows ``rows`` of 1-3: the one-device runs on ``device``, then the
    sharded runs in ``n_ranks`` ranks over ``backend``, each held equal
    (every rank's trace, rank 0's gathered state leaf for leaf, the
    row's own invariants; on the card K1 once per superstep on rows 2
    and 3, no kernel on row 1). ``profile`` as :func:`rank_dryrun`'s.
    Raises on the first difference; returns ``{row: every rank's
    result}`` and the one-device traces."""
    import torch
    from chip_smoke import _np_states_equal, _require_all
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import (
        edge_state_to_numpy, state_to_numpy)
    from timewarp_tpu_torch.parallel.launch import spawn
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    solo = {}
    t0 = time.perf_counter()
    for row in rows:
        sc, link, steps, kw = dryrun_config(row, n_ranks)
        if row == 1:
            st, tr = EdgeEngine(sc, link, device=device).run(steps)
            solo[row] = (tr, edge_state_to_numpy(st))
        else:
            st, tr = TorchEngine(sc, link, device=device, **kw).run(steps)
            solo[row] = (tr, state_to_numpy(st, sc))
    t1 = time.perf_counter()
    res = spawn("multichip_cuda:rank_dryrun", n_ranks, backend=backend,
                device=device.type,
                args=(tuple(rows), time.time(), profile), threads=threads)
    print(f"rows {list(rows)}: one-device runs {t1 - t0} s, {n_ranks} "
          f"{backend} ranks started and run in {time.perf_counter() - t1} s",
          flush=True)
    card = device.type == "cuda"
    for row in rows:
        want_tr, want_st = solo[row]
        per = [r[row] for r in res]
        for r, got in enumerate(per):
            assert_traces_equal(want_tr, got["trace"], "one device",
                                f"row {row} rank {r}")
        _np_states_equal(f"row {row} {ROWS[row]}: sharded vs one device",
                         want_st, per[0]["state"])
        width = 32 if row == 1 else 16
        checks = {
            "delivered > 0": int(want_st["delivered"]) > 0,
            f"a shard width of {width} on every rank":
                {g["shard_width"] for g in per} == {width}}
        if row == 1:
            checks["overflow 0"] = int(want_st["overflow"]) == 0
        if row == 3:
            checks["short_delay 0"] = int(want_st["short_delay"]) == 0
        if card:
            for r, g in enumerate(per):
                ln = g["launches"]
                k1 = len(want_tr) if row != 1 else 0
                checks[f"rank {r}: K1 {k1} times, no K2/K3/K4"] = (
                    ln["mailbox_insert"] == k1 and ln["fire_compact"]
                    == ln["sample_insert"] == ln["fused_ring"] == 0)
        _require_all(f"row {row} {ROWS[row]}", checks)
    if card:
        torch.cuda.empty_cache()
    return {row: [r[row] for r in res] for row in rows}, \
        {row: solo[row][0] for row in rows}


# -- the artifact ------------------------------------------------------------

def _shares(recs):
    """A run's per-rank timing records (chip_smoke ``_rank_run``) as the
    artifact's columns."""
    out = {"supersteps": recs[0]["steps"],
           "wall_ms_per_superstep": [r["wall"] / max(r["steps"], 1) * 1e3
                                     for r in recs],
           "exchange_share": [r["exchange_s"] / r["wall"] for r in recs],
           "reduce_share": [r["reduce_s"] / r["wall"] for r in recs],
           "launches": [r["launches"] for r in recs]}
    if "idle_share_rank" in recs[0]:
        out.update(card=[r["card"] for r in recs],
                   idle_share=[r["idle_share_rank"] for r in recs],
                   idle_share_card=[r["idle_share_card"] for r in recs],
                   nccl_kernel_s=[r["nccl_s"] for r in recs])
    return out


def _k1p(recs):
    """K1′ on every rank at its busiest superstep: time, plain time and
    bound (ms), entries, shape, bit-equality error."""
    return [{k: r["k1p"][k] for k in ("ms", "plain_ms", "bound_ms", "err",
                                      "valid", "n_local", "S2")}
            for r in recs]


def _solo_ms(device, n, steps):
    """Wall ms per superstep of ``TorchEngine`` on steady gossip at ``n``
    on one card: a fresh ``run(steps)``, as each rank times its own."""
    import torch
    from chip_smoke import steady_gossip
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    eng = TorchEngine(*steady_gossip(n), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tr = eng.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    return wall / max(len(tr), 1) * 1e3


ROW_META = {
    1: ("ShardedEdgeEngine", "token ring, 32·N nodes, UniformDelay(200, "
        "900), 20 supersteps", "EdgeEngine, one device", "none"),
    2: ("ShardedEngine", "gossip, 16·N nodes, fanout 4, 60 supersteps",
        "TorchEngine, one device", "K1"),
    3: ("ShardedEngine(window=2_000)", "burst gossip, 16·N nodes, "
        "Quantize(UniformDelay(2_000, 6_000), 1_000), 60 supersteps",
        "TorchEngine(window=2_000), one device", "K1"),
    4: ("ShardedFusedSparseEngine and ShardedEngine", "steady gossip, n = "
        "2^20, 64 supersteps; verify digest and shadow, 32 supersteps",
        "TorchEngine, one device", "K1' once per superstep per rank"),
    5: ("ShardedEdgeEngine", "dense ring, n = 2^20, 64 supersteps",
        "EdgeEngine, one device", "none"),
    6: ("ShardedBatchedEngine", "chaos fleet, 8 worlds x 100 000 nodes, to "
        "quiescence; run_verified and run_stream",
        "the one-device fleet and its drivers", "K2 and K1"),
    7: ("ShardedFusedSparseEngine", "steady gossip, 2^20 nodes a rank, 64 "
        "supersteps", "TorchEngine at 2^20·N, one device", "K1'"),
    8: ("ShardedFusedSparseEngine over gloo, one card a rank",
        "as row 4", "TorchEngine, one device (row 4's result)", "K1'"),
}


def run_rows(device, n_ranks, backend, rows, threads=None):
    """Run ``rows`` and return ``(row records, ok, tail)``. Rows 1-3 run
    in one spawn, rows 4-6 in another, rows 7 and 8 in one each; a group
    that raises records each of its rows unequal (its traceback once in
    the tail), and the next group runs. A row's ``wall_s`` is its
    group's."""
    import chip_smoke as cs
    recs, tails = [], []

    def group(members, run, pick):
        members = [r for r in members if r in rows]
        if not members:
            return
        t0 = time.perf_counter()
        try:
            res, err = run(members), None
        except Exception:
            res, err = None, traceback.format_exc()
            tails.append(f"rows {members}:\n{err}")
        wall = time.perf_counter() - t0
        for row in members:
            engine, shape, against, kernels = ROW_META[row]
            entry = {"row": row, "name": ROWS[row], "engine": engine,
                     "shape": shape, "held_against": against,
                     "kernels": kernels, "equal": err is None}
            if err is None:
                entry.update(pick(row, res))
            else:
                entry["error"] = err.strip().splitlines()[-1]
            entry["wall_s"] = wall
            recs.append(entry)
            print(f"row {row} {ROWS[row]}: "
                  + ("= one device" if err is None else
                     f"DIFFERS: {entry['error']}")
                  + f" wall_s={wall:.3f}"
                  + "".join(f" {k}={entry[k]}" for k in (
                      "supersteps", "wall_ms_per_superstep",
                      "exchange_share", "idle_share") if k in entry),
                  flush=True)
        if device.type == "cuda":
            import torch
            torch.cuda.empty_cache()

    def pick_dryrun(row, res):
        per, solo = res[0][row], res[1][row]
        return dict(_shares(per), trace_sha=trace_sha(per[0]["trace"]),
                    one_device_trace_sha=trace_sha(solo),
                    delivered=solo.total_delivered())

    group(DRYRUN_ROWS, lambda members: run_dryrun_rows(
        device, n_ranks, backend, members, threads), pick_dryrun)

    def run_full(members):
        fin = None
        if 6 in members:            # phase 27's fleet, to quiescence
            fin = cs.fleet_engine(device)[0].run_quiet(1 << 20)
        out = cs.phase_sharded(device, fin, ranks=n_ranks, backend=backend,
                               phases=tuple(r + 48 for r in members))
        return out[3], _solo_ms(device, cs.STEADY_N, cs.SHARD_STEPS) \
            if 4 in members else None

    def pick_full(row, res):
        per = res[0][row + 48]
        if row == 4:
            return dict(_shares([p["fused"] for p in per]),
                        general=_shares([p["general"] for p in per]),
                        verified={m: [p[f"verify_{m}"]["wall"] for p in per]
                                  for m, _ in cs.SHARD_VERIFY},
                        k1p=_k1p(per),
                        trace_sha=trace_sha(per[0]["fused"]["trace"]),
                        one_device_wall_ms_per_superstep=res[1])
        if row == 5:
            return dict(_shares(per), trace_sha=trace_sha(per[0]["trace"]))
        return dict(_shares(per), drivers={
            leg: [p[leg]["wall"] for p in per]
            for leg in ("verified", "stream")})

    group((4, 5, 6), run_full, pick_full)

    def fused_only(n, be):
        def run(members):
            sizes = (n, cs.RING_N, cs.CHAOS_N, 1 << 12)
            out = cs.phase_sharded(device, None, sizes=sizes, ranks=n_ranks,
                                   backend=be, phases=(52,),
                                   engines=("fused",), verified=False)
            return out[3][52], _solo_ms(device, n, cs.SHARD_STEPS)

        def pick(row, res):
            per, solo = res
            return dict(_shares([p["fused"] for p in per]), k1p=_k1p(per),
                        nodes=n, backend=be,
                        trace_sha=trace_sha(per[0]["fused"]["trace"]),
                        one_device_wall_ms_per_superstep=solo)
        return run, pick

    group((7,), *fused_only(WEAK_N_LOCAL * n_ranks, backend))
    group((8,), *fused_only(cs.STEADY_N, "gloo"))
    ok = all(e["equal"] for e in recs)
    return recs, ok, "\n".join(tails)[-8000:]


def topology() -> dict:
    """The link between the cards: ``nvidia-smi topo -m``'s matrix (or
    what it printed when it failed, as it does on a one-card machine),
    and torch's peer-access matrix, card by card."""
    import torch
    p = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                       text=True, timeout=60)
    n = torch.cuda.device_count()
    return {"nvidia_smi_topo_m": (p.stdout if p.returncode == 0 else
                                  f"exit {p.returncode}: "
                                  f"{(p.stdout + p.stderr).strip()}"),
            "peer_access": [[i == j or torch.cuda.can_device_access_peer(
                i, j) for j in range(n)] for i in range(n)]}


def main(argv=None) -> int:
    import torch

    from bench_cuda import nvidia_smi
    from timewarp_tpu_torch.cli import require_device
    from timewarp_tpu_torch.parallel.mesh import check_backend
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks, one card each under nccl (default 4)")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", default=None,
                    help="comma-separated row numbers (default: 1-8 on "
                         "the card, 1-3 on the CPU)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads a rank (default: the host's "
                         "cores shared among the ranks)")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "MULTICHIP_CUDA.json"))
    a = ap.parse_args(argv)
    if a.ranks < 1:
        raise SystemExit(f"--ranks must be >= 1, got {a.ranks}")
    if a.dist_backend == "nccl" and a.device == "cpu":
        raise SystemExit(
            "--dist-backend nccl ships device tensors, one CUDA device a "
            "rank, and --device cpu has none; run CPU ranks with "
            "--dist-backend gloo")
    dev = torch.device(require_device(a.device))
    try:
        check_backend(a.dist_backend, a.ranks)
    except RuntimeError as e:
        raise SystemExit(f"--dist-backend {a.dist_backend} --ranks "
                         f"{a.ranks}: {e}") from None
    rows = (list(ROWS) if dev.type == "cuda" else list(DRYRUN_ROWS)) \
        if a.rows is None else [int(r) for r in a.rows.split(",")]
    bad = [r for r in rows if r not in ROWS]
    if bad:
        raise SystemExit(f"--rows: no row {bad}; rows are 1-8")
    if dev.type == "cpu" and any(r not in DRYRUN_ROWS for r in rows):
        raise SystemExit(
            "rows 4-8 run at full width (2^20 nodes and more) and only on "
            "the card; on the CPU run --rows 1,2,3")
    card = dev.type == "cuda"
    if card:
        from timewarp_tpu_torch.utils import build
        t0 = time.perf_counter()
        build.build_all()          # once, before the ranks start
        print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    out = {"n_devices": a.ranks, "rc": 0, "ok": True, "skipped": False,
           "tail": "", "backend": a.dist_backend,
           "device": nvidia_smi() if card else "cpu",
           "topology": topology() if card else None,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "cards": torch.cuda.device_count() if card else 0}
    print(out["device"], flush=True)
    t0 = time.perf_counter()
    recs, ok, tail = run_rows(dev, a.ranks, a.dist_backend, rows,
                              a.threads)
    out.update(rows=recs, ok=ok, rc=0 if ok else 1, tail=tail,
               wall_s=time.perf_counter() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1, default=_plain)
        f.write("\n")
    print(json.dumps({"multichip_cuda_ok": ok, "n_devices": a.ranks,
                      "backend": a.dist_backend, "device": dev.type}))
    return out["rc"]


def _plain(x):
    """numpy scalars as JSON numbers."""
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON")


if __name__ == "__main__":
    sys.exit(main())
