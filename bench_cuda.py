"""Benchmark driver of the PyTorch/H100 port: delivered-messages/sec
across the baseline workloads, on ``timewarp_tpu_torch``'s engines.

The twin of ``bench.py``: the same 22 configs (``CONFIGS``), the same
default shapes, the same ``SMOKE`` shapes, the same in-bench gates and
the same BENCH_SCHEMA=2 line, run by the port. It imports ``torch``,
numpy and ``timewarp_tpu_torch`` only.

Usage::

    python3 bench_cuda.py                    # TW_BENCH_CONFIG on the card
    python3 bench_cuda.py --reps 3 --ledger DIR
    python3 bench_cuda.py --smoke            # every config at its SMOKE shape
    python3 bench_cuda.py --device cpu --smoke

Env knobs: ``TW_BENCH_CONFIG`` (default ``token_ring_dense``; under
``--smoke`` a comma-separated subset), ``TW_BENCH_NODES``,
``TW_BENCH_STEPS`` (the measured window), ``TW_HBM_GBPS`` (the
``_insert`` configs' roofline, default the H100's 3350 GB/s). ``--reps
K`` repeats the measured window K times and reports the median rate with
min/max; ``--smoke`` refuses it. ``--ledger DIR`` appends every line to
the port's run ledger (``timewarp_tpu_torch/obs/ledger.py``;
``python -m timewarp_tpu_torch ledger compare`` gates two batches).
``--device cuda|cpu``: the card by default; without one the script exits
and names ``--device cpu``. Nothing falls back to the CPU.

The line carries ``bench.py``'s keys, with ``platform`` ``cuda`` or
``cpu``, ``device_kind`` the card's name, ``torch_version`` for
``jax_version``, and ``power_limit``, the limit ``nvidia-smi
--query-gpu=name,power.limit`` prints (null on the CPU). ``calib`` is
``bench.py``'s frozen fingerprint, 64 rounds of a sort over 2^20 int32,
as ``torch.sort`` on the device. The lint gate runs first; the kernels'
build, the first ``make_fx`` and each config's warm run stay outside
every timed window: a window starts on an idle device and ends on a
host readback.

Stated differences from ``bench.py``:

- The ``_insert`` configs: the port has one insertion stage, so the
  line reports, on the stage arguments of the busiest superstep of the
  gate's 12 (taken where ``eng.stage`` receives them), K2's and K1's
  time and their plain versions' time, a bit-equality gate between the
  two, and the achieved-bytes fraction of ``TW_HBM_GBPS`` from K1's and
  K2's byte counts (``k1_bytes``, ``fleet_k2_bytes``).
- ``compiles`` is 0 where the reference counts jit caches.
- The reference's lane-tiling refusals are not copied: the fused ring
  runs at any node count.
- The wall-clock gates (telemetry, verify, and the controller's and
  speculation's wall gains) are strict only on ``cuda`` at non-smoke
  shapes; every deterministic gate always asserts. The overhead gates
  (telemetry, verify, record) time the modes' runs in turns, round after
  round, and take each mode's median (where a gate is strict, 15 rounds
  for telemetry and 5 for verify and record; else ``bench.py``'s 3, 2
  and 3), where ``bench.py`` times one mode's runs back to back, then
  the next mode's: on the card's shared host a run's wall drifts by more
  than the gates' 5-10% budgets from one stretch to the next. The
  budgets are ``bench.py``'s.
- ``praos_1m_fused``'s ``max_batch`` and ``praos_1m_insert``'s
  ``insert_cap`` are ``n * max_out``: ``bench.py``'s ``1 << 17`` caps
  drop messages at 2^20 nodes and fail its own ``route_drop`` gate (the
  port drops exactly as the reference does); below 2^14 nodes the two
  values behave alike.

The workload builders (``gossip_wave``, ``praos_consensus``,
``dense_ring``, ``steady_gossip``, ``chaos_fleet``, ``bursty_gossip``,
``spec_gossip``, the packs) and the kernel timing helpers (``time_ms``,
``stage_args``, ``stage_times``) live here once; ``chip_smoke.py``
imports them.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
SPIN_CYCLES = 2_000_000       # time_ms's device-side wait, ~1 ms at 1980 MHz

#: measured-window repetitions (--reps): engines, gates and warm runs are
#: paid once per config; only the measured window repeats
_REPS = 1
#: min/max rates of the last _measure (filled when _REPS > 1)
_SPREAD = {}
#: set by --smoke: wall-clock gates report instead of asserting there
_SMOKE = False
#: BENCH_*.json line schema version (bench.py's)
BENCH_SCHEMA = 2
_GIT_SHA = None
#: (RunLedger, batch_id) under --ledger DIR
_LEDGER = None
#: launches of the kernels made by this script's kernel-against-plain
#: comparisons and stage timings (not by the configs' runs)
CHECK_LAUNCHES = {"fire_compact": 0, "mailbox_insert": 0}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it (``700.00 W``)."""
    return nvidia_smi().rsplit(",", 1)[1].strip()


def _git_sha():
    global _GIT_SHA
    if _GIT_SHA is None:
        from timewarp_tpu_torch.obs.ledger import resolve_git_sha
        _GIT_SHA = resolve_git_sha(os.path.dirname(os.path.abspath(__file__)))
    return _GIT_SHA


def _platform(device) -> str:
    return torch.device(device).type


def _config_key(cfg, n, steps, device):
    """The cross-run join key: config name, the requested shape (dflt =
    the config's default) and the platform."""
    return f"{cfg}|n{n or 'dflt'}|s{steps or 'dflt'}|{_platform(device)}"


def _env_fields(device):
    """Where the line ran: the platform, the card's name and power limit
    (null on the CPU), torch and the commit."""
    cuda = _platform(device) == "cuda"
    return {"schema": BENCH_SCHEMA,
            "platform": _platform(device),
            "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "torch_version": torch.__version__,
            "power_limit": power_limit() if cuda else None,
            "git_sha": _git_sha()}


def _emit(line):
    """Print one line and, under --ledger, append it to the run ledger."""
    print(json.dumps(line), flush=True)
    if _LEDGER is not None:
        _LEDGER[0].add_bench_line(line, batch=_LEDGER[1],
                                  source="bench_cuda.py")


def _sync(device) -> None:
    if _platform(device) == "cuda":
        torch.cuda.synchronize()


def _total(st) -> int:
    """Delivered messages over every world; the readback waits for the
    device."""
    return int(st.delivered.sum())


def _measure(engine, steps, warm_steps=2):
    st = engine.init_state()
    warm = engine.run_quiet(warm_steps, st)
    base = _total(warm)
    dts = []
    for _ in range(_REPS):
        _sync(engine.device)
        t0 = time.perf_counter()
        fin = engine.run_quiet(steps, warm)
        delivered = _total(fin) - base
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts)
    _SPREAD.clear()
    if len(dts) > 1:
        _SPREAD.update(min=delivered / max(dts), max=delivered / min(dts))
    return delivered, dt, fin


def _timed_wall(device, fn):
    """``(fn(), wall seconds)``, the device idle at the start and drained
    at the end."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _interleaved(device, runs, rounds):
    """Each of ``runs`` (name -> fn)'s median wall over ``rounds`` rounds,
    and its last result. A round runs every fn once, in turn: the shared
    host's drift from one stretch to the next then falls on every fn
    alike, where timing one fn's reps back to back and then the next's
    (``bench.py``'s order) charges it to whichever ran in a slow
    stretch."""
    walls = {k: [] for k in runs}
    out = {}
    for _ in range(rounds):
        for k, fn in runs.items():
            out[k], wall = _timed_wall(device, fn)
            walls[k].append(wall)
    return {k: statistics.median(w) for k, w in walls.items()}, out


# -- equality of states ----------------------------------------------------

def host_state(st, sc=None):
    """Every leaf of an ``EngineState`` or ``EdgeState`` (any device) as
    numpy, ``states`` a dict."""
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeState
    from timewarp_tpu_torch.interp.torch_engine.state_io import (
        edge_state_to_numpy, state_to_numpy)
    to_numpy = edge_state_to_numpy if isinstance(st, EdgeState) \
        else state_to_numpy
    return to_numpy(st, sc)


def assert_states_equal(a, b, what, sc=None) -> None:
    """Every leaf of two states equal, bit for bit."""
    ha, hb = host_state(a, sc), host_state(b, sc)
    for name in ha:
        x, y = ha[name], hb[name]
        same = x.keys() == y.keys() and all(
            np.array_equal(x[k], y[k]) for k in x) \
            if name == "states" else np.array_equal(x, y)
        if not same:
            raise AssertionError(f"{what}: state.{name} differs")


# -- the workloads (bench.py's builders) -----------------------------------

def dense_ring(n, **kw):
    """bench.py _dense_ring: every node holds a token, think 0, 500 µs
    links, no deadline within reach; ``kw`` overrides."""
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.net.delays import FixedDelay
    args = dict(n_tokens=n, think_us=0, bootstrap_us=1_000, end_us=1 << 50,
                with_observer=False, mailbox_cap=4)
    args.update(kw)
    return token_ring(n, **args), FixedDelay(500)


def gossip_wave(n):
    """bench.py _gossip_wave: burst relays, 8 ms propagation floor."""
    from timewarp_tpu_torch.models.gossip import gossip, gossip_links
    from timewarp_tpu_torch.net.delays import Quantize
    sc = gossip(n, fanout=8, think_us=2_000, burst=True, end_us=5_000_000,
                mailbox_cap=16)
    return sc, Quantize(gossip_links(median_us=20_000, sigma=0.6,
                                     floor_us=8_000), 1_000)


def praos_link():
    """The Praos bench's link: quantized lognormal, 8 ms floor."""
    from timewarp_tpu_torch.net.delays import LogNormalDelay, Quantize
    return Quantize(LogNormalDelay(20_000, 0.6, cap_us=150_000,
                                   floor_us=8_000), 1_000)


def praos_consensus(n):
    """bench.py _praos_consensus: burst diffusion, 8 ms propagation
    floor, slots of 1 s, about four leaders a slot."""
    from timewarp_tpu_torch.models.praos import praos
    sc = praos(n, slot_us=1_000_000, n_slots=1 << 30, leader_prob=4.0 / n,
               fanout=8, burst=True, mailbox_cap=16)
    return sc, praos_link()


def steady_gossip(n):
    """bench.py gossip_steady_1m: rumor mongering, every infected node
    relays to one peer per 1 ms round; window 1 (the eager path)."""
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import Quantize, UniformDelay
    sc = gossip(n, fanout=1, think_us=1_000, gossip_interval=1_000,
                end_us=1 << 50, steady=True, mailbox_cap=8)
    return sc, Quantize(UniformDelay(500, 4_500), 1_000)


def chaos_fleet(n=100_000, B=8):
    """bench.py bench_gossip_100k_chaos: steady gossip, 8 worlds, 8
    distinct fault schedules (a reset crash, a crash, a partition and a
    degradation window per world), built as the bench builds them.
    Returns ``(scenario, link, spec, fleet, heal_us)``."""
    from timewarp_tpu_torch.faults import (FaultFleet, FaultSchedule,
                                           LinkWindow, NodeCrash, Partition)
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import Quantize, UniformDelay
    sc = gossip(n, fanout=1, think_us=1_000, gossip_interval=1_000,
                end_us=300_000, steady=True, mailbox_cap=8)
    link = Quantize(UniformDelay(500, 4_500), 1_000)
    half = n // 2
    heal_us = 0
    scheds = []
    for b in range(B):
        part_end = 70_000 + 2_000 * b
        crash_up = 60_000 + 5_000 * b
        # the last fault to clear in this world: the second crash window
        # runs to crash_up + 10 ms
        heal_us = max(heal_us, part_end, crash_up + 10_000)
        scheds.append(FaultSchedule((
            NodeCrash((7 * b + 3) % n, 20_000, crash_up, reset_state=True),
            NodeCrash((11 * b + half + 5) % n, 30_000, crash_up + 10_000),
            Partition((tuple(range(half)), tuple(range(half, n))),
                      25_000, part_end),
            LinkWindow(None, None, 80_000, 120_000, scale=2.0 + 0.25 * b),
        )))
    return sc, link, BatchSpec(seeds=tuple(range(B))), \
        FaultFleet(tuple(scheds)), heal_us


def bursty_gossip(n):
    """bench.py _bursty_gossip: burst waves with a 40 ms incubation, an
    8 ms-floor link, and a degradation window undercutting it to 2 ms."""
    from timewarp_tpu_torch.faults import FaultSchedule, LinkWindow
    from timewarp_tpu_torch.models.gossip import gossip, gossip_links
    from timewarp_tpu_torch.net.delays import Quantize
    sc = gossip(n, fanout=8, think_us=40_000, burst=True, end_us=5_000_000,
                mailbox_cap=16)
    link = Quantize(gossip_links(median_us=20_000, sigma=0.6,
                                 floor_us=8_000), 1_000)
    return sc, link, FaultSchedule((LinkWindow(None, None, 100_000, 200_000,
                                               scale=0.25),))


def spec_gossip(n, cap_us=60_000_000):
    """bench.py gossip_100k_spec: burst gossip over a long-tail link —
    Pareto delays from 4 ms (capped at ``cap_us``, the link's default),
    declared floor the 500 µs quantize grid."""
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import ParetoDelay, Quantize
    sc = gossip(n, fanout=8, think_us=40_000, burst=True, end_us=5_000_000,
                mailbox_cap=16)
    return sc, Quantize(ParetoDelay(4_000, 1.2, cap_us=cap_us), 500)


def _ring_params(n):
    """The sweeps' token-ring worlds: a token per 64 nodes, no deadline."""
    return {"nodes": n, "n_tokens": max(4, n // 64), "think_us": 2000,
            "end_us": 1 << 40, "mailbox_cap": 8}


def _gossip_params(n):
    """The sweeps' and the service's burst gossips: fanout 4, 400 ms."""
    return {"nodes": n, "fanout": 4, "burst": True, "end_us": 400_000,
            "mailbox_cap": 16, "think_us": 700}


def hetero_pack(n=4096, steps=2000):
    """``bench.py`` ``bench_sweep_hetero``'s pack (three token-ring worlds,
    one faulted and one at the largest pow2 budget <= steps / 2; two
    windowed burst-gossip worlds) and its chunk."""
    from timewarp_tpu_torch.sweep import SweepPack
    # a pow2 half budget and chunk drain on exact rungs, so the packing
    # gate measures packing, not the rung residue of an odd budget
    half = max(8, 1 << (max(1, steps // 2).bit_length() - 1))
    ring = _ring_params(n)
    gossip = _gossip_params(n)
    pack = SweepPack.from_json([
        {"id": "ring-s0", "scenario": "token-ring", "params": ring,
         "link": "uniform:1000:5000", "seed": 0, "budget": steps},
        {"id": "ring-s1", "scenario": "token-ring", "params": ring,
         "link": "uniform:2000:7000", "seed": 1, "budget": half},
        {"id": "ring-chaos", "scenario": "token-ring", "params": ring,
         "link": "uniform:1000:5000", "seed": 2, "budget": steps,
         "faults": "crash:3:5ms:40ms:reset; partition:0-1|2-3:10ms:30ms"},
        {"id": "gos-s0", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:3000:9000", "seed": 3,
         "window": "auto", "budget": steps},
        {"id": "gos-s1", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:4000:8000", "seed": 4,
         "window": "auto", "budget": steps},
    ])
    return pack, max(64, 1 << (max(1, steps // 8).bit_length() - 1))


def hetero_auto_pack(n=4096, steps=2000):
    """``bench.py`` ``bench_sweep_hetero_auto``'s pack: a token ring and
    three windowed gossips under ``controller: auto``."""
    from timewarp_tpu_torch.sweep import SweepPack
    ring = _ring_params(n)
    gossip = _gossip_params(n)
    return SweepPack.from_json([
        {"id": "ring-s0", "scenario": "token-ring", "params": ring,
         "link": "uniform:1000:5000", "seed": 0, "budget": steps},
        {"id": "gos-a0", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:3000:9000", "seed": 3,
         "window": "auto", "budget": steps, "controller": "auto"},
        {"id": "gos-a1", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:3000:9000", "seed": 4,
         "window": "auto", "budget": max(steps // 2, 8),
         "controller": "auto"},
        {"id": "gos-a2", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:4000:8000", "seed": 5,
         "window": "auto", "budget": steps, "controller": "auto"},
    ])


def search_base(n=64, steps=300):
    """``bench.py`` ``bench_search_gossip``'s base config: burst gossip,
    fanout 2, ``end_us`` 120 000, ``uniform:1000:5000``, ``window="auto"``."""
    from timewarp_tpu_torch.sweep.spec import RunConfig
    params = {"nodes": n, "fanout": 2, "end_us": 120_000, "burst": True,
              "think_us": 5000, "mailbox_cap": 16}
    return RunConfig(run_id="search-base", family="gossip",
                     params=tuple(sorted(params.items())),
                     link="uniform:1000:5000", seed=0, window="auto",
                     budget=steps)


def serve_gossip_configs(n=4096, steps=2000):
    """``bench.py`` ``bench_serve_gossip``'s eight configs: burst gossip,
    fanout 4, ``end_us`` 400 ms, ``mailbox_cap`` 16, ``think_us`` 700,
    ``quantize:1000:uniform:3000:9000``, seeds 0-7, budgets ``steps``
    (even worlds) and ``steps // 2``, ``w3`` crashing node 1 from 5 to
    40 ms with a reset."""
    gossip = _gossip_params(n)
    cfgs = []
    for i in range(8):
        d = {"id": f"w{i}", "scenario": "gossip", "params": gossip,
             "link": "quantize:1000:uniform:3000:9000", "seed": i,
             "budget": steps if i % 2 == 0 else max(steps // 2, 8)}
        if i == 3:
            d["faults"] = "crash:1:5ms:40ms:reset"
        cfgs.append(d)
    return cfgs


# -- kernel timing (K1, K2 on a stage's own arguments) ---------------------

def time_ms(fn, reps=20, queued=True):
    """Mean ms of ``fn`` on the card: CUDA events around each call. Before
    every call a 1 GiB write flushes the 50 MB L2, then the device waits
    ``SPIN_CYCLES`` clocks (``torch.cuda._sleep``) before the start event,
    so that the host has queued all of the call's launches by the time
    the start event fires and the events time the device, not the host.
    With ``queued`` (a kernel's wrapper, which never waits on the
    device) that is checked: a call whose start event had already fired
    when its end event was queued is timed again with a wait twice as
    long, and after six such tries the timing fails. The plain versions
    pass ``queued=False``: some read a result back to the host, so their
    times include host time."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total, spin = 0.0, SPIN_CYCLES
    for _ in range(reps):
        for _ in range(6):
            flush.zero_()
            torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            late = queued and a.query()
            b.synchronize()
            if not late:
                break
            spin *= 2
        else:
            raise RuntimeError("timing: the host did not queue the call "
                               f"within {spin // 2} device clocks")
        total += a.elapsed_time(b)
    return total / reps


def _host_ms(fn, reps=20):
    """Median ms of ``fn`` on the host's clock (CPU tensors)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def k1_bytes(args):
    """K1's bytes on its arguments (``mailbox_insert``'s): the planes
    written once and read once, except the old words of each row the
    batch fills (commutative: all but its rel, by which the hole is
    found; ordered: all), start/cnt (and counts), and the deliver time,
    sender and payload of each entry that finds a row (the others are not
    read)."""
    _, cnt, counts, _, src, _, mb_rel, mb_src, mb_payload = args
    K, n = mb_rel.shape
    P = mb_payload.shape[1]
    ordered, with_src = counts is not None, src is not None
    if ordered:
        room = K - counts
    else:
        room = (mb_rel == 2**31 - 1).sum(dim=0, dtype=torch.int32)
    gathered = int(torch.minimum(cnt, room).sum())
    planes = mb_rel.numel() + mb_payload.numel() \
        + (mb_src.numel() if with_src else 0)
    row = (1 + with_src + P) * 4         # bytes of a mailbox row or entry
    unread = gathered * (row - 4 * (not ordered))   # filled rows' old words
    return 2 * planes * 4 - unread + (2 + ordered) * n * 4 + gathered * row


def fleet_k1_bytes(args):
    """K1's bound bytes over a fleet: :func:`k1_bytes` per world, summed."""
    return sum(k1_bytes(tuple(None if x is None else x[b] for x in args))
               for b in range(args[6].shape[0]))


def fleet_k2_bytes(pdst, woff, pay, S):
    """K2's bound bytes over a fleet: per world the dst planes and the woff
    plane read, the fired lanes' payload read, the batch written; summed."""
    B, M, n = pdst.shape
    P = pay.shape[2]
    fired = int((pdst >= 0).sum())
    return (pdst.numel() + (0 if woff is None else woff.numel())) * 4 \
        + fired * P * 4 + B * (3 + P) * S * 4


def stage_args(eng, drive):
    """K2's and K1's arguments (``fire_compact``'s and
    ``mailbox_insert``'s, every world at once) of the busiest superstep
    ``drive()`` runs on ``eng`` (the most messages K1 inserts, the first
    of equals), taken where the engine's stage receives them."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    taken = {"valid": -1}
    compact, insert = eng.stage.compact, eng.stage.insert

    def take_compact(pdst, woff_n, payload):
        taken["pending"] = (pdst, woff_n if eng.stage.W > 1 else None,
                            payload, eng.stage.S)
        return compact(pdst, woff_n, payload)

    def take_insert(sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload,
                    counts):
        start, cnt = ci.bucket_bounds(sd, eng.stage.n)
        valid = int(cnt.sum())
        if valid > taken["valid"]:
            taken.update(valid=valid, k2=taken["pending"], k1=(
                start, cnt, counts, drel_s,
                src_s if eng.stage.inbox_src else None, pay_s, mb_rel,
                mb_src, mb_payload))
        return insert(sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload,
                      counts)
    eng.stage.compact, eng.stage.insert = take_compact, take_insert
    try:
        drive()
    finally:
        del eng.stage.compact, eng.stage.insert
    return taken["k2"], taken["k1"]


def stage_times(a2, a1):
    """K2's and K1's times on captured stage arguments (:func:`stage_args`),
    their plain versions' times and their byte bounds (per world, summed
    over the worlds): ``(r2, r1)``, each a dict of ``ms``, ``plain_ms``,
    ``bound_ms`` and ``bytes``. On the card the kernels are timed by
    :func:`time_ms`; on the CPU both legs are the plain versions, timed
    on the host's clock."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    cuda = a2[0].is_cuda
    b2 = fleet_k2_bytes(*a2)
    b1 = fleet_k1_bytes(a1)

    def ms(fn, queued=True):
        return time_ms(fn, queued=queued) if cuda else _host_ms(fn)
    r2 = dict(ms=ms(lambda: ci.fire_compact(*a2)),
              plain_ms=ms(lambda: ci.fire_compact_plain(*a2), queued=False),
              bound_ms=b2 / HBM_BYTES_PER_S * 1e3, bytes=b2)
    r1 = dict(ms=ms(lambda: ci.mailbox_insert(*a1)),
              plain_ms=ms(lambda: ci.mailbox_insert_plain(*a1),
                          queued=False),
              bound_ms=b1 / HBM_BYTES_PER_S * 1e3, bytes=b1)
    return r2, r1


def _counted_checks(fn):
    """``fn()``, its kernel launches moved into :data:`CHECK_LAUNCHES`
    (the comparisons' and timings' launches, apart from the runs')."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    before = {k: ci.LAUNCHES[k] for k in CHECK_LAUNCHES}
    out = fn()
    for k in CHECK_LAUNCHES:
        CHECK_LAUNCHES[k] += ci.LAUNCHES[k] - before[k]
    return out


def _kernels_equal(what, got, want) -> None:
    """A kernel's outputs equal its plain version's, bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, plain "
                             f"version {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}[{i}]: kernel != plain version")


def _insert_stage_stats(engine, gate_steps=12):
    """The ``_insert`` configs' gate and stage figures: K2's and K1's
    arguments at the busiest of the first ``gate_steps`` supersteps,
    each kernel bit-equal to its plain version there, their times, their
    plain versions' times, and the achieved-bytes fraction of
    ``TW_HBM_GBPS`` (default the H100's 3350 GB/s)."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    a2, a1 = stage_args(engine, lambda: engine.run_quiet(gate_steps))

    def checks():
        _kernels_equal("in-bench insert gate: fire_compact",
                       ci.fire_compact(*a2), ci.fire_compact_plain(*a2))
        _kernels_equal("in-bench insert gate: mailbox_insert",
                       ci.mailbox_insert(*a1), ci.mailbox_insert_plain(*a1))
        return stage_times(a2, a1)
    r2, r1 = _counted_checks(checks)
    ms = r2["ms"] + r1["ms"]
    nbytes = r2["bytes"] + r1["bytes"]
    gbps = float(os.environ.get("TW_HBM_GBPS", "3350"))
    return {
        "insert_stage_ms": ms,
        "insert_stage_plain_ms": r2["plain_ms"] + r1["plain_ms"],
        "fire_compact_ms": r2["ms"], "mailbox_insert_ms": r1["ms"],
        "fire_compact_plain_ms": r2["plain_ms"],
        "mailbox_insert_plain_ms": r1["plain_ms"],
        "insert_stage_entries": int(a1[1].sum()),
        "insert_bytes_per_step": nbytes,
        "insert_hbm_frac": nbytes / (ms * 1e-3) / (gbps * 1e9),
        "hbm_gbps_assumed": gbps,
        "insert_resolved": "kernels" if a2[0].is_cuda else "plain",
    }


# -- in-bench gates ----------------------------------------------------------

def _assert_wave_done(engine, fin, n):
    """Genuine quiescence: no events pending in any world, the
    parity-regime counters 0, and the epidemic covered every world up to
    the push-only miss floor (a node is missed with prob ~e^-8)."""
    from timewarp_tpu_torch.core.scenario import NEVER
    assert int(engine._next_event(fin).min()) >= NEVER, \
        "broadcast did not quiesce inside the step budget"
    assert int(fin.short_delay.sum()) == 0, \
        "windowed run left the exact regime"
    assert int(fin.route_drop.sum()) == 0, "routing dropped messages"
    hops = fin.states["hop"].cpu().numpy()
    for b, h in enumerate(hops.reshape(-1, hops.shape[-1])):
        missed = int((h < 0).sum())
        assert missed <= max(n // 500, 8), \
            f"wave truncated: {missed} nodes never infected (world {b})"


def _assert_batched_exact(batched, solo_factory, gate_steps=12):
    """The batch exactness law: the first and last world of a
    ``gate_steps`` batched run equal their solo runs, bit for bit."""
    from timewarp_tpu_torch.interp.torch_engine.batched import world_slice
    bs = batched.run_quiet(gate_steps)
    for b in (0, batched.batch.B - 1):
        ss = solo_factory(b).run_quiet(gate_steps)
        assert_states_equal(ss, world_slice(bs, b),
                            f"in-bench batch exactness gate, world {b}",
                            batched.scenario)


def _assert_engines_exact(eng, ref, tag, gate_steps=12):
    """``ref`` reproduces ``eng``'s state bit for bit over the gate
    horizon."""
    es = eng.run_quiet(gate_steps)
    rs = ref.run_quiet(gate_steps)
    assert_states_equal(rs, es, tag, eng.scenario)


def _strict(device) -> bool:
    """Wall-clock gates bind on the card at non-smoke shapes only."""
    return _platform(device) == "cuda" and not _SMOKE


def _telemetry_gate(make_engine, device, steps=24):
    """``telemetry="counters"`` bit-identical to ``"off"`` on the traced
    driver (states and trace rows), at most 5% slower on the card at
    non-smoke shapes (2x elsewhere): the medians of 15 runs each there,
    3 elsewhere, in turns (:func:`_interleaved`; ``bench.py`` takes 3 of
    each, back to back). Returns the overhead fraction."""
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    off, on = make_engine("off"), make_engine("counters")
    f_off, tr_off = off.run(steps)
    f_on, tr_on = on.run(steps)
    assert_traces_equal(tr_off, tr_on, "telemetry-off", "telemetry-counters")
    assert_states_equal(f_off, f_on, "telemetry exactness gate",
                        off.scenario)

    strict = _strict(device)
    med, _ = _interleaved(device, {
        "off": lambda: off.run(steps, state=f_off),
        "on": lambda: on.run(steps, state=f_on)}, 15 if strict else 3)
    overhead = med["on"] / med["off"] - 1.0
    limit = 0.05 if strict else 1.0
    assert overhead <= limit, (
        f"telemetry='counters' costs {overhead:.1%} on the traced driver "
        f"— over the {limit:.0%} budget")
    return overhead


def _verify_detection_gate(make_engine, budget=64, chunk=8):
    """One seeded flip between chunks of a digest-mode run is detected
    (>= 1 rollback) and the recovered run equals a clean one: states,
    traces, digest chain."""
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    clean = make_engine("digest")
    fc, tc = clean.run_verified(budget, chunk=chunk)
    injected = make_engine("digest")
    inj = FlipInjector("flip:7:2")
    fi, ti = injected.run_verified(budget, chunk=chunk, inject=inj)
    assert inj.fired, "flip never fired (fewer than 2 chunks ran)"
    assert injected.last_run_integrity["rollbacks"] >= 1, \
        "injected flip went UNDETECTED (the detection law is broken)"
    assert_traces_equal(tc, ti, "clean", "recovered")
    assert_states_equal(fc, fi, "in-bench detection-law gate",
                        clean.scenario)
    assert clean.last_run_stats["digest_chain"] \
        == injected.last_run_stats["digest_chain"], \
        "recovered digest chain diverged from the clean run's"


# -- the configs -----------------------------------------------------------

def bench_token_ring_dense(n, steps, device):
    """The dense ring on ``FusedRingEngine`` (K4, one launch a
    superstep), gated by 12 supersteps of ``EdgeEngine`` reproducing the
    fused state bit for bit."""
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    n = n or 1 << 20
    sc, link = dense_ring(n)
    engine = FusedRingEngine(sc, link, cap=2, device=device)
    ref = EdgeEngine(sc, link, cap=2, device=device)
    rs = host_state(ref.run_quiet(12), sc)
    es = host_state(engine.to_edge_state(engine.run_quiet(12)), sc)
    for f in ("wake", "q_rel", "q_pay", "delivered", "overflow", "steps",
              "time"):
        assert np.array_equal(rs[f], es[f]), \
            f"fused engine diverged from EdgeEngine on {f}"
    for leaf in ("cnt", "val", "send_at"):
        assert np.array_equal(rs["states"][leaf], es["states"][leaf]), \
            f"fused engine diverged from EdgeEngine on state.{leaf}"
    delivered, dt, fin = _measure(engine, steps or 8192)
    assert int(fin.overflow) == 0, "measured run left the parity regime"
    return (f"token-ring dense (fused K4 superstep) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt)


def bench_token_ring_dense_xla(n, steps, device):
    """The same dense ring on ``EdgeEngine`` (torch ops, no kernel): the
    reference's pre-fusion baseline."""
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    n = n or 1 << 20
    sc, link = dense_ring(n)
    engine = EdgeEngine(sc, link, cap=2, device=device)
    delivered, dt, fin = _measure(engine, steps or 2048)
    for counter in ("overflow", "misrouted", "unrouted", "bad_delay"):
        v = int(getattr(fin, counter))
        assert v == 0, f"measured run left the parity regime: {counter}={v}"
    return (f"token-ring dense (edge engine) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt)


def bench_token_ring_observer(n, steps, device):
    """The reference example's shape: every hop also notifies an observer
    hub (dynamic destinations), on the general engine."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.net.delays import FixedDelay
    n = n or (1 << 16)  # ring nodes; +1 observer
    sc = token_ring(n, n_tokens=n, think_us=1_000, bootstrap_us=1_000,
                    end_us=(1 << 50), with_observer=True, mailbox_cap=8)
    engine = TorchEngine(sc, FixedDelay(500), device=device)
    delivered, dt, _ = _measure(engine, steps or 512)
    return (f"token-ring observer (general engine) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt)


def bench_gossip_100k(n, steps, device):
    """One full broadcast wave, start to quiescence, on the general
    engine with ``window="auto"`` and adaptive routing (K2, K1)."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 100_000
    sc, link = gossip_wave(n)
    engine = TorchEngine(sc, link, window="auto", device=device)
    delivered, dt, fin = _measure(engine, steps or (1 << 20))
    _assert_wave_done(engine, fin, n)
    return (f"gossip broadcast wave to quiescence (lognormal links) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt)


def bench_gossip_100k_fused(n, steps, device):
    """The same wave on ``FusedSparseEngine`` (K3), gated by bit-exact
    state equality against the general engine and by the telemetry
    exactness and overhead gate."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    n = n or 100_000
    sc, link = gossip_wave(n)
    # a wave peak beyond max_batch lands in route_drop and fails
    # _assert_wave_done loudly
    engine = FusedSparseEngine(sc, link, window="auto", max_batch=1 << 18,
                               device=device)
    _assert_engines_exact(engine, TorchEngine(sc, link, window="auto",
                                              device=device),
                          "in-bench fused-sparse gate")
    overhead = _telemetry_gate(lambda mode: FusedSparseEngine(
        sc, link, window="auto", max_batch=1 << 18, telemetry=mode,
        lint="off", device=device), device)
    delivered, dt, fin = _measure(engine, steps or (1 << 20))
    _assert_wave_done(engine, fin, n)
    return (f"gossip broadcast wave to quiescence (fused-sparse K3) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt,
            {"telemetry_overhead_frac": round(overhead, 4)})


def bench_gossip_100k_insert(n, steps, device):
    """The gossip wave on the general engine's insertion stage (K2
    fire-compaction, K1 insertion) at 2^17 nodes, with the stage's
    kernel-against-plain gate and figures (module docstring)."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or (1 << 17)
    sc, link = gossip_wave(n)
    cap = min(1 << 18, n * sc.max_out)
    engine = TorchEngine(sc, link, window="auto", insert_cap=cap,
                         device=device)
    extra = _insert_stage_stats(engine)
    delivered, dt, fin = _measure(engine, steps or (1 << 20))
    _assert_wave_done(engine, fin, n)
    return (f"gossip broadcast wave to quiescence (K2 + K1 insert) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt,
            extra)


def bench_praos_1m_insert(n, steps, device):
    """Praos on the general engine's insertion stage; the gate and stage
    figures of ``gossip_100k_insert``."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 1 << 20
    sc, link = praos_consensus(n)
    # bench.py's min(1 << 17, n * max_out) drops messages at 2^20 nodes
    # (a diffusion superstep fires far more than 2^17), failing its own
    # route_drop gate; n * max_out is that value wherever it suffices and
    # never drops
    cap = n * sc.max_out
    engine = TorchEngine(sc, link, window="auto", insert_cap=cap,
                         device=device)
    extra = _insert_stage_stats(engine)
    delivered, dt, fin = _measure(engine, steps or 256, warm_steps=16)
    assert int(fin.short_delay) == 0, "windowed run left the exact regime"
    assert int(fin.route_drop) == 0, \
        "fire-compacted batch cap dropped messages — raise insert_cap"
    return (f"praos slot-leader consensus (K2 + K1 insert) "
            f"delivered-messages/sec/chip @{n} stake nodes",
            delivered / dt, extra)


def bench_gossip_100k_b8(n, steps, device):
    """The gossip wave as a fleet of 8 seed-swept worlds through one
    batched engine (one K2 and one K1 launch for every world), gated by
    the batch exactness law."""
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 100_000
    B = 8
    sc, link = gossip_wave(n)
    spec = BatchSpec(seeds=tuple(range(B)))
    engine = TorchEngine(sc, link, window="auto", batch=spec, device=device)
    # the solo twins take the fleet's resolved window
    _assert_batched_exact(engine, lambda b: TorchEngine(
        sc, spec.world_link(link, b), seed=spec.seeds[b],
        window=engine.window, device=device))
    delivered, dt, fin = _measure(engine, steps or (1 << 20))
    _assert_wave_done(engine, fin, n)
    return (f"gossip broadcast wave fleet (batched x{B}) aggregate "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt,
            {"engine_builds": 1, "compiles": 0})


def bench_gossip_100k_chaos(n, steps, device):
    """Monte-Carlo chaos study: 8 steady-gossip worlds under 8 distinct
    fault schedules in one batched engine. Gated by the chaos-fleet
    exactness law and the robustness properties (deliveries continue
    after every world's faults clear; every world converges); per-world
    ``route_drop`` and ``fault_dropped`` ride the line."""
    from timewarp_tpu_torch.core.scenario import NEVER
    from timewarp_tpu_torch.faults import eventually_delivered
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 100_000
    B = 8
    sc, link, spec, fleet, heal_us = chaos_fleet(n, B)
    engine = TorchEngine(sc, link, window="auto", batch=spec, faults=fleet,
                         device=device)
    _assert_batched_exact(engine, lambda b: TorchEngine(
        sc, link, seed=spec.seeds[b], window=engine.window,
        faults=fleet.world_schedule(b), device=device))
    _, traces = engine.run(192)
    for b, tr in enumerate(traces):
        assert eventually_delivered(tr, heal_us), \
            f"world {b}: no deliveries after its faults healed"
    delivered, dt, fin = _measure(engine, steps or (1 << 20))
    assert int(engine._next_event(fin).min()) >= NEVER, \
        "chaos fleet did not quiesce inside the step budget"
    assert int(fin.short_delay.sum()) == 0, \
        "windowed run left the exact regime"
    route_drop = fin.route_drop.cpu().numpy()
    fault_dropped = fin.fault_dropped.cpu().numpy()
    assert int(route_drop.sum()) == 0, "routing dropped messages"
    hops = fin.states["hop"].cpu().numpy()
    for b in range(B):
        assert int(fault_dropped[b]) > 0, \
            f"world {b}: chaos schedule never bit (fault_dropped=0)"
        missed = int((hops[b] < 0).sum())
        assert missed <= max(n // 500, 8), \
            f"world {b} did not converge: {missed} nodes uninfected"
    return (f"gossip steady-state chaos fleet (batched x{B}, per-world "
            f"fault schedules) aggregate delivered-messages/sec/chip "
            f"@{n} nodes", delivered / dt,
            {"route_drop": route_drop.tolist(),
             "fault_dropped": fault_dropped.tolist()})


def bench_sweep_hetero(n, steps, device):
    """The sweep service on a heterogeneous pack with one injected
    transient failure, run twice (``first-fit``, then ``predicted``),
    gated by the survival law on both legs and by the packing gate (the
    predicted leg strictly wins budget efficiency, no worse pad waste,
    equal engine builds, one ``pack_decision`` a bucket)."""
    import shutil
    import tempfile

    from timewarp_tpu_torch.sweep import SweepService, solo_result
    from timewarp_tpu_torch.sweep.journal import SweepJournal, util_rollup
    n = n or 4096
    steps = steps or 2000
    pack, chunk = hetero_pack(n, steps)

    def leg(pack_mode):
        d = tempfile.mkdtemp(prefix="tw_sweep_bench_")
        try:
            t0 = time.perf_counter()
            # max_bucket=2: the three token-ring worlds cannot share one
            # bucket, so the packing decision is real at this pack's scale
            svc = SweepService(pack, d, chunk=chunk, lint="off",
                               inject="fail:2", max_bucket=2,
                               pack_mode=pack_mode, device=device)
            report = svc.run()
            dt = time.perf_counter() - t0
            assert report.ok, f"sweep failed: {report.to_json()}"
            assert report.retries >= 1, \
                "the injected transient failure never exercised the " \
                "retry path"
            for rid, res in report.done.items():
                want = solo_result(pack.by_id(rid), lint="off",
                                   device=device)
                assert want == res, (
                    f"sweep survival law violated for {rid} "
                    f"({pack_mode}):\n  solo:     {want}\n"
                    f"  streamed: {res}")
            scan = SweepJournal(d).scan()
            roll = util_rollup(scan.util)
            builds = sum(int(u.get("engine_builds", 0))
                         for u in scan.util.values())
            return {"report": report, "dt": dt, "roll": roll,
                    "builds": builds,
                    "decisions": len(scan.pack_decisions),
                    "delivered": sum(r["delivered"]
                                     for r in report.done.values())}
        finally:
            shutil.rmtree(d, ignore_errors=True)

    ff = leg("first-fit")
    pr = leg("predicted")
    assert pr["roll"]["budget_efficiency"] \
        > ff["roll"]["budget_efficiency"], (
            f"predicted packing did not beat first-fit: "
            f"budget_efficiency {pr['roll']} vs {ff['roll']}")
    assert pr["roll"]["pad_waste_frac"] \
        <= ff["roll"]["pad_waste_frac"] + 1e-9, (
            f"predicted packing grew pad waste: {pr['roll']} "
            f"vs {ff['roll']}")
    assert pr["builds"] == ff["builds"], (
        f"packing changed engine build count: {pr['builds']} predicted "
        f"vs {ff['builds']} first-fit")
    assert ff["decisions"] == 0, \
        "first-fit journaled pack_decision records"
    assert pr["decisions"] == pr["report"].buckets, (
        f"predicted leg journaled {pr['decisions']} pack_decision records "
        f"for {pr['report'].buckets} buckets")
    extra = {"worlds": pr["report"].total,
             "buckets": pr["report"].buckets,
             "retries": pr["report"].retries,
             "splits": pr["report"].splits,
             "budget_efficiency": pr["roll"]["budget_efficiency"],
             "pad_waste_frac": pr["roll"]["pad_waste_frac"],
             "first_fit_budget_efficiency": ff["roll"]["budget_efficiency"],
             "first_fit_pad_waste_frac": ff["roll"]["pad_waste_frac"],
             "pack_decisions": pr["decisions"]}
    return (f"heterogeneous sweep service (retry + stream + survival law + "
            f"predictive packing gate) aggregate delivered-messages/sec "
            f"@{n} nodes", pr["delivered"] / pr["dt"], extra)


def bench_gossip_100k_auto(n, steps, device):
    """The bursty gossip wave under the dispatch controller
    (``run_controlled``), gated by the replay law and by strictly fewer
    supersteps than the widest legal static window; the wall-clock gain
    over the best static config binds on the card at non-smoke shapes."""
    from timewarp_tpu_torch.dispatch import DecisionTrace, DispatchController
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.sweep.spec import DIGEST_ZERO, chain_digest
    n = n or 100_000
    steps = steps or (1 << 14)
    sc, link, faults = bursty_gossip(n)
    eng = TorchEngine(sc, link, window="auto", faults=faults,
                      telemetry="counters", lint="off", device=device,
                      controller=DispatchController(chunk=16, chunk_max=64))
    eng.run_controlled(steps)  # warm: the decision trace
    decs = eng.last_run_decisions
    (fin, tr), wall_auto = _timed_wall(device,
                                       lambda: eng.run_controlled(steps))
    delivered = _total(fin)
    rep = TorchEngine(sc, link, window="auto", faults=faults, lint="off",
                      device=device, controller=DispatchController(
                          mode="replay", replay=DecisionTrace.of(decs)))
    rfin, rtr = rep.run_controlled(steps)
    assert chain_digest(DIGEST_ZERO, tr) == chain_digest(DIGEST_ZERO, rtr), \
        "controller run's digests diverge from its decision-trace replay " \
        "(the replay law)"
    assert_states_equal(fin, rfin, "controller replay law (bench)", sc)
    _assert_wave_done(eng, fin, n)
    # the best static config: the widest legal static window and window 1,
    # each on its best driver (run_quiet)
    best_rate, best_name, static_steps = 0.0, "", None
    for name, w in (("static-auto", "auto"), ("window-1", 1)):
        st_eng = TorchEngine(sc, link, window=w, faults=faults, lint="off",
                             device=device)
        st_eng.run_quiet(steps)  # warm
        sfin, dt = _timed_wall(device, lambda: st_eng.run_quiet(steps))
        sdel = _total(sfin)
        assert sdel == delivered, \
            f"static {name} delivered {sdel} != controller {delivered}"
        if sdel / dt > best_rate:
            best_rate, best_name = sdel / dt, name
        if name == "static-auto":
            static_steps = int(sfin.steps.max())
    assert len(tr) < static_steps, \
        f"controller ran {len(tr)} supersteps vs static-auto's " \
        f"{static_steps} — the window adaptation never bit"
    gain = delivered / wall_auto / best_rate - 1.0
    if _strict(device):
        assert gain > 0, f"controller_gain_frac={gain:.4f} <= 0 vs {best_name}"
    extra = {"controller_gain_frac": round(gain, 4),
             "best_static": best_name,
             "supersteps_auto": len(tr),
             "supersteps_static": static_steps,
             "decisions": len(decs),
             "decision_windows": sorted({d.window_us for d in decs})}
    return (f"bursty gossip wave under the dispatch controller (auto "
            f"window/rung/chunk) delivered-messages/sec/chip @{n} nodes",
            delivered / wall_auto, extra)


def bench_gossip_100k_spec(n, steps, device):
    """Optimistic time-warp execution on a long-tail link: bursty gossip
    over ``quantize:500:pareto:4000:1.2`` under ``speculate="auto"``,
    gated by the speculation equivalence law and by strictly fewer
    supersteps than the conservative run; the wall-clock gain binds on
    the card at non-smoke shapes."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.speculate import assert_spec_equiv, canonical_rows
    n = n or 100_000
    steps = steps or (1 << 14)
    sc, link = spec_gossip(n)
    spec = TorchEngine(sc, link, window="auto", lint="off",
                       speculate="auto", device=device)
    spec.run_speculative(steps, chunk=64)   # warm
    (sfin, strc), wall_spec = _timed_wall(
        device, lambda: spec.run_speculative(steps, chunk=64))
    si = spec.last_run_speculation
    delivered = _total(sfin)
    _assert_wave_done(spec, sfin, n)
    cons = TorchEngine(sc, link, window="auto", lint="off", device=device)
    cfin, ctrc = cons.run(steps)
    _assert_wave_done(cons, cfin, n)
    assert int(cfin.overflow.sum()) == 0, \
        "overflow > 0: outside the windowed-exactness regime"
    assert_spec_equiv(canonical_rows(cfin, ctrc, scenario=sc),
                      canonical_rows(sfin, strc, scenario=sc),
                      "gossip_100k_spec in-bench gate")
    cons.run_quiet(steps)                   # warm the quiet driver
    _, wall_cons = _timed_wall(device, lambda: cons.run_quiet(steps))
    assert len(strc) < len(ctrc), \
        f"speculation ran {len(strc)} supersteps vs the conservative " \
        f"{len(ctrc)} — the window never widened"
    gain = 1.0 - len(strc) / len(ctrc)
    wall_gain = wall_cons / wall_spec - 1.0
    if _strict(device):
        assert wall_gain > 0, f"speculation wall gain {wall_gain:.4f} <= 0"
    chunks = int(si["chunks"])
    rb = int(si["rollbacks"])
    extra = {"speculation_gain_frac": round(gain, 4),
             "wall_gain_frac": round(wall_gain, 4),
             "rollbacks": rb,
             "rollback_rate": round(rb / max(chunks + rb, 1), 4),
             "supersteps_spec": len(strc),
             "supersteps_conservative": len(ctrc),
             "windows": si["windows"],
             "floor_us": si["floor_us"]}
    return (f"bursty gossip on a heavy-tail pareto link under optimistic "
            f"time-warp execution (speculative windows + causality "
            f"rollback) delivered-messages/sec/chip @{n} nodes",
            delivered / wall_spec, extra)


def bench_sweep_hetero_auto(n, steps, device):
    """The heterogeneous sweep with its windowed gossip worlds under
    ``controller: auto``, gated by the controller form of the survival
    law (each world = its solo run replaying the journaled decisions)."""
    import shutil
    import tempfile

    from timewarp_tpu_torch.sweep import SweepService, solo_result
    n = n or 4096
    steps = steps or 2000
    pack = hetero_auto_pack(n, steps)
    d = tempfile.mkdtemp(prefix="tw_sweep_auto_")
    try:
        t0 = time.perf_counter()
        svc = SweepService(pack, d, chunk=max(16, steps // 16), lint="off",
                           inject="fail:2", device=device)
        report = svc.run()
        dt = time.perf_counter() - t0
        assert report.ok, f"sweep failed: {report.to_json()}"
        assert report.retries >= 1, \
            "the injected transient failure never exercised the retry"
        scan = svc.journal.scan()
        n_dec = sum(len(v) for v in scan.decisions.values())
        assert n_dec > 0, "controller bucket journaled no decisions"
        for rid, res in report.done.items():
            cfg = pack.by_id(rid)
            decs = svc.decisions_for_world(rid, scan) \
                if cfg.controller == "auto" else None
            want = solo_result(cfg, lint="off", decisions=decs,
                               device=device)
            assert want == res, (
                f"controller sweep survival law violated for {rid}:\n"
                f"  solo:     {want}\n  streamed: {res}")
        delivered = sum(r["delivered"] for r in report.done.values())
        extra = {"worlds": report.total,
                 "controller_worlds": sum(
                     1 for c in pack.configs if c.controller == "auto"),
                 "decisions_journaled": n_dec,
                 "retries": report.retries}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return (f"heterogeneous sweep service with per-bucket dispatch "
            f"controller (decisions journaled + replay-verified) aggregate "
            f"delivered-messages/sec @{n} nodes", delivered / dt, extra)


def bench_search_gossip(n, steps, device):
    """A seeded chaos-search campaign on burst gossip, gated by: a
    violation found, the minimized repro re-failing on a fresh solo
    evaluation, and a fork that saved supersteps. World evaluations/sec
    through the whole campaign."""
    import shutil
    import tempfile

    from timewarp_tpu_torch.search import ChaosSearch
    from timewarp_tpu_torch.search.objectives import rejudge_repro
    n = n or 64
    steps = steps or 300
    base = search_base(n, steps)
    d = tempfile.mkdtemp(prefix="tw_search_bench_")
    try:
        t0 = time.perf_counter()
        campaign = ChaosSearch(base=base, objective="eventually-delivered",
                               population=8, generations=6, seed=2,
                               fork_k=2, journal_dir=d, device=device)
        result = campaign.run()
        dt = time.perf_counter() - t0
        assert result.found, (
            f"the seeded campaign failed to rediscover a violating "
            f"schedule: {result.to_json()}")
        assert result.fork["saving_frac"] > 0, (
            f"counterfactual forking never saved a superstep: "
            f"{result.fork}")
        rec = result.repro
        obj, violated, _ = rejudge_repro(rec, device=device)
        assert violated, (
            f"minimized repro {rec['faults']!r} does not re-fail {obj.name}")
        evals = (result.evaluations + result.fork["fork_worlds"]
                 + result.fork["confirmations"] + 1)
        extra = {"evaluations": evals,
                 "generations": len(result.generations),
                 "found": True,
                 "fork_saving_frac": result.fork["saving_frac"],
                 "forks": result.fork["forks"],
                 "minimized": result.minimized,
                 "minimized_events": rec["events"]}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return (f"adversarial chaos search (campaign + counterfactual fork + "
            f"minimize + repro re-fail gate) world evaluations/sec "
            f"@{n} nodes", evals / dt, extra)


def bench_praos_1m_b4(n, steps, device):
    """Praos as a 4-world fleet sweeping seed and link median per world,
    gated by the batch exactness law."""
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 1 << 20
    B = 4
    sc, link = praos_consensus(n)
    spec = BatchSpec(seeds=tuple(range(B)), link_params={
        "inner.median_us": [18_000, 20_000, 22_000, 24_000]})
    engine = TorchEngine(sc, link, window="auto", batch=spec, device=device)
    _assert_batched_exact(engine, lambda b: TorchEngine(
        sc, spec.world_link(link, b), seed=spec.seeds[b],
        window=engine.window, device=device))
    delivered, dt, fin = _measure(engine, steps or 256, warm_steps=16)
    assert int(fin.short_delay.sum()) == 0, \
        "windowed run left the exact regime"
    assert int(fin.route_drop.sum()) == 0, "adaptive routing dropped messages"
    return (f"praos slot-leader consensus fleet (batched x{B}, link sweep) "
            f"aggregate delivered-messages/sec/chip @{n} stake nodes",
            delivered / dt)


def bench_gossip_steady_1m(n, steps, device):
    """Rumor-mongering steady state on the eager path (K1 once a
    superstep), measured after the infection ramp-up."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 1 << 20
    sc, link = steady_gossip(n)
    engine = TorchEngine(sc, link, device=device)
    delivered, dt, _ = _measure(engine, steps or 256, warm_steps=64)
    return (f"gossip steady-state (rumor mongering) "
            f"delivered-messages/sec/chip @{n} nodes", delivered / dt)


def bench_praos_1m(n, steps, device):
    """Praos at 2^20 stake nodes on the general engine, ``window="auto"``
    and adaptive routing."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 1 << 20
    sc, link = praos_consensus(n)
    engine = TorchEngine(sc, link, window="auto", device=device)
    delivered, dt, fin = _measure(engine, steps or 256, warm_steps=16)
    assert int(fin.short_delay) == 0, "windowed run left the exact regime"
    assert int(fin.route_drop) == 0, "adaptive routing dropped messages"
    return (f"praos slot-leader consensus "
            f"delivered-messages/sec/chip @{n} stake nodes", delivered / dt)


def bench_praos_1m_fused(n, steps, device):
    """Praos on ``FusedSparseEngine`` (K3), gated by bit-exact state
    equality against the general engine."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    n = n or 1 << 20
    sc, link = praos_consensus(n)
    # bench.py's max_batch 1 << 17 drops messages at 2^20 nodes, failing
    # its own route_drop gate; n * max_out never drops, and below 2^14
    # nodes both give every node a lane
    engine = FusedSparseEngine(sc, link, window="auto",
                               max_batch=n * sc.max_out, device=device)
    _assert_engines_exact(engine, TorchEngine(sc, link, window="auto",
                                              device=device),
                          "in-bench fused-sparse gate")
    delivered, dt, fin = _measure(engine, steps or 256, warm_steps=16)
    assert int(fin.short_delay) == 0, "windowed run left the exact regime"
    assert int(fin.route_drop) == 0, \
        "fused batch cap dropped messages — raise max_batch"
    return (f"praos slot-leader consensus (fused-sparse K3) "
            f"delivered-messages/sec/chip @{n} stake nodes", delivered / dt)


def bench_gossip_100k_verify(n, steps, device):
    """The gossip wave through the verified chunked driver under every
    verify mode, gated by the detection law and by the digest mode's
    overhead (10% on the card at non-smoke shapes, 2x elsewhere)."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    n = n or 100_000
    sc, link = gossip_wave(n)

    def make(mode):
        return TorchEngine(sc, link, window="auto", lint="off", verify=mode,
                           device=device)

    _verify_detection_gate(make)
    budget = steps or (1 << 20)
    chunk = 256
    modes = ("off", "guard", "digest", "shadow")
    engs = {m: make(m) for m in modes}
    for eng in engs.values():
        eng.run_verified(budget, chunk=chunk)   # warm
    # every mode's runs in turns, 5 rounds where the bound is strict, else
    # bench.py's 2 (which takes them back to back, mode after mode)
    strict = _strict(device)
    med, out = _interleaved(device, {
        m: (lambda e=e: e.run_verified(budget, chunk=chunk))
        for m, e in engs.items()}, 5 if strict else 2)
    fin = out["off"][0]
    _assert_wave_done(engs["off"], fin, n)
    delivered = _total(fin)
    w_off = med["off"]
    overheads = {}
    for mode in modes[1:]:
        assert engs[mode].last_run_integrity["rollbacks"] == 0, \
            f"verify={mode} false positive on a clean run"
        overheads[mode] = round(med[mode] / w_off - 1.0, 4)
    limit = 0.10 if strict else 1.0
    assert overheads["digest"] <= limit, (
        f"verify='digest' costs {overheads['digest']:.1%} — over the "
        f"{limit:.0%} budget")
    return (f"gossip broadcast wave to quiescence (verified chunked driver, "
            f"verify=off) delivered-messages/sec/chip @{n} nodes",
            delivered / w_off, {"verify_overhead_frac": overheads})


def bench_gossip_100k_record(n, steps, device):
    """The gossip wave through the traced chunked driver under every
    record mode, gated by the record exactness law (off = deliveries =
    full, states and trace rows) and by the deliveries mode's overhead:
    at most 10% at the SMOKE shape and above, 2x below it (``bench.py``'s
    rule). Events and drops per mode ride the line."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    n = n or 100_000
    sc, link = gossip_wave(n)
    cap = 4096

    def make(mode):
        return TorchEngine(sc, link, window="auto", lint="off", record=mode,
                           record_cap=cap, device=device)

    off = make("off")
    f_off, tr_off = off.run(24)
    for mode in ("deliveries", "full"):
        eng = make(mode)
        f, tr = eng.run(24)
        assert_traces_equal(tr_off, tr, "record-off", f"record-{mode}")
        assert_states_equal(f_off, f, f"record={mode} exactness gate", sc)

    budget = steps or (1 << 20)
    chunk = 256

    def drive(eng):
        # the chunked traced drive a recorded run uses: the event plane
        # bounded at [chunk, cap], drained per chunk
        st = eng.init_state()
        done = events = dropped = 0
        while done < budget:
            step = int(min(chunk, budget - done))
            st, tr = eng.run(step, state=st)
            done += len(tr)
            log = eng.last_run_flight
            if log is not None:
                events += len(log)
                dropped += log.dropped
            if len(tr) < step:      # quiesced inside the chunk
                break
        return st, events, dropped

    modes = ("off", "deliveries", "full")
    engs = {m: make(m) for m in modes}
    for eng in engs.values():
        drive(eng)                  # warm
    # every mode's drives in turns, 5 rounds where the bound is strict,
    # else bench.py's 3 (which takes them back to back, mode after mode)
    strict = n >= SMOKE["gossip_100k_record"][0]
    med, out = _interleaved(device, {
        m: (lambda e=e: drive(e)) for m, e in engs.items()},
        5 if strict else 3)
    fin = out["off"][0]
    _assert_wave_done(engs["off"], fin, n)
    delivered = _total(fin)
    w_off = med["off"]
    overheads, counts = {}, {}
    for mode in modes[1:]:
        _f, events, dropped = out[mode]
        overheads[mode] = round(med[mode] / w_off - 1.0, 4)
        counts[mode] = {"events": events, "dropped": dropped}
    limit = 0.10 if strict else 1.0
    assert overheads["deliveries"] <= limit, (
        f"record='deliveries' costs {overheads['deliveries']:.1%} on the "
        f"traced chunked driver — over the {limit:.0%} budget")
    return (f"gossip broadcast wave to quiescence (traced chunked driver, "
            f"record=off) delivered-messages/sec/chip @{n} nodes",
            delivered / w_off,
            {"record_overhead_frac": overheads, "record_events": counts,
             "record_cap": cap})


def bench_serve_gossip(n, steps, device):
    """Emulation as a service: a curator thread and an in-process
    admission book, eight gossip configs into one 8-slot open bucket
    (half admitted mid-bucket), run twice (``first-fit``, then
    ``predicted`` with a forecaster fitted from the first leg). Gated by
    the extended survival law, one engine build a bucket, and one
    journaled ``pack_decision`` before each admit naming its bucket.
    Served configs/sec, admissions/sec and p50/p95 submit-to-
    ``world_done`` latency."""
    import shutil
    import tempfile
    import threading

    from timewarp_tpu_torch.pack import fit_rows, training_rows
    from timewarp_tpu_torch.serve.curator import ServeCurator
    from timewarp_tpu_torch.serve.frontend import ServeFrontend
    from timewarp_tpu_torch.sweep import SweepJournal
    from timewarp_tpu_torch.sweep.journal import util_rollup
    from timewarp_tpu_torch.sweep.spec import RunConfig, solo_result
    n = n or 4096
    steps = steps or 2000
    cfgs = serve_gossip_configs(n, steps)

    def leg(pack_mode, artifact=None):
        root = tempfile.mkdtemp(prefix="tw_serve_bench_")
        try:
            journal = SweepJournal(root, host="bench")
            front = ServeFrontend(journal, "bench", ("127.0.0.1", 0),
                                  slots=8, pack_mode=pack_mode,
                                  pack_artifact=artifact)
            cur = ServeCurator(root, "bench", chunk=max(32, steps // 8),
                               lint="off", lease_ttl_s=60.0, poll_s=0.02,
                               journal=journal, pack_mode=pack_mode,
                               pack_artifact=artifact, device=device)
            t0 = time.perf_counter()
            for d in cfgs[:4]:
                front.admit(d)
            admit_half = time.perf_counter()
            worker = threading.Thread(target=cur.run, daemon=True)
            worker.start()
            # mid-bucket admission: the curator is already running
            for d in cfgs[4:]:
                front.admit(d)
            admit_done = time.perf_counter()
            journal.append({"ev": "serve_drain", "host": "bench"})
            worker.join(timeout=3600)
            assert not worker.is_alive(), "serve curator never drained"
            dt = time.perf_counter() - t0
            scan = SweepJournal(root).scan()
            assert sorted(scan.done) == sorted(d["id"] for d in cfgs), \
                f"unserved worlds: {sorted(scan.done)}"
            for d in cfgs:
                cfg = RunConfig.from_json(d, 0)
                want = solo_result(cfg, lint="off", device=device)
                got = scan.done[d["id"]]
                assert want == got, (
                    f"serve survival law violated for {d['id']} "
                    f"({pack_mode}):\n  solo:     {want}\n"
                    f"  streamed: {got}")
            t_admit, t_done = {}, {}
            for e in scan.events:
                if e.get("ev") == "admit" and e["run_id"] not in t_admit:
                    t_admit[e["run_id"]] = float(e["ts"])
                elif e.get("ev") == "world_done":
                    t_done[e["result"]["run_id"]] = float(e["ts"])
            lats = sorted(t_done[r] - t_admit[r] for r in t_done)
            p50 = lats[len(lats) // 2]
            p95 = lats[min(len(lats) - 1, int(len(lats) * 0.95))]
            delivered = sum(r["delivered"] for r in scan.done.values())
            builds = {b: u.get("engine_builds")
                      for b, u in scan.util.items()}
            assert builds and all(v == 1 for v in builds.values()), (
                f"mid-bucket admission rebuilt an engine ({pack_mode}): "
                f"{builds}")
            compiles = sum(int(u.get("compiles", 0))
                           for u in scan.util.values())
            return {
                "dt": dt, "scan": scan, "roll": util_rollup(scan.util),
                "admit_per_s": round(
                    len(cfgs) / max(1e-9, (admit_half - t0)
                                    + (admit_done - admit_half)), 2),
                "p50": p50, "p95": p95,
                "builds": sum(builds.values()),
                "compiles": compiles, "delivered": delivered,
            }
        finally:
            shutil.rmtree(root, ignore_errors=True)

    ff = leg("first-fit")
    rows = training_rows([RunConfig.from_json(d, 0) for d in cfgs],
                         ff["scan"].done)
    assert len(rows) == len(cfgs), \
        f"training_rows dropped worlds: {len(rows)}/{len(cfgs)}"
    art = fit_rows(rows)
    pr = leg("predicted", artifact=art)
    assert not ff["scan"].pack_decisions, \
        "first-fit leg journaled pack_decision records"
    places = {d["run_id"]: d for d in pr["scan"].pack_decisions
              if d.get("kind") == "place"}
    assert sorted(places) == sorted(x["id"] for x in cfgs), (
        f"predicted leg journaled placements for {sorted(places)}, "
        f"admitted {sorted(x['id'] for x in cfgs)}")
    for rid, a in pr["scan"].admits.items():
        if "repacked_from" in a:
            continue
        assert places[rid]["bucket"] == a["bucket"], (
            f"pack_decision for {rid} named bucket "
            f"{places[rid]['bucket']} but the admit landed in "
            f"{a['bucket']}")
    assert pr["builds"] == ff["builds"], (
        f"placement policy changed engine build count: {pr['builds']} "
        f"predicted vs {ff['builds']} first-fit")
    extra = {
        "worlds": len(cfgs),
        "admit_per_s": pr["admit_per_s"],
        "submit_p50_s": round(pr["p50"], 4),
        "submit_p95_s": round(pr["p95"], 4),
        "buckets": len(pr["scan"].serve_buckets),
        "engine_builds": pr["builds"],
        "compiles": pr["compiles"],
        "delivered_per_s": round(pr["delivered"] / pr["dt"], 2),
        "budget_efficiency": pr["roll"]["budget_efficiency"],
        "pad_waste_frac": pr["roll"]["pad_waste_frac"],
        "first_fit_budget_efficiency": ff["roll"]["budget_efficiency"],
        "first_fit_pad_waste_frac": ff["roll"]["pad_waste_frac"],
        "pack_decisions": len(pr["scan"].pack_decisions),
        "predictor_sha": art["sha"][:12],
    }
    return (f"emulation service (admission + open buckets + stream + "
            f"survival law + predictive placement) served configs/sec "
            f"@{n} nodes", len(cfgs) / pr["dt"], extra)


def bench_lint_sweep(n, steps, device):
    """Static pre-flight verification: the scenario sanitizer over every
    shipped model, the plan lint over every example pack, and the
    determinism scan over every engine x observability mode (aten graphs
    of the superstep bodies). The clean corpus must lint clean and the
    doomed pack must fail. Verified subjects+configs/sec."""
    import glob as globlib

    from timewarp_tpu_torch.analysis import lint_pack_path
    from timewarp_tpu_torch.cli import jaxpr_sweep, lint_sweep
    n = n or 64
    here = os.path.dirname(os.path.abspath(__file__))
    packs = sorted(globlib.glob(os.path.join(here, "examples", "packs",
                                             "*.json")))
    assert packs, "examples/packs/*.json missing"
    t0 = time.perf_counter()
    subjects, rep = lint_sweep(nodes=n, device=device)
    assert rep.ok, f"shipped models failed lint:\n{rep.render()}"
    t1 = time.perf_counter()
    configs = 0
    for path in packs:
        n_entries, prep = lint_pack_path(path)
        configs += n_entries
        if os.path.basename(path).startswith("doomed"):
            assert not prep.ok, (
                f"{path}: the doomed refusal corpus linted GREEN")
        else:
            assert prep.ok, (
                f"{path}: shipped example pack failed the plan lint:\n"
                f"{prep.render()}")
    t2 = time.perf_counter()
    # the body's op inventory does not change with the width: 8 nodes
    jx_subjects, jx_rep = jaxpr_sweep(nodes=8, device=device)
    assert jx_rep.ok, f"determinism sweep failed:\n{jx_rep.render()}"
    assert any(f.code == "TW705" for f in jx_rep.infos), \
        "no TW705 neutrality proofs in the determinism sweep"
    t3 = time.perf_counter()
    total = subjects + configs + jx_subjects
    extra = {"lint_subjects": subjects, "pack_files": len(packs),
             "pack_configs": configs, "jaxpr_subjects": jx_subjects,
             "sanitizer_s": round(t1 - t0, 2), "plan_s": round(t2 - t1, 2),
             "jaxpr_s": round(t3 - t2, 2)}
    return (f"static pre-flight verification (sanitizer + plan lint + "
            f"determinism sweep, refusal corpus gated) verified "
            f"subjects/sec @{n} nodes", total / (t3 - t0), extra)


CONFIGS = {
    "token_ring_dense": bench_token_ring_dense,
    "token_ring_dense_xla": bench_token_ring_dense_xla,
    "token_ring_observer": bench_token_ring_observer,
    "gossip_100k": bench_gossip_100k,
    "gossip_100k_fused": bench_gossip_100k_fused,
    "gossip_100k_insert": bench_gossip_100k_insert,
    "gossip_100k_b8": bench_gossip_100k_b8,
    "gossip_100k_chaos": bench_gossip_100k_chaos,
    "gossip_100k_auto": bench_gossip_100k_auto,
    "gossip_100k_spec": bench_gossip_100k_spec,
    "gossip_100k_verify": bench_gossip_100k_verify,
    "gossip_100k_record": bench_gossip_100k_record,
    "gossip_steady_1m": bench_gossip_steady_1m,
    "praos_1m": bench_praos_1m,
    "praos_1m_fused": bench_praos_1m_fused,
    "praos_1m_insert": bench_praos_1m_insert,
    "praos_1m_b4": bench_praos_1m_b4,
    "sweep_hetero": bench_sweep_hetero,
    "sweep_hetero_auto": bench_sweep_hetero_auto,
    "search_gossip": bench_search_gossip,
    "serve_gossip": bench_serve_gossip,
    "lint_sweep": bench_lint_sweep,
}

#: --smoke shapes (bench.py's): every config small, every gate live
SMOKE = {
    "token_ring_dense": (8192, 16),
    "token_ring_dense_xla": (4096, 32),
    "token_ring_observer": (1024, 32),
    "gossip_100k": (2048, 1 << 14),
    "gossip_100k_fused": (2048, 1 << 14),
    "gossip_100k_insert": (2048, 1 << 14),
    "gossip_100k_b8": (1024, 1 << 14),
    "gossip_100k_chaos": (1024, 1 << 14),
    "gossip_100k_auto": (1024, 1 << 14),
    "gossip_100k_spec": (1024, 1 << 14),
    "gossip_100k_verify": (1024, 1 << 14),
    "gossip_100k_record": (1024, 1 << 14),
    "gossip_steady_1m": (4096, 16),
    "praos_1m": (2048, 24),
    "praos_1m_fused": (2048, 24),
    "praos_1m_insert": (2048, 24),
    "praos_1m_b4": (1024, 24),
    "sweep_hetero": (256, 96),
    "sweep_hetero_auto": (256, 96),
    "search_gossip": (64, 300),
    "serve_gossip": (256, 96),
    "lint_sweep": (64, 1),
}


def _calibrate(device):
    """Session fingerprint: ``bench.py``'s frozen kernel (64 rounds of a
    sort over 2^20 int32, ``x * 1103515245 + i`` between them) as
    ``torch.sort`` on ``device``, timed from an idle device to a
    readback after one warm round (the sort's first launch)."""
    def kern(x, rounds=64):
        for i in range(rounds):
            x = torch.sort(x * 1103515245 + i).values
        return x
    x = torch.arange(1 << 20, dtype=torch.int32, device=device)
    int(kern(x, rounds=1)[0])
    _sync(device)
    t0 = time.perf_counter()
    int(kern(x)[0])
    dt = time.perf_counter() - t0
    return {"kernel": "sort_1m_int32_x64", "seconds": round(dt, 4)}


def _lint_gate(device) -> None:
    """The scenario sanitizer over every shipped model before any config
    runs; silent on success."""
    from timewarp_tpu_torch.cli import lint_sweep
    _, report = lint_sweep(device=device)
    if not report.ok:
        sys.stderr.write(report.render() + "\n")
        raise SystemExit(
            "bench_cuda: error-severity lint findings in shipped models "
            "(run `python -m timewarp_tpu_torch lint` for the report)")


def smoke(device) -> None:
    """Every config at its SMOKE shape (``TW_BENCH_CONFIG``, a
    comma-separated subset, restricts it), every gate on, one line each;
    the rates mean nothing at this scale."""
    cfgs = SMOKE
    only = os.environ.get("TW_BENCH_CONFIG")
    if only:
        names = [s.strip() for s in only.split(",") if s.strip()]
        unknown = sorted(set(names) - set(SMOKE))
        if unknown:
            raise SystemExit(
                f"TW_BENCH_CONFIG names unknown configs {unknown}; "
                f"choose from {sorted(SMOKE)}")
        cfgs = {k: SMOKE[k] for k in names}
    _lint_gate(device)
    env = _env_fields(device)
    for cfg, (n, steps) in cfgs.items():
        t0 = time.perf_counter()
        metric, _rate, extra = _run_config(cfg, n, steps, device)
        _emit({"config": cfg, "config_key": _config_key(cfg, n, steps,
                                                        device),
               "metric": metric, "smoke": True, "ok": True,
               "seconds": round(time.perf_counter() - t0, 1),
               **env, **extra})


def _run_config(cfg, n, steps, device):
    """Run one config on ``device``: ``(metric, rate, extra)``, ``extra``
    the config's additional line fields."""
    res = CONFIGS[cfg](n, steps, device)
    return res[0], res[1], (res[2] if len(res) > 2 else {})


def _flag_value(argv, flag, what):
    if flag not in argv:
        return None
    try:
        v = argv[argv.index(flag) + 1]
    except IndexError:
        raise SystemExit(f"{flag} takes {what}") from None
    if v.startswith("--"):
        raise SystemExit(f"{flag} takes {what}, got {v!r}")
    return v


def _parse_ledger(argv) -> None:
    """--ledger DIR: every line goes to the run ledger under one fresh
    batch label for this invocation."""
    d = _flag_value(argv, "--ledger", "a ledger directory")
    if d is None:
        return
    from timewarp_tpu_torch.obs.ledger import RunLedger
    global _LEDGER
    led = RunLedger(d)
    _LEDGER = (led, led.new_batch())


def _parse_device(argv) -> str:
    """--device cuda|cpu (default the card), refused on a host without a
    card unless ``cpu`` is asked for."""
    from timewarp_tpu_torch.cli import require_device
    device = _flag_value(argv, "--device", "cuda or cpu") or "cuda"
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device takes cuda or cpu, got {device!r}")
    return require_device(device)


def main(argv=None) -> None:
    global _LEDGER, _REPS, _SMOKE
    argv = sys.argv[1:] if argv is None else list(argv)
    device = _parse_device(argv)
    _LEDGER, _REPS, _SMOKE = None, 1, False
    _SPREAD.clear()
    _parse_ledger(argv)
    if "--smoke" in argv:
        if "--reps" in argv:
            raise SystemExit("--reps applies to measured runs only; "
                             "--smoke rates are not measurements")
        _SMOKE = True
        smoke(device)
        return
    reps = 1
    if "--reps" in argv:
        try:
            reps = int(argv[argv.index("--reps") + 1])
        except (IndexError, ValueError):
            raise SystemExit("--reps takes an integer rep count K") from None
        if reps < 1:
            raise SystemExit(f"--reps must be >= 1, got {reps}")
    cfg = os.environ.get("TW_BENCH_CONFIG", "token_ring_dense")
    if cfg not in CONFIGS:
        raise SystemExit(f"TW_BENCH_CONFIG names an unknown config "
                         f"{cfg!r}; choose from {sorted(CONFIGS)}")
    n = int(os.environ.get("TW_BENCH_NODES", 0)) or None
    steps = int(os.environ.get("TW_BENCH_STEPS", 0)) or None
    _lint_gate(device)
    _REPS = reps
    metric, rate, extra = _run_config(cfg, n, steps, device)
    out = {"config": cfg, "config_key": _config_key(cfg, n, steps, device),
           "metric": metric, "value": round(rate, 1), "unit": "msg/s",
           "vs_baseline": round(rate / 1e8, 4), **_env_fields(device),
           **extra}
    if reps > 1 and _SPREAD:
        out["reps"] = reps
        out["min"] = round(_SPREAD["min"], 1)
        out["max"] = round(_SPREAD["max"], 1)
    elif reps > 1:
        # a config that times whole services or campaigns has no window
        # to repeat: it says so rather than pass one run for K
        out["reps"] = 1
        out["reps_note"] = ("measured once: this config times whole runs, "
                            "not a repeatable window")
    out["calib"] = _calibrate(device)
    _emit(out)


if __name__ == "__main__":
    main()
