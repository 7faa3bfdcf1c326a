"""The sharded engines' cases, run inside every rank of a
``parallel.launch.spawn`` group (tests/test_torch_sharded.py spawns four
gloo ranks on the CPU once and runs them all). This module imports only
the port: a spawned rank imports neither ``jax`` nor ``timewarp_tpu``.

:func:`run_all` runs every case of :data:`CASES` in order and returns
``{name: result}``; a case that raises returns ``("error", traceback)``
(a refusal is raised on every rank alike, so the ranks stay in step).
Results are numpy leaves, port traces and plain values, which the test
holds against the reference's one-device runs in its own process.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from timewarp_tpu_torch.core.scenario import NEVER, Outbox, Scenario
from timewarp_tpu_torch.dispatch import DispatchController
from timewarp_tpu_torch.faults import FaultFleet, FaultSchedule, NodeCrash
from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.cuda_insert import (
    LAUNCHES, bucket_bounds, mailbox_insert, mailbox_insert_plain)
from timewarp_tpu_torch.interp.torch_engine.sharded import (
    ShardedBatchedEngine, ShardedEdgeEngine, ShardedEngine,
    ShardedFusedSparseEngine)
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_to_numpy, state_to_numpy)
from timewarp_tpu_torch.integrity import FlipInjector, IntegrityViolation
from timewarp_tpu_torch.integrity.digest import fleet_digest, tree_digest
from timewarp_tpu_torch.models.gossip import gossip
from timewarp_tpu_torch.models.token_ring import token_ring, token_ring_links
from timewarp_tpu_torch.net.delays import (FixedDelay, FnDelay, LinkModel,
                                           Quantize, UniformDelay, WithDrop)
from timewarp_tpu_torch.parallel import MeshComm, check_backend, make_mesh
from timewarp_tpu_torch.utils.checkpoint import load_state, save_state

#: the reference tests' windowed link and window (tests/test_windowed.py)
W = 3_000


def windowed_link():
    return Quantize(UniformDelay(3_000, 9_000), 1_000)


# -- scenarios (module level: a rank rebuilds them from their arguments) ----

def shift_scenario(n, shifts, end_us=40_000, commutative=True):
    """tests/test_sharded.py ``_shift_scenario`` on torch: each node sends
    on slot k to ``(i + shifts[k]) mod n`` every 1 ms."""
    dst = np.stack([(np.arange(n) + s) % n for s in shifts],
                   axis=1).astype(np.int32)
    K = len(shifts)
    tdst = torch.from_numpy(dst.T.copy())                       # [K, n]

    def step(state, inbox, now, i, key):
        seen = state["seen"] + torch.where(
            inbox.valid, inbox.payload[:, 0, :], 0).sum(dim=0,
                                                        dtype=torch.int32)
        alive = now < end_us
        due = (state["next"] <= now) & alive
        sent1 = state["sent"] + 1
        pay = torch.stack([sent1, torch.zeros_like(sent1)])     # [2, N]
        out = Outbox(valid=due[None].expand(K, -1),
                     dst=tdst.to(i.device)[:, i.long()],
                     payload=pay[None].expand(K, 2, -1))
        nxt = torch.where(due, state["next"] + 1_000, state["next"])
        wake = torch.where(alive, nxt, NEVER)
        return {"seen": seen,
                "sent": state["sent"] + torch.where(due, K, 0).to(
                    torch.int32),
                "next": nxt}, out, wake

    def init(nn, device):
        z = torch.zeros(nn, dtype=torch.int32, device=device)
        return {"seen": z, "sent": z.clone(),
                "next": torch.zeros(nn, dtype=torch.int64, device=device)}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    return Scenario(name=f"shift-{shifts}", n_nodes=n, step=step,
                    init_batched=init, payload_width=2, max_out=K,
                    mailbox_cap=4 * K, static_dst=dst,
                    commutative_inbox=commutative)


def parity_delay():
    """tests/test_sharded.py's order-sensitive link: even senders 700 µs,
    odd ones 1700 µs."""
    return FnDelay(lambda s, d, t, k: (
        torch.where(s % 2 == 0, 700, 1700),
        torch.zeros(d.shape, dtype=torch.bool, device=d.device)))


def perm_scenario(n=16, seed=3):
    """A random permutation topology (not pure shifts)."""
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    tperm = torch.from_numpy(perm)

    def step(state, inbox, now, i, key):
        N = i.shape[0]
        return state, Outbox(
            valid=torch.ones((1, N), dtype=torch.bool, device=i.device),
            dst=tperm.to(i.device)[i.long()][None],
            payload=torch.zeros((1, 2, N), dtype=torch.int32,
                                device=i.device)), \
            torch.full((N,), NEVER, dtype=torch.int64, device=i.device)

    def init(nn, device):
        return {"x": torch.zeros(nn, dtype=torch.int32, device=device)}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    return Scenario(name="perm", n_nodes=n, step=step, init_batched=init,
                    payload_width=2, max_out=1, mailbox_cap=4,
                    static_dst=perm.reshape(n, 1), commutative_inbox=True)


def random_dst_scenario(n=64):
    """tests/test_sharded.py's fully dynamic destinations: an LCG on node
    state picks each firing's destination."""
    def step(state, inbox, now, i, key):
        seen = state["seen"] + torch.where(
            inbox.valid, inbox.payload[:, 0, :], 0).sum(dim=0,
                                                        dtype=torch.int32)
        lcg = state["lcg"] * 1103515245 + 12345           # int32 wraps
        dst = torch.abs(lcg) % n
        alive = now < 60_000
        due = (state["next"] <= now) & alive
        pay = torch.stack([state["sent"] + 1, torch.zeros_like(lcg)])
        out = Outbox(valid=due[None], dst=dst[None], payload=pay[None])
        nxt = torch.where(due, state["next"] + 2_000, state["next"])
        wake = torch.where(alive, nxt, NEVER)
        return {"seen": seen, "sent": state["sent"] + due.to(torch.int32),
                "lcg": lcg, "next": nxt}, out, wake

    def init(nn, device):
        ids = torch.arange(nn, dtype=torch.int32, device=device)
        z = torch.zeros(nn, dtype=torch.int32, device=device)
        return {"seen": z, "sent": z.clone(), "lcg": ids * 7 + 3,
                "next": torch.zeros(nn, dtype=torch.int64, device=device)}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    return Scenario(name="rand-dst", n_nodes=n, step=step,
                    init_batched=init, payload_width=2, max_out=1,
                    mailbox_cap=16, commutative_inbox=True)


def hub_flood_scenario(n=64):
    """tests/test_sharded.py's bucket-overflow flood: every node but 0
    sends to node 0 every ms until 20 ms."""
    def step(state, inbox, now, i, key):
        alive = now < 20_000
        due = alive & (i > 0)
        N = i.shape[0]
        out = Outbox(valid=due[None],
                     dst=torch.zeros((1, N), dtype=torch.int32,
                                     device=i.device),
                     payload=torch.zeros((1, 2, N), dtype=torch.int32,
                                         device=i.device))
        return state, out, torch.where(due, now + 1_000, NEVER)

    def init(nn, device):
        wake = torch.zeros(nn, dtype=torch.int64, device=device)
        wake[0] = NEVER
        return {"x": torch.zeros(nn, dtype=torch.int32, device=device)}, wake

    return Scenario(name="hub-flood", n_nodes=n, step=step,
                    init_batched=init, payload_width=2, max_out=1,
                    mailbox_cap=64, commutative_inbox=True)


def ring_fault_fleet():
    """tests/test_zfault_parity.py's chaos fleet: node crashes with a
    state reset, one schedule a world."""
    return FaultFleet(tuple(FaultSchedule((
        NodeCrash((3 * b + 1) % 16, 20_000, 60_000 + 1_000 * b,
                  reset_state=True),)) for b in range(4)))


def telemetry_gossip():
    """tests/test_zztelemetry.py's ``_gossip`` (48 nodes)."""
    return gossip(48, fanout=3, burst=True, end_us=150_000,
                  mailbox_cap=16), Quantize(UniformDelay(3000, 9000), 1000)


def flight_gossip():
    """tests/test_zzzzzflight.py's ``_gossip`` (32 nodes)."""
    return gossip(32, fanout=3, burst=True, end_us=150_000,
                  mailbox_cap=16), Quantize(UniformDelay(3000, 9000), 1000)


def dispatch_wave():
    """tests/test_zzzdispatch.py's ``_wave(n=32, end_us=120_000)``."""
    from timewarp_tpu_torch.models.gossip import gossip_links
    sc = gossip(32, fanout=4, think_us=2_000, burst=True, end_us=120_000,
                mailbox_cap=16)
    return sc, Quantize(gossip_links(median_us=20_000, sigma=0.6,
                                     floor_us=8_000), 1_000)


def verify_gossip():
    """tests/test_torch_integrity.py's gossip at 64 nodes (16 a rank)."""
    return gossip(64, fanout=3, burst=True, end_us=150_000,
                  mailbox_cap=16), Quantize(UniformDelay(3000, 9000), 1000)


def verify_ring():
    """tests/test_torch_integrity.py's 16-node ring (4 nodes a rank)."""
    return token_ring(16, n_tokens=4, think_us=2000, bootstrap_us=1000,
                      end_us=120_000, with_observer=False,
                      mailbox_cap=8), FixedDelay(500)


#: the verified runs: budget and chunk (tests/test_torch_integrity.py's),
#: the modes, and each engine's flip per mode (None: a clean run), each
#: landing on a rank other than 0 (the test checks where)
VERIFY_BUDGET, VERIFY_CHUNK = 48, 8
VERIFY_MODES = ("guard", "digest", "shadow")
VERIFY_FLIPS = {
    "general": (None, "flip:2:2:mb_rel", "flip:3:2:mb_src"),
    "fused": (None, "flip:2:2:mb_rel", "flip:3:2:mb_src"),
    "edge": (None, "flip:3:2:q_rel", "flip:2:3:wake"),
    "fleet": (None, "flip:1:2:mb_rel", "flip:4:3:wake"),
}
#: run_stream's per-world budgets on the 4-world fleet (world 3 quiesced
#: before the first chunk)
STREAM_BUDGETS = (10, 48, 30, 0)


# -- result helpers ------------------------------------------------------------

def _edge(eng, st):
    return edge_state_to_numpy(eng.gather_state(st))


def _gen(eng, st):
    return state_to_numpy(eng.gather_state(st), eng.scenario)


def _frames(fr):
    if isinstance(fr, list):                      # one frame set a world
        return [_frames(f) for f in fr]
    return {k: np.asarray(v) for k, v in fr.data.items()}


# -- the cases -------------------------------------------------------------------

def case_dense_ring(dev):
    sc = token_ring(64, n_tokens=64, think_us=0, bootstrap_us=1000,
                    end_us=150_000, with_observer=False, mailbox_cap=4)
    eng = ShardedEdgeEngine(sc, FixedDelay(500), make_mesh(), device=dev)
    st, tr = eng.run(400)
    return {"trace": tr, "state": _edge(eng, st)}


def case_ring_drop(dev):
    sc = token_ring(64, n_tokens=16, think_us=2_000, bootstrap_us=1000,
                    end_us=400_000, with_observer=False, mailbox_cap=6)
    link = WithDrop(UniformDelay(500, 1500), 0.3)
    eng = ShardedEdgeEngine(sc, link, make_mesh(), cap=3, device=dev)
    st, tr = eng.run(1200)
    return {"trace": tr, "state": _edge(eng, st)}


def case_shifts(dev):
    eng = ShardedEdgeEngine(shift_scenario(64, [1, 10, 17, 33]),
                            UniformDelay(100, 900), make_mesh(), cap=8,
                            device=dev)
    st, tr = eng.run(150)
    return {"trace": tr, "state": _edge(eng, st)}


def case_noncommutative(dev):
    eng = ShardedEdgeEngine(shift_scenario(48, [1, 2], commutative=False),
                            parity_delay(), make_mesh(), cap=8, device=dev)
    st, tr = eng.run(200)
    return {"trace": tr, "state": _edge(eng, st)}


def case_quiet_equals_traced(dev):
    sc = token_ring(64, n_tokens=8, think_us=1_000, bootstrap_us=1000,
                    end_us=100_000, with_observer=False, mailbox_cap=4)
    eng = ShardedEdgeEngine(sc, UniformDelay(200, 900), make_mesh(),
                            device=dev)
    st, _ = eng.run(200)
    return {"traced": _edge(eng, st), "quiet": _edge(eng, eng.run_quiet(200))}


def case_edge_resume(dev):
    sc = token_ring(64, n_tokens=8, think_us=1_000, bootstrap_us=1000,
                    end_us=150_000, with_observer=False, mailbox_cap=4)
    eng = ShardedEdgeEngine(sc, UniformDelay(200, 900), make_mesh(),
                            device=dev)
    _, full = eng.run(150)
    mid, first = eng.run(60)
    _, rest = eng.run(90, state=mid)
    return {"full": full, "first": first, "rest": rest}


def case_state_per_rank(dev):
    sc = token_ring(64, n_tokens=8, think_us=1_000, bootstrap_us=1000,
                    end_us=100_000, with_observer=False, mailbox_cap=4)
    eng = ShardedEdgeEngine(sc, FixedDelay(500), make_mesh(), device=dev)
    st = eng.init_state()
    fin = eng.run_quiet(200)
    g = eng.gather_state(fin)
    return {"wake": tuple(st.wake.shape), "q_rel": tuple(st.q_rel.shape),
            "final_wake": tuple(fin.wake.shape),
            "gathered_wake": tuple(g.wake.shape),
            "first_id": int(eng._node_ids[0]), "rank": dist.get_rank()}


def case_refusals(dev):
    out = {}
    mesh = make_mesh()
    for name, call in (
            ("non_shift", lambda: ShardedEdgeEngine(
                perm_scenario(), FixedDelay(1), mesh, device=dev)),
            ("indivisible", lambda: ShardedEdgeEngine(
                token_ring(62, n_tokens=1, with_observer=False),
                FixedDelay(1), mesh, device=dev)),
            ("indivisible_general", lambda: ShardedEngine(
                token_ring(62, n_tokens=1, with_observer=False),
                FixedDelay(1), mesh, device=dev)),
            ("record_general", lambda: ShardedEngine(
                gossip(64, burst=True), FixedDelay(5_000), mesh,
                record="full", device=dev)),
            ("record_fused", lambda: ShardedFusedSparseEngine(
                gossip(64, burst=True), FixedDelay(5_000), mesh,
                window="auto", record="deliveries", device=dev)),
            ("record_edge", lambda: ShardedEdgeEngine(
                token_ring(64, with_observer=False), FixedDelay(500), mesh,
                record="full", device=dev)),
            ("fused_ordered", lambda: ShardedFusedSparseEngine(
                shift_scenario(64, [1, 2], commutative=False),
                FixedDelay(5_000), mesh, window="auto", device=dev)),
            ("no_batch", lambda: ShardedBatchedEngine(
                gossip(64, burst=True), FixedDelay(5_000),
                make_mesh(axis="worlds"), batch=None, device=dev)),
            ("indivisible_fleet", lambda: ShardedBatchedEngine(
                token_ring(32, n_tokens=4, think_us=2_000,
                           bootstrap_us=1_000, end_us=150_000),
                token_ring_links(32), make_mesh(axis="worlds"),
                batch=BatchSpec(seeds=(0, 1, 2)), device=dev)),
            ("default_device", lambda: ShardedEngine(
                gossip(64, burst=True), FixedDelay(5_000), mesh)),
            ("nccl", lambda: check_backend("nccl",
                                           dist.get_world_size()))):
        try:
            call()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    # the lazy path never runs sharded: a route_cap on a drop-free link
    # stays on the eager path, which exchanges
    eng = ShardedEngine(gossip(64, fanout=4, think_us=700,
                               gossip_interval=500, end_us=400_000,
                               mailbox_cap=16),
                        windowed_link(), mesh, window=W, route_cap=256,
                        device=dev)
    out["lazy"], out["adaptive"] = eng.lazy, eng.adaptive
    return out


def _tw104_ring(n=4):
    """A ring whose step returns an int32 wake: a TW104 lint error."""
    def step(state, inbox, now, i, bits):
        L = now.shape[0]
        out = Outbox(valid=torch.zeros((1, L), dtype=torch.bool),
                     dst=torch.zeros((1, L), dtype=torch.int32),
                     payload=torch.zeros((1, 1, L), dtype=torch.int32))
        return state, out, torch.zeros_like(now, dtype=torch.int32)

    def init_batched(nn, device):
        return ({"x": torch.zeros(nn, dtype=torch.int32, device=device)},
                torch.zeros(nn, dtype=torch.int64, device=device))
    sd = ((np.arange(n) + 1) % n).astype(np.int32)[:, None]
    return Scenario(name="tw104-ring", n_nodes=n, step=step,
                    init_batched=init_batched, payload_width=1,
                    mailbox_cap=4, commutative_inbox=True, static_dst=sd)


def case_lint(dev):
    """Every sharded engine's construction lint knob: ``(error-mode
    report ok, default mode, default report kept, off report, the codes
    a defective scenario raises under "error")``."""
    from timewarp_tpu_torch.analysis import LintError
    nodes, worlds = make_mesh(), make_mesh(axis="worlds")
    builds = {
        "edge": lambda sc, **kw: ShardedEdgeEngine(
            sc, FixedDelay(500), nodes, device=dev, **kw),
        "general": lambda sc, **kw: ShardedEngine(
            sc, FixedDelay(500), nodes, device=dev, **kw),
        "fused": lambda sc, **kw: ShardedFusedSparseEngine(
            sc, FixedDelay(500), nodes, window="auto", device=dev, **kw),
        "fleet": lambda sc, **kw: ShardedBatchedEngine(
            sc, FixedDelay(500), worlds, batch=BatchSpec(seeds=(0, 1, 2, 3)),
            device=dev, **kw),
    }
    out = {}
    for name, build in builds.items():
        clean = token_ring(64, with_observer=False) if name != "fused" \
            else gossip(64, burst=True)
        strict = build(clean, lint="error")
        default = build(clean)
        try:
            build(_tw104_ring(), lint="error")
            codes = None
        except LintError as e:
            codes = sorted(set(e.report.codes()))
        out[name] = (strict.lint_report.ok, default.lint,
                     default.lint_report is not None,
                     build(clean, lint="off").lint_report, codes)
    return out


def case_roll(dev):
    n = 64
    x = torch.arange(n, dtype=torch.int32) * 3 + 1
    comm = MeshComm(make_mesh(), "nodes", n, torch.device(dev))
    loc = comm.local_rows(x)
    two = comm.local_rows(torch.stack([x, -x]))
    return {s: (np.array_equal(comm.all_gather(comm.roll(loc, s), 0).cpu(),
                               torch.roll(x, s)),
                np.array_equal(comm.all_gather(comm.roll(two, s), 1).cpu(),
                               torch.roll(torch.stack([x, -x]), s, dims=1)))
            for s in (0, 1, 5, 8, 10, 16, 17, 33, 63, 64, 130)}


def case_observer_ring(dev):
    sc = token_ring(63, n_tokens=8, think_us=3_000, bootstrap_us=1000,
                    end_us=200_000, with_observer=True, mailbox_cap=16)
    eng = ShardedEngine(sc, token_ring_links(63), make_mesh(), device=dev)
    st, tr = eng.run(250)
    return {"trace": tr, "state": _gen(eng, st)}


def case_random_dst(dev):
    eng = ShardedEngine(random_dst_scenario(),
                        WithDrop(UniformDelay(300, 2_000), 0.2),
                        make_mesh(), device=dev)
    st, tr = eng.run(300)
    return {"trace": tr, "state": _gen(eng, st)}


def case_general_resume(dev):
    sc = token_ring(63, n_tokens=4, think_us=2_000, bootstrap_us=1000,
                    end_us=150_000, with_observer=True, mailbox_cap=16)
    eng = ShardedEngine(sc, token_ring_links(63), make_mesh(), device=dev)
    st, full = eng.run(120)
    mid, first = eng.run(50)
    _, rest = eng.run(70, state=mid)
    quiet = eng.run_quiet(120)
    return {"full": full, "first": first, "rest": rest,
            "quiet": _gen(eng, quiet), "traced": _gen(eng, st)}


def case_bucket_overflow(dev):
    eng = ShardedEngine(hub_flood_scenario(), FixedDelay(500), make_mesh(),
                        bucket_cap=3, device=dev)
    st, tr = eng.run(60)
    return {"trace": tr, "state": _gen(eng, st)}


def case_two_axis(dev):
    mesh = make_mesh(shape=(2, 2), axes=("dcn", "ici"))
    ax = ("dcn", "ici")
    sc = token_ring(64, n_tokens=16, think_us=1_000, bootstrap_us=1000,
                    end_us=120_000, with_observer=False, mailbox_cap=4)
    link = UniformDelay(300, 1_200)
    _, ring = ShardedEdgeEngine(sc, link, mesh, axis=ax, device=dev).run(150)
    sc2 = gossip(64, fanout=4, think_us=2_000, gossip_interval=1_000,
                 end_us=300_000, mailbox_cap=8)
    _, gen = ShardedEngine(sc2, link, mesh, axis=ax, device=dev).run(150)
    return {"ring": ring, "general": gen}


def case_windowed(dev):
    sc = gossip(64, fanout=4, think_us=700, gossip_interval=500,
                end_us=400_000, mailbox_cap=16)
    out = {}
    for name, mesh, ax in (
            ("flat", make_mesh(), "nodes"),
            ("dcn_ici", make_mesh(shape=(2, 2), axes=("dcn", "ici")),
             ("dcn", "ici"))):
        _, out[name] = ShardedEngine(sc, windowed_link(), mesh, axis=ax,
                                     window=W, device=dev).run(400)
    st, out["route_cap"] = ShardedEngine(
        sc, windowed_link(), make_mesh(), window=W, route_cap=256,
        device=dev).run(400)
    out["route_cap_drop"] = int(st.route_drop)
    return out


def case_fused_sharded(dev):
    sc = gossip(8192, fanout=4, think_us=3_000, burst=True,
                end_us=400_000, mailbox_cap=8)
    link = Quantize(UniformDelay(3_000, 9_000), 1_000)
    fus = ShardedFusedSparseEngine(sc, link, make_mesh(), window=3_000,
                                   device=dev)
    gen = ShardedEngine(sc, link, make_mesh(), window=3_000, device=dev)
    fs, tf = fus.run(60)
    gs, tg = gen.run(60)
    fq = fus.run_quiet(60)
    return {"trace": tf, "general_trace": tg, "state": _gen(fus, fs),
            "general_state": _gen(gen, gs), "quiet": _gen(fus, fq),
            "S2": fus.S2, "stage_S": fus.stage.S,
            "bucket_cap": fus.bucket_cap}


def case_fleet(dev):
    sc = token_ring(32, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
                    end_us=150_000)
    link = token_ring_links(32)
    spec = BatchSpec(seeds=tuple(range(8)))
    sh = ShardedBatchedEngine(sc, link, make_mesh(axis="worlds"),
                              batch=spec, device=dev)
    st, tr = sh.run(100)
    supersteps = sh.last_run_stats["supersteps"]
    quiet = sh.run_quiet(60)
    vec = sh.run(np.array([5, 60, 0, 100, 7, 7, 30, 1]))[1]
    return {"traces": tr, "state": _gen(sh, st),
            "quiet": _gen(sh, quiet), "vec_traces": vec,
            "local_B": int(st.wake.shape[0]),
            "supersteps": supersteps}


def case_chaos_fleet(dev):
    sc = token_ring(16, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
                    end_us=150_000, with_observer=True, mailbox_cap=16)
    link = token_ring_links(16)
    sh = ShardedBatchedEngine(sc, link, make_mesh(axis="worlds"),
                              batch=BatchSpec(seeds=tuple(range(4))),
                              faults=ring_fault_fleet(), device=dev)
    st, tr = sh.run(80)
    return {"traces": tr, "state": _gen(sh, st)}


def case_telemetry(dev):
    out = {}
    ring = token_ring(32, n_tokens=8, think_us=2000, bootstrap_us=1000,
                      end_us=150_000, with_observer=False, mailbox_cap=8)
    mesh = make_mesh()
    for mode in ("off", "full"):
        eng = ShardedEdgeEngine(ring, FixedDelay(500), mesh, telemetry=mode,
                                device=dev)
        st, tr = eng.run(24)
        out[f"edge_{mode}"] = (tr, _edge(eng, st))
        if mode == "full":
            out["edge_frames"] = _frames(eng.last_run_telemetry)
    sc, link = telemetry_gossip()
    for mode in ("off", "full"):
        eng = ShardedEngine(sc, link, mesh, window="auto", telemetry=mode,
                            device=dev)
        st, tr = eng.run(16)
        out[f"general_{mode}"] = (tr, _gen(eng, st))
        if mode == "full":
            out["general_frames"] = _frames(eng.last_run_telemetry)
    spec = BatchSpec(seeds=(0, 1, 2, 3))
    for mode in ("off", "counters", "full"):
        eng = ShardedBatchedEngine(sc, link, make_mesh(axis="worlds"),
                                   batch=spec, window="auto",
                                   telemetry=mode, device=dev)
        st, tr = eng.run(16)
        out[f"fleet_{mode}"] = (tr, _gen(eng, st))
        if mode != "off":
            out[f"fleet_frames_{mode}"] = _frames(eng.last_run_telemetry)
    return out


def case_controller(dev):
    sc, link = dispatch_wave()
    eng = ShardedBatchedEngine(
        sc, link, make_mesh(axis="worlds"),
        batch=BatchSpec(seeds=tuple(range(4))), window="auto",
        telemetry="counters",
        controller=DispatchController(chunk=8, chunk_max=32), device=dev)
    fin, traces = eng.run_controlled(1 << 12)
    return {"traces": traces, "state": _gen(eng, fin),
            "decisions": [d.to_json() for d in eng.last_run_decisions]}


def case_flight(dev):
    sc, link = flight_gossip()
    spec = BatchSpec(seeds=(0, 1, 2, 3))
    out = {}
    for mode in ("off", "full"):
        eng = ShardedBatchedEngine(sc, link, make_mesh(axis="worlds"),
                                   batch=spec, window="auto", record=mode,
                                   device=dev)
        st, tr = eng.run(16)
        out[mode] = (tr, _gen(eng, st))
    out["keysets"] = [lg.keyset() for lg in eng.last_run_flight]
    return out


@dataclasses.dataclass(frozen=True)
class Gap(LinkModel):
    """tests/test_torch_speculate.py's integer gap link: delays in
    ``[lo_us, lo_us + span_us)`` from the message key, drop-free,
    declaring no floor of its own."""
    lo_us: int = 4_000
    span_us: int = 36_001

    def sample(self, src, dst, t, key):
        return (self.lo_us + key[0] % self.span_us,
                torch.zeros(dst.shape, dtype=torch.bool, device=dst.device))


def case_speculation(dev):
    """tests/test_torch_speculate_fleet.py's masked rollback on 4 worlds,
    one a rank: worlds 0 and 2 sample from 4 ms and violate at fixed:8000,
    worlds 1 and 3 from 20 ms; the sharded fleet against the port's
    one-device fleet (itself held against the reference there)."""
    sc = gossip(96, fanout=4, burst=True, end_us=300_000, mailbox_cap=16,
                think_us=700)
    spec = BatchSpec(seeds=(5, 6, 7, 8), link_params={
        "inner.lo_us": [4_000, 20_000, 4_000, 20_000]})
    out = {}
    for name, eng in (
            ("sharded", ShardedBatchedEngine(
                sc, Quantize(Gap(), 500), make_mesh(axis="worlds"),
                batch=spec, window="auto", speculate="fixed:8000",
                telemetry="counters", device=dev)),
            ("local", TorchEngine(sc, Quantize(Gap(), 500), batch=spec,
                                  window="auto", speculate="fixed:8000",
                                  telemetry="counters", device=dev))):
        fin, traces = eng.run_speculative(3000, chunk=16)
        if name == "sharded":
            fin = eng.gather_state(fin)
        out[name] = dict(
            traces=traces, state=state_to_numpy(fin, sc),
            speculation=eng.last_run_speculation,
            chains=[[d.to_json() for d in c]
                    for c in eng.last_run_decisions_world])
    return out


def _verified_engine(name, mode, dev):
    nodes = make_mesh()
    if name == "general":
        return ShardedEngine(*verify_gossip(), nodes, window="auto",
                             verify=mode, device=dev)
    if name == "fused":
        return ShardedFusedSparseEngine(*verify_gossip(), nodes,
                                        window="auto", verify=mode,
                                        device=dev)
    if name == "edge":
        return ShardedEdgeEngine(*verify_ring(), nodes, verify=mode,
                                 device=dev)
    return ShardedBatchedEngine(*verify_gossip(), make_mesh(axis="worlds"),
                                batch=BatchSpec(seeds=(0, 1, 2, 3)),
                                window="auto", verify=mode, device=dev)


def case_verified(dev):
    """Every sharded engine's ``run_verified`` in every mode, the digest
    and shadow runs with a flip (:data:`VERIFY_FLIPS`): trace, gathered
    state, integrity record, the flip, the sharded digest of the final
    state beside the gathered state's, and ``run_quiet``'s final-state
    guard on a state whose wake (a fleet's steps) went negative on rank 2
    alone (each rank records what it raised)."""
    out = {}
    for name, flips in VERIFY_FLIPS.items():
        for mode, spec in zip(VERIFY_MODES, flips):
            eng = _verified_engine(name, mode, dev)
            flip = None if spec is None else FlipInjector(spec)
            fin, tr = eng.run_verified(VERIFY_BUDGET, chunk=VERIFY_CHUNK,
                                       inject=flip)
            g = eng.gather_state(fin)
            if name == "fleet":
                digests = (fleet_digest(fin, shards=eng).tolist(),
                           fleet_digest(g).tolist())
            else:
                digests = (int(tree_digest(fin, shards=eng)),
                           int(tree_digest(g)))
            out[f"{name}-{mode}"] = dict(
                trace=tr, rec=eng.last_run_integrity, digests=digests,
                state=edge_state_to_numpy(g) if name == "edge"
                else state_to_numpy(g, eng.scenario),
                flip=None if flip is None else (flip.fired, flip.desc))
            if mode == "guard":
                # a fleet's guard reads its per-world scalars, a node-
                # sharded engine's its wake too
                field = "steps" if name == "fleet" else "wake"
                x = getattr(fin, field).clone()
                if dist.get_rank() == 2:
                    x.view(-1)[0] = -5
                try:
                    eng._quiet_guard(fin._replace(**{field: x}))
                    out[f"{name}-quiet"] = None
                except IntegrityViolation as e:
                    out[f"{name}-quiet"] = str(e)
    return out


def case_stream(dev):
    """The world-sharded fleet's ``run_stream`` under per-world budgets:
    each ``on_quiesce`` call (world, its steps, the state's world count)
    and each ``on_chunk`` call's state world count."""
    eng = _verified_engine("fleet", "off", dev)
    seen, chunks = [], []
    fin, tr = eng.run_stream(
        np.array(STREAM_BUDGETS), chunk=VERIFY_CHUNK,
        on_quiesce=lambda b, st: seen.append(
            (b, int(st.steps[b]), int(st.wake.shape[0]))),
        on_chunk=lambda st, trs: chunks.append(int(st.wake.shape[0])))
    return {"traces": tr, "state": _gen(eng, fin), "seen": seen,
            "chunks": chunks, "supersteps": eng.last_run_stats["supersteps"]}


def case_checkpoint(dev):
    """A checkpoint as the command line takes one on the ranks: the node-
    and the world-sharded gossip run 24 supersteps, rank 0 writes the
    gathered state (``save_state``, the one-device layout), every rank
    loads it into ``global_init_state()``, keeps its shard
    (``scatter_state``) and runs 24 more, beside the uninterrupted 48.
    The files stay in a fresh directory for the test to read."""
    where = [tempfile.mkdtemp(prefix="tw-sharded-ck-")
             if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(where, src=0)
    out = {"dir": where[0]}
    for name in ("general", "fleet"):
        eng = _verified_engine(name, "off", dev)
        path = os.path.join(where[0], f"{name}.npz")
        mid = eng.gather_state(eng.run(24)[0])
        if dist.get_rank() == 0:
            save_state(path, mid, meta={"scenario": eng.scenario.name},
                       scenario=eng.scenario)
        dist.barrier()
        st, _ = load_state(path, eng.global_init_state(),
                           scenario=eng.scenario)
        fin, tr = eng.run(24, state=eng.scatter_state(st))
        full, ftr = eng.run(48)
        out[name] = dict(path=path, mid=state_to_numpy(mid, eng.scenario),
                         resumed=_gen(eng, fin), trace=tr,
                         full=_gen(eng, full), full_trace=ftr)
    return out


def case_k1_per_shard(dev):
    """K1 at a sharded rank's post-exchange shape (n = n_local, a batch
    of D · bucket_cap, ordered and commutative) against its plain
    version: on the card the kernel, on the CPU the plain version twice
    (the case then checks only that the shapes run)."""
    D = dist.get_world_size()
    rng = np.random.default_rng(7 + dist.get_rank())
    nl, K, P, bc = 1024, 8, 2, 700
    S = D * bc
    out = {}
    for ordered in (False, True):
        dst = np.sort(np.where(rng.random(S) < 0.8,
                               rng.integers(0, nl, S), nl)).astype(np.int32)
        sd = torch.from_numpy(dst).to(dev)
        drel = torch.from_numpy(rng.integers(0, 10_000, S,
                                             dtype=np.int32)).to(dev)
        src = torch.from_numpy(rng.integers(0, 4096, S,
                                            dtype=np.int32)).to(dev)
        pay = torch.from_numpy(rng.integers(-9, 9, (P, S),
                                            dtype=np.int32)).to(dev)
        rel = np.where(rng.random((K, nl)) < 0.4,
                       rng.integers(0, 5000, (K, nl)), 2**31 - 1)
        counts = None
        if ordered:
            rel = np.sort(rel, axis=0)
            counts = torch.from_numpy(
                (rel < 2**31 - 1).sum(axis=0).astype(np.int32)).to(dev)
        mb_rel = torch.from_numpy(rel.astype(np.int32)).to(dev)
        mb_src = torch.zeros((K, nl), dtype=torch.int32, device=dev)
        mb_pay = torch.zeros((K, P, nl), dtype=torch.int32, device=dev)
        start, cnt = bucket_bounds(sd, nl)
        before = LAUNCHES["mailbox_insert"]
        got = mailbox_insert(start, cnt, counts, drel, src, pay, mb_rel,
                             mb_src, mb_pay)
        want = mailbox_insert_plain(start.cpu(), cnt.cpu(),
                                    None if counts is None else counts.cpu(),
                                    drel.cpu(), src.cpu(), pay.cpu(),
                                    mb_rel.cpu(), mb_src.cpu(), mb_pay.cpu())
        out["ordered" if ordered else "commutative"] = (
            all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
            LAUNCHES["mailbox_insert"] - before)
    return out


def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "timewarp_tpu")
                  or m.startswith(("jax.", "timewarp_tpu.")))


def rank_modules(device):
    """The jax or reference modules a rank holds (none)."""
    return _foreign_modules()


def fail_on_rank(device, bad):
    """A launch target that raises on rank ``bad`` (the others wait in a
    collective the failing rank never joins)."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def fail_with_a_slow_exit(device, bad, seconds):
    """A launch target whose rank ``bad`` raises and then takes
    ``seconds`` to exit (as a teardown that blocks would), while the
    others sleep as long in no collective: only the failed rank's claim
    can stop the launch early."""
    if dist.get_rank() == bad:
        import atexit
        atexit.register(time.sleep, seconds)
        raise ValueError(f"rank {bad} fails on purpose")
    time.sleep(seconds)
    return dist.get_rank()


CASES = {k[5:]: v for k, v in sorted(globals().items())
         if k.startswith("case_")}
#: what the ranks run on the CPU (K1 per shard is the card's case)
CPU_CASES = [k for k in CASES if k != "k1_per_shard"]


def run_all(device, names=None):
    """Every CPU case in order (or ``names``), each as ``{name:
    result}``; ``sys_modules`` lists any jax or reference module the rank
    holds, ``threads`` the rank's torch threads."""
    torch.manual_seed(0)
    out, secs = {}, {}
    for name in names or CPU_CASES:
        t0 = time.perf_counter()
        try:
            out[name] = CASES[name](device)
        except Exception:
            out[name] = ("error", traceback.format_exc())
        secs[name] = time.perf_counter() - t0
    out["seconds"] = secs
    out["sys_modules"] = _foreign_modules()
    out["threads"] = torch.get_num_threads()
    return out
