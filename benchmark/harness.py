"""One run of one cell: set-up, the measured window, the traced slice,
the check against the plain reference, and the result.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel count lives in a file of its own, found by its name in
``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment (scenario family and its
  parameters, link, engine, window, the control's precision);
- ``traffic/<traffic>.json``: worlds, warm-up supersteps, the chunk of
  supersteps the window runs back to back (a closed loop: each chunk
  starts when the last has ended), the traced chunks, and optionally
  the worlds whose warm-up is checked (``warm_check_worlds``) and a
  leaf the compared chunk must change (``check_changes``, within
  ``check_max_chunks``);
- ``metrics/<metric>.py``: ``read(ctx)`` gives the metric, or None where
  the run has nothing it reads;
- ``roofline/<kernel>.py``: the kernel's symbol and the bytes its
  function needs;
- ``reference/models/<family>.py``: the family's plain step.

A cell's worlds take the seeds ``seed * worlds + b``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import random
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import system
from . import trace as tr
from .reference import engine as ref_engine

#: the H100 SXM's HBM3 bandwidth (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
GIB = 1 << 30
I32MAX = 2**31 - 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load_file(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> SimpleNamespace:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                             f"cells: {', '.join(cells)}")
        w = cells[name]
        cfg_entry = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = json.loads((self.root / cfg_entry["file"]).read_text())
        traffic = json.loads(
            (self.dir / "traffic" / f"{w['traffic']}.json").read_text())

        def applies(m):
            return name in m.get("workloads", [name])
        return SimpleNamespace(
            name=name, workload=w, config=config, traffic=traffic,
            end_to_end=[m for m in self.spec["end_to_end"] if applies(m)],
            per_layer=[m for m in self.spec["per_layer"] if applies(m)])

    def metric_reader(self, name: str):
        return _load_file(self.dir / "metrics" / f"{name}.py",
                          f"benchmark_metric_{name}")

    def roofline(self, kernel: str):
        return _load_file(self.dir / "roofline" / f"{kernel}.py",
                          f"benchmark_roofline_{kernel}")


def reference_model(config: dict):
    sc = config["scenario"]
    family = importlib.import_module(
        f"benchmark.reference.models.{sc['family']}")
    return family.build(sc["n"], **sc["params"])


def world_seeds(seed: int, worlds: int) -> list:
    return [seed] if worlds == 1 else [seed * worlds + b
                                       for b in range(worlds)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tallies(st) -> dict:
    """The program's counts the window reads (a host readback, which
    waits for the device): messages pending in mailboxes, delivered,
    overflowed, dropped by the route cap, supersteps of world 0."""
    v = torch.stack([(st.mb_rel < I32MAX).sum(), st.delivered.sum(),
                     st.overflow.sum().long(), st.route_drop.sum().long(),
                     st.steps.reshape(-1)[0], st.time.reshape(-1)[0]]
                    ).tolist()
    return dict(zip(("pending", "delivered", "overflow", "route_drop",
                     "steps", "time"), v))


def routed(a: dict, b: dict) -> int:
    """Messages routed between two tallies: landed, overflowed or
    dropped by the cap."""
    return (b["pending"] - a["pending"] + b["delivered"] - a["delivered"]
            + b["overflow"] - a["overflow"] + b["route_drop"]
            - a["route_drop"])


#: 0x9E3779B97F4A7C15 as a signed 64-bit word
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)


def leaf_digests(st: dict) -> dict:
    """Per world and leaf, a 64-bit wrapping sum of each element's value
    mixed with its position (a changed, moved or lost element changes
    it): ``{leaf: [B] int64 tensor}``."""
    out = {}
    for k, v in st.items():
        x = v.reshape(v.shape[0], -1).to(torch.int64)
        pos = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
        h = (x + 1) * _MIX ^ (pos * 0x632BE59BD9B4E019 + 0x85EBCA77)
        h = h ^ (h >> 29)
        out[k] = (h * _MIX).sum(dim=1)
    return out


def digest_diff(a: dict, b: dict, worlds=None) -> int:
    """Leaves (per world) whose digests differ; ``worlds`` selects the
    worlds of ``a`` that ``b`` holds, in order."""
    bad = 0
    for k in b:
        x = a[k] if worlds is None else a[k][worlds]
        bad += int((x.cpu() != b[k].cpu()).sum())
    return bad + len(set(b) ^ set(a))


def element_diff(prog: dict, ref: dict) -> tuple:
    """Elements of the program's state that differ from the reference's,
    and the leaves they lie in (a leaf of another shape or dtype counts
    whole)."""
    bad, where = 0, []
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or p.shape != r.shape or p.dtype != r.dtype:
            d = r.numel()
        else:
            d = int((p != r).sum())
        if d:
            bad += d
            where.append(k)
    return bad, where


class Spans:
    """The benchmark's own spans around its calls into the program."""

    def __init__(self, device) -> None:
        self.device, self.s = device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.s[name] = time.perf_counter() - t0


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = None, t_start: float = None,
             pre_spans: dict = None, control: bool = False) -> dict:
    """One run of ``workload``: the result line, ``checks`` (each
    compared number with its limit) last. ``t_start`` is the process's
    start on ``time.perf_counter``'s clock, ``pre_spans`` the caller's
    spans before this call (logged with set-up's); ``control`` puts the
    lower-precision reference in the program's place (``control.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root or Path(__file__).resolve().parent.parent)
    cell = bench.cell(workload)
    config, traffic = cell.config, cell.traffic
    worlds = int(traffic["worlds"])
    seeds = world_seeds(seed, worlds)
    chunk = int(traffic["chunk_supersteps"])
    spans = Spans(device)
    spans.s.update(pre_spans or {})
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # -- set-up: only this cell's engine and shapes
    with spans("import_program"):
        system.import_program()
    with spans("kernels"):
        system.build_kernels(device)
    with spans("construct"):
        eng = system.build_engine(config, seeds, device)
    with spans("init_state"):
        st = eng.init_state()
        init_digest = leaf_digests(system.state_dict(st, worlds))
    with spans("warm"):
        st = eng.run_quiet(int(traffic["warm_supersteps"]), st)
        warm_digest = leaf_digests(system.state_dict(st, worlds))
        before = tallies(st)
    setup_s = time.perf_counter() - t_start

    # -- the window: chunks back to back until `seconds` have passed; the
    #    traced run profiles `trace_chunks` of them from its second chunk,
    #    then one more with the host's operations for the idle gaps
    t_chunks = int(traffic["trace_chunks"])
    plan = {1: "start", 1 + t_chunks: "stop", 2 + t_chunks: "gaps_stop"} \
        if trace else {}
    prof = sliced = None
    done, prev, chunk_s = 0, st, []
    t0 = time.perf_counter()
    while True:
        step = plan.get(done)
        if step == "start":
            sync(device)
            slice_before = tallies(st)
            prof = tr.start(with_host_ops=False)
            ts = time.perf_counter()
        elif step == "stop":
            sync(device)
            slice_s = time.perf_counter() - ts
            prof.stop()
            sliced = dict(prof=prof, window_s=slice_s, before=slice_before,
                          after=tallies(st))
            prof = tr.start(with_host_ops=True)
        tc = time.perf_counter()
        prev, st = st, eng.run_quiet(chunk, st)
        chunk_s.append(time.perf_counter() - tc)
        done += 1
        if plan.get(done) == "gaps_stop":
            sync(device)
            prof.stop()
            sliced["gaps_prof"] = prof
        if time.perf_counter() - t0 >= seconds and done >= max(plan,
                                                               default=0):
            break
    after = tallies(st)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # the compared chunk: the window's last, or past the window's close
    # the first later chunk that changes the mix's `check_changes` leaf
    prev, st, extra = chunk_to_check(eng, traffic, worlds, prev, st)

    delivered = after["delivered"] - before["delivered"]
    overflow = after["overflow"] - before["overflow"]
    dropped = after["route_drop"] - before["route_drop"]
    result_metrics = {}
    if not trace:
        values = {"msgs_per_s": delivered / window_s, "setup_s": setup_s}
        if peak is not None:
            values["peak_mem_gib"] = peak / GIB
        for m in cell.end_to_end:
            if m["name"] in values:
                result_metrics[m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        ctx = _trace_context(bench, cell, sliced, spans.s)
        dev["busy_s"], dev["window_s"] = ctx.busy_s, ctx.window_s
        for m in cell.per_layer:
            v = bench.metric_reader(m["name"]).read(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_ops(ctx.ops),
                     "idle_gaps": tr.idle_gaps(ctx.gap_ops, ctx.gap_host)}
        del ctx, sliced

    # -- the check, once the window has closed and the peak is read
    del eng
    t_check = time.perf_counter()
    checks = check(config, traffic, seeds, device, init_digest,
                   warm_digest, prev, st, seed, control)
    if "check_changes" in traffic:
        checks["unchanged_leaf"] = (int(extra < 0), 0)
    log(f"check: {time.perf_counter() - t_check} s")
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": int(routed(before, after)),
            "failed": int(overflow + dropped),
            "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    log(f"set-up split, s: {json.dumps(spans.s)}; window: {window_s} s, "
        f"{done} chunks, {after['steps'] - before['steps']} supersteps, "
        f"{delivered} delivered, {overflow} overflowed; ms a superstep by "
        f"chunk, quartiles: {chunk_quartiles(chunk_s, chunk)}; virtual "
        f"µs: {after['time'] - before['time']}; chunks run past the close "
        f"for the check: {extra}")
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def chunk_to_check(eng, traffic, worlds, prev, st):
    """The chunk the check compares, as (its start, its end, the chunks
    run past the window's close for it). Where the mix names a leaf
    under ``check_changes`` (Praos: ``states.slot``, so that the chunk
    holds a slot boundary, its leadership draw and its slot update), the
    chunk is the window's last if that changes the leaf in some world,
    else the first later one of the same engine and length that does,
    within ``check_max_chunks``; -1 chunks where none did."""
    leaf = traffic.get("check_changes")
    if leaf is None:
        return prev, st, 0
    chunk = int(traffic["chunk_supersteps"])

    def changes(a, b):
        return bool((system.state_dict(a, worlds)[leaf]
                     != system.state_dict(b, worlds)[leaf]).any())
    extra = 0
    while not changes(prev, st):
        if extra == int(traffic["check_max_chunks"]):
            return prev, st, -1
        prev, st = st, eng.run_quiet(chunk, st)
        extra += 1
    return prev, st, extra


def chunk_quartiles(walls: list, chunk: int) -> list:
    """Min, quartiles and max of the chunks' host ms a superstep (each
    chunk's wall ends at its last superstep's pop-min, a host sync)."""
    ms = sorted(w * 1e3 / chunk for w in walls)
    if len(ms) < 2:
        return ms
    return [ms[0], *statistics.quantiles(ms, n=4), ms[-1]]


def _trace_context(bench, cell, sliced, spans) -> SimpleNamespace:
    ops = tr.device_ops(sliced["prof"])
    if not ops:
        raise RuntimeError("the profiler returned no device operation for "
                           "the traced slice")
    busy = tr.busy_intervals(ops)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gap_ops = tr.device_ops(sliced["gaps_prof"])
    a, b = sliced["before"], sliced["after"]
    model = reference_model(cell.config)
    ctx = SimpleNamespace(
        ops=ops, busy_s=busy_s, window_s=sliced["window_s"],
        gap_ops=gap_ops, gap_host=tr.host_ops(sliced["gaps_prof"]),
        supersteps=b["steps"] - a["steps"], routed=routed(a, b),
        landed=b["pending"] - a["pending"] + b["delivered"] - a["delivered"],
        spans=spans, config=cell.config, traffic=cell.traffic,
        P=model.P, M=model.M, K=model.K,
        hbm_bytes_per_s=HBM_BYTES_PER_S)
    ctx.roofline = bench.roofline
    ctx.roofline_share = lambda kernel: roofline_share(ctx, kernel)
    ctx.kernel_us = lambda pat: sum(e - s for n, s, e in ops if pat in n)
    return ctx


def roofline_share(ctx, kernel: str):
    """The kernel's roofline share in % over the traced slice: the least
    time its bytes need at the HBM's rate over the time the trace shows
    it running; None where it did not run."""
    rf = ctx.roofline(kernel)
    us = ctx.kernel_us(rf.KERNEL)
    if us <= 0:
        return None
    need = rf.bytes_needed(ctx.routed, ctx.landed, ctx.P)
    return 100.0 * need / ctx.hbm_bytes_per_s / (us * 1e-6)


def check(config, traffic, seeds, device, init_digest, warm_digest,
          prev, st, seed, control):
    """The numbers compared, each with its limit: leaves (per world) of
    the initial state and of the state after warm-up whose digests
    differ from the reference's own run from its own initial state, and
    elements of the window's last chunk, followed by the reference from
    the program's state at that chunk's start, that differ from the
    program's. Every comparison is exact: the limit is 0."""
    worlds = len(seeds)
    model = reference_model(config)
    chunk = int(traffic["chunk_supersteps"])
    warm = int(traffic["warm_supersteps"])
    rng = random.Random(seed)
    sample = sorted(rng.sample(range(worlds), min(
        worlds, int(traffic.get("warm_check_worlds", worlds)))))
    prog_prev = system.state_dict(prev, worlds)
    prog_last = system.state_dict(st, worlds)
    low = dict(config["control"]) if control else {}
    kw = {}
    if low:
        kw = {"rounds": int(low["rounds"]),
              "float_dtype": getattr(torch, low["float_dtype"])}

    def ref(ws, **k):
        return ref_engine.RefEngine(model, config["link"], config["window"],
                                    ws, device, **k)
    with torch.no_grad():
        r = ref(seeds)
        init_diff = digest_diff(init_digest, leaf_digests(r.init_state()))
        rw = ref([seeds[b] for b in sample])
        ref_warm = leaf_digests(rw.run(rw.init_state(), warm))
        if low:
            # the control in the program's place: its own warm-up
            cw = ref([seeds[b] for b in sample], **kw)
            warm_diff = digest_diff(
                leaf_digests(cw.run(cw.init_state(), warm)), ref_warm)
        else:
            warm_diff = digest_diff(warm_digest, ref_warm, sample)
        r_last = r.run(prog_prev, chunk)
        if low:
            # the control in the program's place: its chunk against the
            # reference's
            got = ref(seeds, **kw).run(prog_prev, chunk)
        else:
            got = prog_last
        window_diff, where = element_diff(got, r_last)
    if window_diff:
        log(f"check: the window's last chunk differs in {where}")
    return {"init_diff": (init_diff, 0), "warm_diff": (warm_diff, 0),
            "window_diff": (window_diff, 0)}
