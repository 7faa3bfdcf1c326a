"""Reading a ``torch.profiler`` trace of a slice of the window: the
device's operations, the time it was busy (the union of their
intervals), the operations that took most time, and the idle gaps named
by what the host was doing in them."""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

#: the length of a name in ``breakdown``
NAME_CHARS = 120


def start(with_host_ops: bool):
    """A running profiler of the device's activity (and, with
    ``with_host_ops``, of the host's torch operations)."""
    acts = [ProfilerActivity.CUDA]
    if with_host_ops:
        acts.append(ProfilerActivity.CPU)
    prof = profile(activities=acts)
    prof.start()
    return prof


def device_ops(prof) -> list:
    """``(name, start_us, end_us)`` of every operation the device ran
    (kernels, copies, fills), in start order."""
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == cuda]
    return sorted(ops, key=lambda o: o[1])


def host_ops(prof) -> list:
    """``(name, start_us, end_us)`` of the torch operations of the
    thread that issued most of them."""
    cpu = torch.autograd.DeviceType.CPU
    evs = [e for e in prof.events() if e.device_type == cpu]
    if not evs:
        return []
    main = Counter(e.thread for e in evs).most_common(1)[0][0]
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in evs if e.thread == main), key=lambda o: o[1])


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, as sorted disjoint
    ``[start_us, end_us]`` pairs."""
    merged = []
    for _, s, e in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def top_ops(ops, k: int = 10) -> list:
    """The ``k`` operation names that took most device time:
    ``[[name, seconds], ...]``."""
    total = defaultdict(float)
    for name, s, e in ops:
        total[name[:NAME_CHARS]] += (e - s) * 1e-6
    return [[n, v] for n, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(ops, host, k: int = 10) -> list:
    """The device's idle gaps between its first and last operation,
    summed by the innermost host operation running at each gap's middle
    (``python`` where none runs): ``[[name, seconds], ...]``, the ``k``
    largest."""
    busy = busy_intervals(ops)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    starts = [h[1] for h in host]
    total = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        name = "python"
        # the innermost op covering mid has the latest start among those
        # that cover it; ops nest, so walk back until one covers mid
        i = bisect.bisect_right(starts, mid) - 1
        depth = 0
        while i >= 0 and depth < 64:
            hname, hs, he = host[i]
            if he >= mid:
                name = hname
                break
            i -= 1
            depth += 1
        total["host in " + name[:NAME_CHARS]] += (g1 - g0) * 1e-6
    return [[n, v] for n, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:k]]
