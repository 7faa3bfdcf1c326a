"""The trace's reduction and the per-layer readers on a hand-made
device trace (the CPU has none of its own)."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark import trace as tr

# (name, start µs, end µs): two overlapping kernels, a copy, a gap, a
# sort, a searchsorted, K1
OPS = [("elementwise_kernel<add>", 0.0, 10.0),
       ("elementwise_kernel<xor>", 5.0, 20.0),
       ("Memcpy DtoH (Device -> Pinned)", 20.0, 22.0),
       ("DeviceRadixSortOnesweepKernel<long>", 30.0, 40.0),
       ("searchsorted_cuda_kernel", 40.0, 41.0),
       ("mailbox_insert_kernel(int const*)", 50.0, 60.0)]
HOST = [("aten::sort", 21.0, 31.0), ("aten::empty", 23.0, 24.0),
        ("aten::add", 42.0, 43.0)]


def test_busy_top_and_gaps():
    assert tr.busy_intervals(OPS) == [[0.0, 22.0], [30.0, 41.0],
                                      [50.0, 60.0]]
    assert tr.top_ops(OPS, k=2) == [["elementwise_kernel<xor>",
                                     pytest.approx(15e-6)],
                                    ["elementwise_kernel<add>",
                                     pytest.approx(10e-6)]]
    # gap 22-30 (middle 26: inside aten::sort, aten::empty has ended),
    # gap 41-50 (middle 45.5: no op runs)
    assert tr.idle_gaps(OPS, HOST) == [["host in python", pytest.approx(9e-6)],
                                       ["host in aten::sort",
                                        pytest.approx(8e-6)]]


def ctx_for(root, **kw):
    bench = harness.Bench(root)
    ctx = SimpleNamespace(ops=OPS, busy_s=43e-6, window_s=100e-6,
                          supersteps=2, routed=10, landed=8, P=1, M=1, K=8,
                          spans={"construct": 1.5},
                          hbm_bytes_per_s=harness.HBM_BYTES_PER_S, **kw)
    ctx.roofline = bench.roofline
    ctx.kernel_us = lambda pat: sum(e - s for n, s, e in OPS if pat in n)
    ctx.roofline_share = lambda k: harness.roofline_share(ctx, k)
    return bench, ctx


def test_readers_by_hand(small_root):
    bench, ctx = ctx_for(small_root)

    def read(name):
        return bench.metric_reader(name).read(ctx)
    assert read("construct_s") == 1.5
    assert read("launches_per_step") == 5 / 2          # the copy left out
    assert read("sort_ms_per_step") == pytest.approx(10e-3 / 2)
    assert read("idle_share") == pytest.approx(57.0)
    assert read("device_ms_per_step") == pytest.approx(43e-3 / 2)
    # K1: 10 entries of 8 bytes read, 8 slots of 8 bytes read and written
    need = 10 * 8 + 2 * 8 * 8
    assert read("k1_roofline") == pytest.approx(
        100 * need / harness.HBM_BYTES_PER_S / 10e-6)
    assert read("k3_roofline") is None                  # K3 did not run
