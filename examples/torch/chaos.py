"""Runnable chaos example on the port (the twin of ``examples/chaos.py``):
a token ring surviving a partition heal.

A 12-node ring with 6 circulating tokens is cut in half for a window of
virtual time (cross-cut hops are lost and counted), one node is
crash/rebooted with state loss, and the schedule heals well before the
deadline — then the ring keeps circulating the surviving tokens. The
whole thing runs under both interpreters (the oracle on the CPU,
``TorchEngine`` on the card unless ``--device cpu``) and the traces are
compared bit-for-bit: chaos stays inside the parity law
(docs/faults.md).

    python examples/torch/chaos.py
    python examples/torch/chaos.py --nodes 16 --seed 3 --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the engine's device (default: the card)")
    a = p.parse_args(argv)

    from timewarp_tpu_torch.cli import require_device
    from timewarp_tpu_torch.faults import (FaultSchedule, NodeCrash,
                                           Partition, eventually_delivered)
    from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.net.delays import UniformDelay
    from timewarp_tpu_torch.trace.events import assert_traces_equal

    dev = require_device(a.device)
    print(f"device: {dev}", file=sys.stderr)
    n = a.nodes
    half = n // 2
    sc = token_ring(n, n_tokens=6, think_us=4_000, bootstrap_us=1_000,
                    end_us=600_000, with_observer=False, mailbox_cap=8)
    link = UniformDelay(1_000, 5_000)
    heal_us = 110_000
    sched = FaultSchedule((
        # cut the ring in half for 80-110 ms: hops crossing the cut
        # (there are exactly two such edges) are lost while it is
        # live — brief enough that some tokens survive the window
        Partition((tuple(range(half)), tuple(range(half, n))),
                  80_000, heal_us),
        # and reboot one node mid-run with state loss
        NodeCrash(half - 1, 100_000, 140_000, reset_state=True),
    ))

    oracle = SuperstepOracle(sc, link, seed=a.seed, faults=sched,
                             device="cpu")
    otrace = oracle.run(5000)
    engine = TorchEngine(sc, link, seed=a.seed, faults=sched, device=dev)
    final, etrace = engine.run(2000)
    assert_traces_equal(otrace, etrace)

    assert eventually_delivered(etrace, heal_us), \
        "ring did not keep circulating after the heal"
    print(f"{len(etrace)} supersteps, "
          f"{etrace.total_delivered()} tokens delivered, "
          f"{int(final.fault_dropped)} messages lost to the schedule "
          f"(cut hops + reboot purges), virtual end "
          f"t={int(final.time)} µs")
    print("oracle == engine bit-for-bit; the ring survived the "
          "partition heal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
