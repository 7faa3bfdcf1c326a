"""The cross-world law on the port, runnable (the twin of
``examples/cross_world.py``): ONE random network, TWO worlds.

The same gossip epidemic executes as (a) a generator program over the
full network stack — per-node threads, typed dialogs, lively sockets,
the emulated byte fabric, the pure DES — and (b) a batched scenario on
the host oracle (on the CPU) and ``TorchEngine`` (on the card unless
``--device cpu``). Both draw link delays from one seeded
(destination, time)-keyed model (``SeededHashUniform``), and the
delivered-rumor timeline must match to the microsecond. Exits 1 if the
worlds diverge.

    python examples/torch/cross_world.py [--nodes 20] [--salt 7]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from timewarp_tpu_torch.cli import require_device  # noqa: E402
from timewarp_tpu_torch.interp.ref.des import run_emulation  # noqa: E402
from timewarp_tpu_torch.interp.ref.superstep import \
    SuperstepOracle  # noqa: E402
from timewarp_tpu_torch.interp.torch_engine.engine import \
    TorchEngine  # noqa: E402
from timewarp_tpu_torch.models.gossip import gossip  # noqa: E402
from timewarp_tpu_torch.models.gossip_net import (  # noqa: E402
    gossip_net, gossip_net_ports)
from timewarp_tpu_torch.net.backend import EmulatedBackend  # noqa: E402
from timewarp_tpu_torch.net.delays import (  # noqa: E402
    FixedDelay, SeededHashUniform)
from timewarp_tpu_torch.trace.events import \
    assert_traces_equal  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--salt", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the engine's device (default: the card)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    print(f"device: {dev}", file=sys.stderr)
    n, dur = args.nodes, 800_000
    link = SeededHashUniform(3_000, 9_000, args.salt)

    # world A: the generator-program network stack under the DES
    receipts = []
    backend = EmulatedBackend(link, connect_delays=FixedDelay(500),
                              seed=0, endpoint_ids=gossip_net_ports(n))
    run_emulation(gossip_net(backend, n, fanout=4, think_us=900,
                             bootstrap_us=100_000, duration_us=dur,
                             receipts=receipts))
    net = sorted((t, i) for t, i in receipts if t < dur)

    # world B: the batched twin on the oracle + TorchEngine
    sc = gossip(n, fanout=4, think_us=900, burst=True,
                bootstrap_us=100_000, end_us=dur, mailbox_cap=16)
    oracle = SuperstepOracle(sc, link, record_events=True, device="cpu")
    otrace = oracle.run(5_000)
    bat = sorted((e[4], e[2]) for e in oracle.events
                 if e[0] == "recv" and e[4] < dur)
    _, etrace = TorchEngine(sc, link, device=dev).run(5_000)
    assert_traces_equal(otrace, etrace)

    print(f"net-stack world : {len(net)} rumors delivered")
    print(f"batched world   : {len(bat)} rumors delivered "
          f"(oracle ≡ engine trace)")
    if net == bat:
        print("CROSS-WORLD LAW HOLDS: every (time µs, node) identical")
        for t, i in net[:5]:
            print(f"  t={t:>7} µs  node {i}")
        print(f"  ... ({len(net) - 5} more, all equal)")
        return 0
    print("DIVERGED — first difference:")
    for a, b in zip(net, bat):
        if a != b:
            print(f"  net {a}  vs  batched {b}")
            break
    return 1


if __name__ == "__main__":
    sys.exit(main())
