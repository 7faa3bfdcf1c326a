"""Runnable token-ring example on the port (the twin of
``examples/token_ring.py``): N nodes pass an incrementing token via RPC
call/serve with an observer checking monotonic progress — one
``--no-emulation`` flag flips the interpreter. ``--engine`` runs the
batched form on ``TorchEngine`` instead, on the card unless
``--device cpu``.

    python examples/torch/token_ring.py                  # emulated (instant)
    python examples/torch/token_ring.py --no-emulation   # wall-clock asyncio
    python examples/torch/token_ring.py --engine         # TorchEngine, the card
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--no-emulation", action="store_true",
                   help="real wall-clock mode (scaled-down timings)")
    p.add_argument("--engine", action="store_true",
                   help="run the batched-engine form instead (token_ring "
                        "state-machine scenario on TorchEngine)")
    p.add_argument("--nodes", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the engine's device with --engine (default: the "
                        "card)")
    a = p.parse_args(argv)

    if a.engine:
        from timewarp_tpu_torch.cli import require_device
        from timewarp_tpu_torch.interp.torch_engine.engine import \
            TorchEngine
        from timewarp_tpu_torch.models.token_ring import (token_ring,
                                                          token_ring_links)
        dev = require_device(a.device)
        print(f"device: {dev}", file=sys.stderr)
        sc = token_ring(a.nodes, think_us=30_000, bootstrap_us=10_000,
                        end_us=500_000, with_observer=True)
        final, trace = TorchEngine(sc, token_ring_links(a.nodes),
                                   seed=a.seed, device=dev).run(2000)
        print(f"{len(trace)} supersteps, {trace.total_delivered()} "
              f"messages delivered, virtual end t={int(final.time)} µs")
        return 0

    from timewarp_tpu_torch.interp.aio.timed import run_real_time
    from timewarp_tpu_torch.interp.ref.des import run_emulation
    from timewarp_tpu_torch.models.token_ring_net import (token_ring_delays,
                                                          token_ring_net)
    from timewarp_tpu_torch.net.backend import EmulatedBackend
    from timewarp_tpu_torch.net.delays import FixedDelay

    # scaled-down timings so the wall-clock mode finishes in ~2 s
    net = EmulatedBackend(token_ring_delays(),
                          connect_delays=FixedDelay(1), seed=a.seed)
    prog = token_ring_net(
        net, a.nodes, duration_us=2_000_000, passing_delay_us=300_000,
        bootstrap_us=100_000, check_period_us=500_000,
        allowed_progress_delay_us=1_000_000)
    run = run_real_time if a.no_emulation else run_emulation
    notes, errors = run(prog)
    for t, v in notes:
        print(f"{t:>10} µs  observer noted token value {v}")
    print("errors:", errors or "none")
    return 0


if __name__ == "__main__":
    sys.exit(main())
