"""Runnable ping-pong example on the port (the twin of
``examples/ping_pong.py``): two nodes over the full dialog/transport
stack, emulated by default. A host program: no device work.

    python examples/torch/ping_pong.py            # deterministic emulation
    python examples/torch/ping_pong.py --real     # wall-clock + real TCP
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from timewarp_tpu_torch.interp.aio.timed import run_real_time  # noqa: E402
from timewarp_tpu_torch.interp.ref.des import run_emulation  # noqa: E402
from timewarp_tpu_torch.models.ping_pong_net import ping_pong_net  # noqa: E402
from timewarp_tpu_torch.net.backend import (AioBackend,  # noqa: E402
                                            EmulatedBackend)
from timewarp_tpu_torch.net.delays import UniformDelay  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if a.real:
        times = run_real_time(ping_pong_net(
            AioBackend(), pong_host="127.0.0.1", warmup_us=50_000))
    else:
        net = EmulatedBackend(UniformDelay(1_000, 5_000), seed=a.seed)
        times = run_emulation(ping_pong_net(net))
    for what, t in sorted(times.items(), key=lambda kv: kv[1]):
        print(f"{t:>10} µs  {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
