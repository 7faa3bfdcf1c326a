"""Runnable socket-state example on the port (the twin of
``examples/socket_state.py``): a server counting requests per client
socket via per-socket user state; roulette clients; optional nastiness.
A host program: no device work.

    python examples/torch/socket_state.py
    python examples/torch/socket_state.py --drop 0.05   # injected resets
    python examples/torch/socket_state.py --real
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from timewarp_tpu_torch.interp.aio.timed import run_real_time  # noqa: E402
from timewarp_tpu_torch.interp.ref.des import run_emulation  # noqa: E402
from timewarp_tpu_torch.models.socket_state_net import \
    socket_state_net  # noqa: E402
from timewarp_tpu_torch.net.backend import (AioBackend,  # noqa: E402
                                            EmulatedBackend)
from timewarp_tpu_torch.net.delays import UniformDelay, WithDrop  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true")
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=6)
    a = p.parse_args(argv)
    if a.real and a.drop:
        p.error("--drop injects loss into the emulated fabric; "
                "it cannot apply to real TCP (drop --real or --drop)")
    if a.real:
        res = run_real_time(socket_state_net(
            AioBackend(), server_host="127.0.0.1", server_port=34441,
            send_interval_us=20_000, server_life_us=300_000,
            seed=a.seed))
    else:
        link = UniformDelay(1_000, 8_000)
        if a.drop:
            link = WithDrop(link, a.drop)
        res = run_emulation(socket_state_net(
            EmulatedBackend(link, seed=a.seed), seed=a.seed))
    for reqno, cid, t in res["log"]:
        print(f"{t:>10} µs  Ping #{reqno} on its socket, from client {cid}")
    print("per-socket totals:", res["per_socket"],
          "client sends:", res["client_sends"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
