"""Bench launcher + CLI — ≙ time-warp's `bench/launch.sh` plus the
option surface of SenderOptions.hs / ReceiverOptions.hs /
LogReaderOptions.hs: run receiver + sender for a duration (emulated
fabric by default — deterministic; ``--real`` for kernel TCP loopback),
capture each node's measure log, join the 4-point timelines, write
``measures.csv``.

Usage::

    python -m timewarp_tpu_torch.bench_net.launch --msgs 1000 --threads 5 \
        --duration 10 --payload-bound 64 --out measures.csv
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List

from ..core.effects import Program, fork_, modify_log_name
from ..utils.logconfig import configure_logging
from .log_reader import join_measures, summarize, write_csv
from .receiver import receiver
from .sender import sender

__all__ = ["launch", "main"]


class _ListHandler(logging.Handler):
    def __init__(self) -> None:
        super().__init__()
        self.lines: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(record.getMessage())


def launch(*, msgs: int = 1000, threads: int = 5, rate: int = 0,
           duration_s: int = 10, payload_bound: int = 0,
           port: int = 3456, no_pong: bool = False, real: bool = False,
           delay_us: int = 1000, seed: int = 0,
           logs_dir: str = None) -> dict:
    """Run the two-node bench once; returns the joined measure table.
    Emulated runs complete in wall-clock milliseconds regardless of the
    virtual ``duration_s`` (the whole point of the emulator)."""
    from ..manage.sync import Flag

    send_log = logging.getLogger("bench.sender")
    recv_log = logging.getLogger("bench.receiver")
    # ≙ defaultLogConfig: measure streams at Info, comm muted to Error
    # (levels restored below — launch must not permanently reconfigure
    # the host process's logging)
    prior_levels = {name: logging.getLogger(name).level
                    for name in ("bench", "timewarp.comm")}
    configure_logging({
        "bench": {"severity": "Info"},
        "timewarp": {"comm": {"severity": "Error"}},
    })
    sh, rh = _ListHandler(), _ListHandler()
    send_log.addHandler(sh)
    recv_log.addHandler(rh)
    try:
        duration_us = duration_s * 1_000_000
        if real:
            from ..interp.aio.timed import run_real_time
            from ..net.backend import AioBackend
            host = "127.0.0.1"
            backend = AioBackend()
            run = run_real_time
        else:
            from ..interp.ref.des import run_emulation
            from ..net.backend import EmulatedBackend
            from ..net.delays import FixedDelay
            host = "receiver-host"
            backend = EmulatedBackend(FixedDelay(delay_us), seed=seed)
            run = run_emulation

        recv_ready = Flag()
        recv_prog = receiver(backend, port=port, host=host,
                             duration_us=duration_us + 2_000_000,
                             no_pong=no_pong, ready=recv_ready,
                             logger=recv_log)
        send_prog = sender(backend, [(host, port)], threads=threads,
                           msg_num=msgs, msg_rate=rate or None,
                           duration_us=duration_us,
                           payload_bound=payload_bound, seed=seed,
                           logger=send_log)

        recv_done, send_done = Flag(), Flag()

        def wrap(prog, flag):
            def w() -> Program:
                yield from prog()
                yield from flag.set()
            return w

        def main_prog() -> Program:
            # the realtime interpreter ends the run when the main
            # program returns — block until both nodes finish; the
            # sender starts only once the receiver is bound
            # (≙ launch.sh starting the receiver first, launch.sh:3-5)
            yield from fork_(lambda: modify_log_name(
                "receiver", wrap(recv_prog, recv_done)))
            yield from recv_ready.wait()
            yield from fork_(lambda: modify_log_name(
                "sender", wrap(send_prog, send_done)))
            yield from send_done.wait()
            yield from recv_done.wait()

        run(main_prog)
    finally:
        send_log.removeHandler(sh)
        recv_log.removeHandler(rh)
        for name, level in prior_levels.items():
            logging.getLogger(name).setLevel(level)

    if logs_dir:
        os.makedirs(logs_dir, exist_ok=True)
        for name, h in (("sender.log", sh), ("receiver.log", rh)):
            with open(os.path.join(logs_dir, name), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(h.lines) + "\n")
    return join_measures(sh.lines, rh.lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="time-warp network bench (≙ bench/launch.sh)")
    # ≙ SenderOptions.hs:20-99 / ReceiverOptions.hs:26-60
    p.add_argument("--msgs", type=int, default=1000,
                   help="messages per thread set (default 1000)")
    p.add_argument("--threads", type=int, default=5,
                   help="concurrent sender threads (default 5)")
    p.add_argument("--rate", type=int, default=0,
                   help="messages/sec/thread (0 = unthrottled)")
    p.add_argument("--duration", type=int, default=10,
                   help="virtual seconds to run (default 10)")
    p.add_argument("--payload-bound", type=int, default=0,
                   help="max payload bytes (uniform 0..bound)")
    p.add_argument("--port", type=int, default=3456)
    p.add_argument("--no-pong", action="store_true",
                   help="receiver does not reply (≙ --no-pong)")
    p.add_argument("--real", action="store_true",
                   help="kernel TCP loopback instead of the emulator")
    p.add_argument("--delay-us", type=int, default=1000,
                   help="emulated link latency µs (default 1000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logs-dir", default=None,
                   help="also write raw sender.log / receiver.log here")
    p.add_argument("--out", default="measures.csv")
    p.add_argument("--stats", action="store_true",
                   help="also print an RTT/throughput summary JSON line")
    a = p.parse_args(argv)

    table = launch(
        msgs=a.msgs, threads=a.threads, rate=a.rate,
        duration_s=a.duration, payload_bound=a.payload_bound,
        port=a.port, no_pong=a.no_pong, real=a.real,
        delay_us=a.delay_us, seed=a.seed, logs_dir=a.logs_dir)
    n = write_csv(table, a.out)
    complete = sum(1 for k, v in table.items()
                   if isinstance(k, int) and len(v) == 5)
    print(f"{a.out}: {n} message timelines ({complete} complete)")
    if a.stats:
        import json as _json
        print(_json.dumps(summarize(table)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
