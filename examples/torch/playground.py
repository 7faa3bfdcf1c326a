"""Runnable network playground on the port (the twin of
``examples/playground.py``, itself after the reference's
``examples/playground/Main.hs:108-376``): exploratory scenarios for the
transport/dialog stack, each runnable in deterministic emulation in
milliseconds of wall-clock. A host program: no device work.

    python examples/torch/playground.py                      # run them all
    python examples/torch/playground.py --scenario proxy
    python examples/torch/playground.py --scenario slowpoke --seed 3

Scenarios (reference counterpart in parentheses):

- ``yohoho``  — a server replying on the inbound connection
  (yohohoScenario, Main.hs:108-154)
- ``proxy``   — a middle node routing by header only, re-sending raw
  bytes without parsing content (proxyScenario, Main.hs:238-287)
- ``slowpoke`` — a client whose server comes up late; the lively
  socket's reconnect policy keeps retrying until it lands
  (slowpokeScenario, Main.hs:290-317)
- ``cycles``  — bind/serve/stop/re-bind the same port repeatedly;
  each server generation sees only its own traffic
  (closingServerScenario, Main.hs:320-343)
- ``forks``   — per-message-name fork strategy: inline handlers
  serialize, forked handlers overlap (pendingForkStrategy,
  Main.hs:345-376)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from timewarp_tpu_torch.core.effects import (  # noqa: E402
    GetTime, Program, Wait, fork_)
from timewarp_tpu_torch.interp.ref.des import run_emulation  # noqa: E402
from timewarp_tpu_torch.net.backend import EmulatedBackend  # noqa: E402
from timewarp_tpu_torch.net.delays import FixedDelay, UniformDelay  # noqa: E402
from timewarp_tpu_torch.net.dialog import (  # noqa: E402
    Dialog, Listener, fork_each_message, run_inline)
from timewarp_tpu_torch.net.message import message  # noqa: E402
from timewarp_tpu_torch.net.transfer import (  # noqa: E402
    AtConnTo, AtPort, Settings, Transport)


@message
class Yohoho:
    """≙ the playground's rum-themed ping (Main.hs:97-106)."""
    bottles: int


@message
class EpicRequest:
    """≙ EpicRequest (Main.hs:98-106)."""
    num: int
    msg: str


def yohoho(seed: int) -> None:
    """Server replies on the inbound connection; two clients each get
    their own answers back."""
    net = EmulatedBackend(UniformDelay(1_000, 5_000), seed=seed)
    srv = Dialog(Transport(net))
    log = []

    def on_yohoho(msg, ctx) -> Program:
        t = yield GetTime()
        log.append((t, f"server: {msg.bottles} bottles from "
                       f"{ctx.peer_addr}"))
        yield from ctx.reply(EpicRequest(msg.bottles + 1, "yo-ho-ho"))

    def client(name: str, bottles: int):
        d = Dialog(Transport(net, host=name))

        def on_reply(msg, ctx) -> Program:
            t = yield GetTime()
            log.append((t, f"{name}: got {msg.num} '{msg.msg}'"))

        def run() -> Program:
            addr = ("127.0.0.1", 4100)
            yield from d.listen(AtConnTo(addr),
                                [Listener(EpicRequest, on_reply)])
            yield from d.send(addr, Yohoho(bottles))
        return d, run

    def main() -> Program:
        stop = yield from srv.listen(AtPort(4100),
                                     [Listener(Yohoho, on_yohoho)])
        d1, c1 = client("pirate-a", 15)
        d2, c2 = client("pirate-b", 99)
        yield from c1()
        yield from c2()
        yield Wait(60_000)
        for d in (d1, d2):
            yield from d.transport.close_all()
        yield from stop()

    run_emulation(main)
    for t, line in sorted(log):
        print(f"  {t:>8} µs  {line}")


def proxy(seed: int) -> None:
    """Header-routed raw forwarding: the proxy never parses content."""
    net = EmulatedBackend(FixedDelay(1_000), seed=seed)
    proxy_d = Dialog(Transport(net, host="proxy"))
    dst_d = Dialog(Transport(net, host="dest"))
    cli_d = Dialog(Transport(net, host="client"))
    dst_addr = ("dest", 4300)

    def proxy_raw(hr, ctx) -> Program:
        header, raw = hr
        name = proxy_d.packing.extract_name(raw)
        print(f"  proxy: routing header={header} name={name} "
              "(content never parsed)")
        yield from proxy_d.send_r(dst_addr, header, raw)
        return False  # gate: no local typed dispatch

    def on_arrival(msg, ctx) -> Program:
        t = yield GetTime()
        print(f"  dest @{t} µs: {msg}")

    def main() -> Program:
        stop_p = yield from proxy_d.listen(AtPort(4200), [], proxy_raw)
        stop_d = yield from dst_d.listen(
            AtPort(4300), [Listener(EpicRequest, on_arrival)])
        yield from cli_d.send_h(("proxy", 4200), ("route", 1),
                                EpicRequest(5, "via proxy"))
        yield from cli_d.send_h(("proxy", 4200), ("route", 2),
                                EpicRequest(6, "also via proxy"))
        yield Wait(50_000)
        yield from cli_d.transport.close_all()
        yield from proxy_d.transport.close_all()
        yield from stop_p()
        yield from stop_d()

    run_emulation(main)


def slowpoke(seed: int) -> None:
    """The server binds 60 ms late; the client's reconnect policy
    (retry every 20 ms, up to 10 fails) delivers anyway."""
    net = EmulatedBackend(FixedDelay(2_000), seed=seed)
    srv = Transport(net)
    cli = Transport(net, host="client", settings=Settings(
        reconnect_policy=lambda fails: 20_000 if fails < 10 else None))
    stop_holder = []

    def sink(chan, ctx) -> Program:
        from timewarp_tpu_torch.manage.sync import CLOSED
        while True:
            item = yield from chan.get()
            if item is CLOSED:
                return
            t = yield GetTime()
            print(f"  server @{t} µs: finally received {item!r}")

    def main() -> Program:
        addr = ("127.0.0.1", 4400)
        yield from fork_(lambda: cli.send_raw(addr, b"patience pays"))

        def late_server() -> Program:
            yield Wait(60_000)
            t = yield GetTime()
            print(f"  server @{t} µs: up at last")
            stop = yield from srv.listen_raw(AtPort(4400), sink)
            stop_holder.append(stop)

        yield from fork_(late_server)
        yield Wait(200_000)
        yield from cli.close(addr)
        yield from stop_holder[0]()

    run_emulation(main)


def cycles(seed: int) -> None:
    """Three generations of a server on one port; each generation only
    sees its own messages."""
    net = EmulatedBackend(FixedDelay(500), seed=seed)
    srv = Dialog(Transport(net))
    addr = ("127.0.0.1", 4500)

    def main() -> Program:
        for gen in range(3):
            def on_msg(msg, ctx, gen=gen) -> Program:
                t = yield GetTime()
                print(f"  generation {gen} @{t} µs: {msg}")

            stop = yield from srv.listen(
                AtPort(4500), [Listener(Yohoho, on_msg)])
            cli = Dialog(Transport(net, host=f"client{gen}"))
            yield from cli.send(addr, Yohoho(gen * 10))
            yield from cli.send(addr, Yohoho(gen * 10 + 1))
            yield Wait(30_000)
            yield from cli.transport.close_all()
            yield from stop()
            print(f"  generation {gen} stopped; port re-binds cleanly")

    run_emulation(main)


def forks(seed: int) -> None:
    """Fork strategy: Yohoho handlers run inline (serialized — slow
    handler delays the next), EpicRequest handlers fork (overlap)."""
    net = EmulatedBackend(FixedDelay(1_000), seed=seed)

    def strategy(name, thunk) -> Program:
        # ≙ pendingForkStrategy: inline for one message name, the
        # default fork for everything else (Main.hs:345-376)
        if name == "Yohoho":
            return run_inline(name, thunk)
        return fork_each_message(name, thunk)

    srv = Dialog(Transport(net), fork_strategy=strategy)

    def slow_handler(kind):
        def handle(msg, ctx) -> Program:
            t0 = yield GetTime()
            yield Wait(10_000)  # pretend to work for 10 ms
            t1 = yield GetTime()
            print(f"  {kind} {msg} handled {t0}→{t1} µs")
        return handle

    def main() -> Program:
        stop = yield from srv.listen(AtPort(4600), [
            Listener(Yohoho, slow_handler("inline")),
            Listener(EpicRequest, slow_handler("forked")),
        ])
        cli = Dialog(Transport(net, host="client"))
        addr = ("127.0.0.1", 4600)
        for i in range(3):
            yield from cli.send(addr, Yohoho(i))
        for i in range(3):
            yield from cli.send(addr, EpicRequest(i, "concurrent"))
        yield Wait(120_000)
        yield from cli.transport.close_all()
        yield from stop()

    run_emulation(main)
    print("  (inline handlers end 10 ms apart; forked ones overlap)")


SCENARIOS = {
    "yohoho": yohoho,
    "proxy": proxy,
    "slowpoke": slowpoke,
    "cycles": cycles,
    "forks": forks,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", choices=sorted(SCENARIOS) + ["all"],
                   default="all")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    names = sorted(SCENARIOS) if a.scenario == "all" else [a.scenario]
    for name in names:
        print(f"== {name} ==")
        SCENARIOS[name](a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
