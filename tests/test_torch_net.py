"""The port's network stack (``timewarp_tpu_torch/net/``: message,
backend, transfer, dialog, rpc) held against the reference's.

- **The reference's scenarios on the port.** Every test of
  ``tests/test_transfer.py`` (12), ``tests/test_dialog.py`` (19) and
  ``tests/test_rpc.py`` (17) runs through the port: the module's source
  is compiled with every ``timewarp_tpu.`` import pointing at
  ``timewarp_tpu_torch.``, and each of its tests is one parametrised
  case here. The ping-pong and token-ring programs those tests import
  are the port's own twins (``timewarp_tpu_torch/models/ping_pong_net.py``
  and ``token_ring_net.py``).
- **Bytes.** The same values ``encode`` and ``frame`` to the same bytes
  in both packages, and a message registered in each packs the same.
- **Link draws.** ``EmulatedBackend``'s per-chunk draw (on the host, in
  torch) equals the reference's jit-compiled ``_draw`` for fixed,
  uniform, drop, quantize and the seeded-hash link over a seed grid.
- **Runs.** The emulated echo, ping-pong and token-ring programs give the
  same results and final virtual times in both packages under the DES.
- **The wire.** A reference client's ``Rpc`` call is answered over
  loopback TCP by the port's ``Rpc`` server running in its own thread
  and event loop.

Tolerance: exact (bytes, delays, drop flags, results and virtual times
compared with ``==``; the float link models are not drawn here).
"""

import importlib
import inspect
import pathlib
import re
import socket
import sys
import threading
import types

import pytest
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_TESTS = ("test_transfer.py", "test_dialog.py", "test_rpc.py")


def _to_port(text: str) -> str:
    text = re.sub(r"\bfrom \.\.(\w)", r"from timewarp_tpu_torch.\1", text)
    return re.sub(r"\btimewarp_tpu\.", "timewarp_tpu_torch.", text)


def _compile_module(name: str, text: str, path: pathlib.Path):
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


def _port_test_module(fname: str):
    """A reference test module compiled against the port."""
    name = f"_torch_net_{fname[:-3]}"
    if name not in sys.modules:
        path = ROOT / "tests" / fname
        _compile_module(name, _to_port(path.read_text()), path)
    return sys.modules[name]


def _reference_cases():
    cases = []
    for fname in REFERENCE_TESTS:
        text = (ROOT / "tests" / fname).read_text()
        cases += [pytest.param(fname, t, id=f"{fname[:-3]}::{t}")
                  for t in re.findall(r"^def (test_\w+)\(", text, re.M)]
    return cases


CASES = _reference_cases()


def test_every_reference_case_is_collected():
    counts = {f: sum(1 for c in CASES if c.values[0] == f)
              for f in REFERENCE_TESTS}
    assert counts == {"test_transfer.py": 12, "test_dialog.py": 19,
                      "test_rpc.py": 17}


@pytest.mark.parametrize("fname,test", CASES)
def test_reference_scenario_on_port(fname, test, request):
    mod = _port_test_module(fname)
    assert not [m for m in vars(mod).values()
                if isinstance(m, types.ModuleType)
                and (m.__name__ == "timewarp_tpu"
                     or m.__name__.startswith("timewarp_tpu."))]
    fn = getattr(mod, test)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


# -- bytes -----------------------------------------------------------------

def _pkgs(mod):
    return (importlib.import_module(f"timewarp_tpu.{mod}"),
            importlib.import_module(f"timewarp_tpu_torch.{mod}"))


VALUES = [0, 1, -1, 127, 128, -129, 2 ** 31, -(2 ** 63), 2 ** 63 - 1, True,
          False, None, 1.5, -0.0, "", "héllo", b"\x00\xffbytes",
          [1, "a", None], (2, b"x"), {"b": 1, "a": [2, 3]},
          {"nested": {"deep": [1.25, {"k": b"v"}]}}]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_encode_and_frame_bytes_equal(value):
    ref, port = _pkgs("net.message")
    enc = ref.encode(value)
    assert port.encode(value) == enc
    assert port.frame(enc) == ref.frame(enc)
    assert port.decode(enc) == ref.decode(enc)


def test_message_packing_bytes_equal():
    def build(m):
        @m.message(name="WireProbe")
        class WireProbe:
            a: int
            b: str
            c: bytes
        return WireProbe
    ref, port = _pkgs("net.message")
    r, p = build(ref), build(port)
    rp, pp = ref.BinaryPacking(), port.BinaryPacking()
    head = {"id": 7}
    got = pp.pack(head, p(-5, "x", b"\x01"))
    assert got == rp.pack(head, r(-5, "x", b"\x01"))
    (pkt,) = pp.parser().feed(got)
    header, raw = pp.split(pkt)
    assert header == head and pp.extract_name(raw) == "WireProbe"
    assert pp.extract_content(raw) == p(-5, "x", b"\x01")


# -- link draws ------------------------------------------------------------

LINKS = ["fixed:1500", "uniform:1000:5000", "drop:0.3:uniform:500:4500",
         "quantize:1000:uniform:3000:9000",
         "drop:0.5:quantize:250:fixed:800", "hash:2000:9000:5"]


def _link(root, spec):
    if spec.startswith("hash:"):
        lo, hi, salt = (int(x) for x in spec.split(":")[1:])
        delays = importlib.import_module(f"{root}.net.delays")
        return delays.SeededHashUniform(lo, hi, salt)
    return importlib.import_module(f"{root}.net.links").parse_link(spec)


@pytest.mark.parametrize("spec", LINKS)
def test_emulated_draws_equal_reference(spec):
    ref, port = _pkgs("net.backend")
    drops = 0
    for seed in (0, 1, 7, 2 ** 40 + 3):
        rb = ref.EmulatedBackend(_link("timewarp_tpu", spec), seed=seed)
        pb = port.EmulatedBackend(_link("timewarp_tpu_torch", spec),
                                  seed=seed)
        for k in range(24):
            src = ref.endpoint_id(f"10.0.0.{k}:{4000 + k}")
            dst = (k * 2654435761) & 0xFFFFFFFF
            t = (k * 9_999_991) * (1 if k % 3 else 1 << 20)
            slot = k % 5
            want = rb._sample(src, dst, t, slot)
            assert pb._sample(src, dst, t, slot) == want, (seed, k)
            drops += want[1]
    assert pb._eid("127.0.0.1:9") == ref.endpoint_id("127.0.0.1:9")
    if spec.startswith("drop"):
        assert drops > 0


# -- runs under the DES: results and virtual times --------------------------

def _des(ns, prog):
    emu = ns.des.PureEmulation()
    return emu.run(prog), emu.virtual_time


def _ns(root):
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    models = (mod("models.ping_pong_net"), mod("models.token_ring_net"))
    return types.SimpleNamespace(
        des=mod("interp.ref.des"), backend=mod("net.backend"),
        links=mod("net.links"), delays=mod("net.delays"),
        transfer=mod("net.transfer"), pp=models[0], tr=models[1],
        echo=_port_test_module("test_transfer.py").echo_scenario
        if root != "timewarp_tpu"
        else importlib.import_module("test_transfer").echo_scenario)


def _echo(ns):
    net = ns.backend.EmulatedBackend(ns.links.parse_link(
        "quantize:500:uniform:1000:5000"), seed=3)
    return ns.echo(ns.transfer.Transport(net),
                   ns.transfer.Transport(net, host="client"))


def _ping_pong(ns):
    net = ns.backend.EmulatedBackend(
        ns.delays.UniformDelay(500, 9000), seed=11)
    return ns.pp.ping_pong_net(net, rounds=3)


def _token_ring(ns):
    net = ns.backend.EmulatedBackend(ns.tr.token_ring_delays(),
                                     connect_delays=ns.delays.FixedDelay(1),
                                     seed=5)
    return ns.tr.token_ring_net(
        net, 3, duration_us=2_000_000, passing_delay_us=300_000,
        bootstrap_us=100_000, check_period_us=500_000,
        allowed_progress_delay_us=1_000_000)


@pytest.mark.parametrize("build", [_echo, _ping_pong, _token_ring],
                         ids=lambda f: f.__name__[1:])
def test_emulated_runs_equal_reference(build):
    want = _des(_ns("timewarp_tpu"), build(_ns("timewarp_tpu")))
    got = _des(_ns("timewarp_tpu_torch"), build(_ns("timewarp_tpu_torch")))
    assert got == want
    assert want[1] > 0


# -- the wire: a reference client, the port's server -----------------------

def test_reference_client_port_server_over_tcp():
    """The reference's ``Rpc.call`` over loopback TCP to the port's
    ``Rpc.serve``, each package in its own thread and event loop; the
    request and reply types are declared in both packages under the
    same wire names."""
    def api(root):
        mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
        msg, rpc = mod("net.message"), mod("net.rpc")

        @msg.message(name="AddReq")
        class AddReq:
            a: int
            b: int

        @msg.message(name="SumRep")
        class SumRep:
            total: int
            by: str
        rpc.request(response=SumRep)(AddReq)
        return types.SimpleNamespace(
            AddReq=AddReq, SumRep=SumRep, rpc=rpc,
            Dialog=mod("net.dialog").Dialog,
            Transport=mod("net.transfer").Transport,
            AioBackend=mod("net.backend").AioBackend,
            eff=mod("core.effects"), sync=mod("manage.sync"),
            run=mod("interp.aio.timed").run_real_time)

    ref, port = api("timewarp_tpu"), api("timewarp_tpu_torch")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        tcp = s.getsockname()[1]
    served = threading.Event()
    stop = threading.Event()
    seen = []

    def server_main():
        server = port.rpc.Rpc(port.Dialog(port.Transport(port.AioBackend())))

        def add(req, ctx):
            seen.append((type(req).__module__, req.a, req.b))
            return port.SumRep(req.a + req.b, "port")
            yield  # noqa: unreachable — a generator handler

        def main():
            halt = yield from server.serve(tcp,
                                           [port.rpc.Method(port.AddReq,
                                                            add)])
            served.set()
            while not stop.is_set():
                yield port.eff.Wait(20_000)
            yield from halt()
        port.run(main)

    th = threading.Thread(target=server_main, daemon=True)
    th.start()
    assert served.wait(30), "the port's server never bound"
    client = ref.rpc.Rpc(ref.Dialog(ref.Transport(ref.AioBackend())))
    addr = ("127.0.0.1", tcp)

    def client_main():
        out = []
        for a, b in ((2, 3), (40, 2), (-7, 7)):
            rep = yield from ref.eff.timeout(
                10_000_000, lambda a=a, b=b: client.call(
                    addr, ref.AddReq(a, b)))
            out.append(rep)
        yield from client.dialog.transport.close(addr)
        return out

    try:
        reps = ref.run(client_main)
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive(), "the port's server never stopped"
    assert [(type(r), r.total, r.by) for r in reps] == \
        [(ref.SumRep, 5, "port"), (ref.SumRep, 42, "port"),
         (ref.SumRep, 0, "port")]
    assert [x[1:] for x in seen] == [(2, 3), (40, 2), (-7, 7)]
