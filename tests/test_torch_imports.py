"""The port stands alone: importing ``timewarp_tpu_torch`` (every module
of it) in a fresh interpreter leaves ``jax`` and the reference package
``timewarp_tpu`` out of ``sys.modules``; no source file of the port, nor
``chip_smoke.py`` and ``bench_cuda.py``, imports either (the run-mode planes' packages ``obs``,
``integrity``, ``dispatch``, ``speculate`` and ``controlled.py`` also
imported first and alone, and so are the sweep service's packages
``sweep``, ``pack``, ``manage`` and ``interp.aio``, the chaos search's
``search``, the cross-run plane's ``obs.ledger``, ``obs.regress`` and
``obs.watch``, and the network stack's and serving layer's ``net`` and
``serve``, and the multi-device layer's ``parallel`` and
``interp.torch_engine.sharded``; a rank that ``parallel.launch.spawn``
starts holds neither either); every engine (``TorchEngine``, ``FusedSparseEngine``,
``EdgeEngine``, ``FusedRingEngine``), the sweep's entry points
(``SweepService``, ``build_bucket_engine``, ``solo_result``), the
search's (``ChaosSearch``, ``evaluate_configs``, ``rejudge_repro``,
``minimize_counterexample``, ``fork_bucket``) and the serving layer's
(``OpenBucketRunner``, ``ServeCurator``) run on the card by default,
raising on a machine without CUDA unless the caller passes
``device="cpu"``; every service takes the reference's ``lint`` modes and
refuses any other, ``SweepService(host=...)`` runs on the serving
layer's leases and ``fit_from_ledger`` reads the port's run ledger. The
analysis package, the oracle and the query, bisect and profiler tools
import alone too, and so do the command line (``cli`` and the services'
``sweep.cli``, ``search.cli``, ``serve.cli``, ``pack.cli``), the net
twins (``models/*_net.py``), ``bench_net`` and ``utils.logconfig``;
every module of the reference has its counterpart in the port but the
JAX-only ones (``utils/jaxconfig.py``, ``interp/jax_engine/``).

Tolerance: exact (membership and source checks).
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parent.parent / "timewarp_tpu_torch"


def _modules():
    # ``__main__`` runs the command line when imported (python -m)
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py") if p.name != "__main__.py")


def _is_reference(name: str) -> bool:
    # the port's own name starts with "timewarp_tpu": match the reference
    # package and its submodules exactly
    return name == "timewarp_tpu" or name.startswith("timewarp_tpu.")


def _is_jax(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name.startswith("jaxlib.")


def test_import_leaves_jax_and_reference_out():
    mods = _modules()
    for m in ("interp.torch_engine.engine", "models.ping_pong",
              "models.socket_state", "net.links",
              "interp.torch_engine.batched", "faults", "faults.apply",
              "faults.schedule", "faults.properties", "utils.checkpoint",
              "obs", "obs.metrics", "obs.telemetry", "obs.flight",
              "integrity", "integrity.checks", "integrity.digest",
              "integrity.inject", "integrity.runner", "dispatch",
              "dispatch.trace", "dispatch.controller",
              "interp.torch_engine.controlled",
              "interp.torch_engine.planes", "speculate", "speculate.plane",
              "speculate.policy", "speculate.equiv", "speculate.runner",
              "core.errors", "core.time", "core.effects", "interp.common",
              "interp.ref.des", "interp.aio", "interp.aio.timed",
              "manage", "manage.sync", "manage.jobs", "pack",
              "pack.allocate", "pack.predict", "obs.perfetto", "sweep",
              "sweep.spec", "sweep.bucket", "sweep.journal",
              "sweep.runner", "sweep.service", "search", "search.domain",
              "search.mutate", "search.objectives", "search.minimize",
              "search.fork", "search.campaign", "obs.ledger",
              "obs.regress", "obs.watch", "net", "net.message",
              "net.backend", "net.transfer", "net.dialog", "net.rpc",
              "serve", "serve.hosts", "serve.lease", "serve.worker",
              "serve.curator", "serve.frontend", "parallel",
              "parallel.mesh", "parallel.launch",
              "interp.torch_engine.sharded", "analysis",
              "analysis.report", "analysis.program_lint",
              "analysis.fault_lint", "analysis.capacity",
              "analysis.probes", "analysis.jaxpr_lint",
              "analysis.determinism", "analysis.plan_lint",
              "interp.ref.superstep", "interp.torch_engine.traced_ops",
              "obs.query", "obs.bisect", "obs.profiler", "cli",
              "sweep.cli", "search.cli", "serve.cli", "pack.cli",
              "utils.logconfig", "bench_net", "bench_net.commons",
              "bench_net.log_reader", "bench_net.receiver",
              "bench_net.sender", "bench_net.launch",
              "models.ping_pong_net", "models.token_ring_net",
              "models.gossip_net", "models.praos_net",
              "models.socket_state_net"):
        assert f"timewarp_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'timewarp_tpu' or m.startswith('timewarp_tpu.')]\n"
        "print(len(bad), sorted(bad)[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


@pytest.mark.parametrize("mod", ["obs", "integrity", "dispatch", "speculate",
                                 "interp.torch_engine.controlled", "sweep",
                                 "pack", "manage", "interp.aio", "search",
                                 "obs.ledger", "obs.regress",
                                 "obs.watch", "net", "net.backend",
                                 "net.rpc", "serve", "serve.worker",
                                 "serve.curator", "serve.frontend",
                                 "parallel", "parallel.launch",
                                 "interp.torch_engine.sharded",
                                 "analysis", "analysis.plan_lint",
                                 "interp.ref.superstep", "obs.query",
                                 "obs.bisect", "obs.profiler", "cli",
                                 "sweep.cli", "search.cli", "serve.cli",
                                 "bench_net.launch", "models.praos_net"])
def test_plane_packages_import_alone(mod):
    """Each run-mode plane's package, imported first and alone in a fresh
    interpreter (the plane modules copied from the reference keep their
    own copies of what they need), loads neither."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('timewarp_tpu_torch.{mod}')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'timewarp_tpu' or m.startswith('timewarp_tpu.')]\n"
        "print(len(bad), sorted(bad)[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_every_reference_module_has_a_counterpart():
    """Module for module under the same layout: every module of the
    reference but its JAX-only ones (flags, and the JAX engines, whose
    counterparts are ``interp/torch_engine/``)."""
    ref = PKG.parent / "timewarp_tpu"
    missing = [str(p.relative_to(ref)) for p in ref.rglob("*.py")
               if not (PKG / p.relative_to(ref)).exists()
               and p.relative_to(ref).parts[:2] != ("interp", "jax_engine")
               and p.relative_to(ref) != pathlib.Path("utils/jaxconfig.py")]
    assert missing == []


def test_spawned_rank_holds_neither():
    """A rank started by ``parallel.launch.spawn`` (the ``spawn`` start
    method, from this process, which holds JAX) imports neither."""
    from timewarp_tpu_torch.parallel.launch import spawn
    got = spawn("torch_sharded_cases:rank_modules", 2, backend="gloo",
                device="cpu")
    assert got == [[], []]


def test_sources_import_neither_jax_nor_reference():
    """The package's sources, ``chip_smoke.py`` (the script that drives
    the port on the card), the port's bench script ``bench_cuda.py``, the
    port's parity and multichip tools and its examples; none imports the
    reference's ``bench.py`` either."""
    offenders = []
    smoke = PKG.parent / "chip_smoke.py"
    bench = PKG.parent / "bench_cuda.py"
    tool = PKG.parent / "tools" / "parity_cuda.py"
    multichip = PKG.parent / "tools" / "multichip_cuda.py"
    examples = sorted((PKG.parent / "examples" / "torch").glob("*.py"))
    assert smoke.exists() and bench.exists() and tool.exists() \
        and multichip.exists() and len(examples) == 6
    for path in [*PKG.rglob("*.py"), smoke, bench, tool, multichip,
                 *examples]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}: {n}" for n in names
                          if _is_jax(n) or _is_reference(n) or n == "bench"]
    assert not offenders


def test_engine_raises_without_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import FixedDelay
    sc = gossip(64, burst=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(sc, FixedDelay(5_000), window="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(sc, FixedDelay(5_000), window="auto", device="cuda")
    eng = TorchEngine(sc, FixedDelay(5_000), window="auto", device="cpu")
    assert eng.device.type == "cpu"
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedSparseEngine(sc, FixedDelay(5_000), window="auto")
    assert FusedSparseEngine(sc, FixedDelay(5_000), window="auto",
                             device="cpu").device.type == "cpu"
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import \
        EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    from timewarp_tpu_torch.models.token_ring import token_ring
    ring = token_ring(64, n_tokens=64, think_us=0, with_observer=False)
    for cls in (EdgeEngine, FusedRingEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(ring, FixedDelay(500))
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(ring, FixedDelay(500), device="cuda")
        assert cls(ring, FixedDelay(500), device="cpu").device.type == "cpu"


def test_serve_raises_without_cuda_unless_cpu_requested(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    from timewarp_tpu_torch.serve.curator import ServeCurator
    from timewarp_tpu_torch.serve.worker import OpenBucketRunner
    jd = str(tmp_path / "j")
    for call in (lambda **kw: OpenBucketRunner("sb0", None, {}, capacity=2,
                                               window=1, **kw),
                 lambda **kw: ServeCurator(jd, "h0", **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        with pytest.raises(RuntimeError, match="CUDA"):
            call(device="cuda")
        assert call(device="cpu").device.type == "cpu"


def _sweep_pack():
    from timewarp_tpu_torch.sweep import SweepPack
    return SweepPack.from_json([
        {"id": "g", "scenario": "gossip", "params": {"nodes": 16},
         "link": "fixed:1000", "budget": 8}])


def test_sweep_raises_without_cuda_unless_cpu_requested(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    from timewarp_tpu_torch.sweep import (SweepService, build_bucket_engine,
                                          plan_buckets, solo_result)
    pack = _sweep_pack()
    cfg, jd = pack.configs[0], str(tmp_path / "j")
    bucket = plan_buckets(pack.configs)[0]
    for call in (lambda **kw: SweepService(pack, jd, **kw),
                 lambda **kw: build_bucket_engine(bucket, **kw),
                 lambda **kw: solo_result(cfg, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        with pytest.raises(RuntimeError, match="CUDA"):
            call(device="cuda")
    assert SweepService(pack, jd, device="cpu").device.type == "cpu"
    assert build_bucket_engine(bucket, device="cpu").device.type == "cpu"
    assert solo_result(cfg, device="cpu")["run_id"] == "g"


def test_search_raises_without_cuda_unless_cpu_requested(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    from timewarp_tpu_torch.faults.schedule import parse_faults
    from timewarp_tpu_torch.search import (ChaosSearch, evaluate_configs,
                                           fork_bucket,
                                           minimize_counterexample)
    from timewarp_tpu_torch.search.objectives import (parse_objective,
                                                      rejudge_repro)
    from timewarp_tpu_torch.sweep import RunConfig
    params = {"nodes": 8, "fanout": 2, "end_us": 30_000, "burst": True,
              "think_us": 5000, "mailbox_cap": 16}
    cfg = RunConfig(run_id="g", family="gossip",
                    params=tuple(sorted(params.items())),
                    link="uniform:1000:5000", window="auto", budget=40)
    sched = parse_faults("crash:0:0:20000")
    repro = {"scenario": "gossip", "params": params,
             "link": "uniform:1000:5000", "seed": 0, "window": "auto",
             "budget": 40, "faults": "crash:0:0:20000",
             "objective": "eventually-delivered:0"}
    obj = parse_objective("eventually-delivered")
    for call in (
            lambda **kw: ChaosSearch(base=cfg, objective=obj,
                                     population=2, generations=1, **kw),
            lambda **kw: evaluate_configs([cfg], **kw),
            lambda **kw: rejudge_repro(repro, **kw),
            lambda **kw: minimize_counterexample(cfg, sched, obj, **kw),
            lambda **kw: fork_bucket(cfg, [sched], 0, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        with pytest.raises(RuntimeError, match="CUDA"):
            call(device="cuda")
    assert ChaosSearch(base=cfg, objective=obj, population=2,
                       generations=1, device="cpu").device.type == "cpu"
    faulted = RunConfig(run_id="f", family="gossip",
                        params=cfg.params, link=cfg.link, window="auto",
                        budget=40, faults="crash:0:0:20000")
    assert fork_bucket(faulted, [sched], 0,
                       device="cpu")[0].device.type == "cpu"
    assert evaluate_configs([cfg], device="cpu")["g"].supersteps > 0


def test_sweep_refuses_what_the_port_lacks(tmp_path):
    from timewarp_tpu_torch.pack.predict import PackFitError, fit_from_ledger
    from timewarp_tpu_torch.sweep import (SweepService, build_bucket_engine,
                                          plan_buckets, solo_result)
    pack = _sweep_pack()
    jd = str(tmp_path / "j")
    bucket = plan_buckets(pack.configs)[0]
    # the lint knob takes the reference's modes and refuses any other
    for call in (lambda lint: SweepService(pack, jd, lint=lint,
                                           device="cpu"),
                 lambda lint: build_bucket_engine(bucket, lint=lint,
                                                  device="cpu"),
                 lambda lint: solo_result(pack.configs[0], lint=lint,
                                          device="cpu")):
        with pytest.raises(ValueError, match="lint"):
            call("loud")
    assert SweepService(pack, jd, lint="error", device="cpu").lint \
        == "error"
    assert build_bucket_engine(bucket, lint="error",
                               device="cpu").lint_report.ok
    assert solo_result(pack.configs[0], lint="error",
                       device="cpu")["run_id"] == "g"
    from timewarp_tpu_torch.serve.curator import ServeCurator
    from timewarp_tpu_torch.serve.frontend import ServeFrontend
    from timewarp_tpu_torch.serve.worker import OpenBucketRunner
    from timewarp_tpu_torch.sweep.journal import SweepJournal
    sd = str(tmp_path / "s")
    for call in (
            lambda lint: OpenBucketRunner("sb0", None, {}, capacity=2,
                                          window=1, lint=lint,
                                          device="cpu"),
            lambda lint: ServeCurator(sd, "h0", lint=lint, device="cpu"),
            lambda lint: ServeFrontend(SweepJournal(sd, host="h0"), "h0",
                                       ("127.0.0.1", 1), lint=lint)):
        with pytest.raises(ValueError, match="lint"):
            call("loud")
        assert call("error").lint == "error"
    # multi-host sweeps run on the serving layer's leases (no refusal)
    svc = SweepService(pack, str(tmp_path / "h"), host="h0", device="cpu")
    assert svc.host == "h0" and svc.leases is not None
    # the run ledger is ported: a directory without one is refused as
    # the reference refuses it, naming the ingest that makes one
    with pytest.raises(PackFitError, match="not a run ledger"):
        fit_from_ledger(str(tmp_path))
    assert not (tmp_path / "j").exists()
