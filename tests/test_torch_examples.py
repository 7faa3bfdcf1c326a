"""The port's example scripts (``examples/torch/``) against their
reference twins (``examples/``): the same argv gives the same stdout,
line for line. Both sides run in this process (``main`` of each); the
engine scripts run the port with ``--device cpu``. One fresh interpreter
runs all six port scripts and loads neither JAX nor the reference."""

import contextlib
import io
import os
import runpy
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the scripts that build an engine, and so take ``--device``
ENGINE_SCRIPTS = ("chaos.py", "cross_world.py", "token_ring.py")

#: the argv of tests/test_examples.py, and chaos.py's two
CASES = [
    ("ping_pong.py",),
    ("socket_state.py", "--drop", "0.03"),
    ("token_ring.py",),
    ("token_ring.py", "--engine", "--nodes", "8"),
    ("playground.py",),
    ("playground.py", "--scenario", "proxy"),
    ("cross_world.py", "--nodes", "12"),
    ("chaos.py",),
    ("chaos.py", "--nodes", "16", "--seed", "3"),
]


def _stdout(path, argv, monkeypatch, port):
    """``main`` of the script at ``path`` under ``argv`` (the port's
    takes it as an argument, the reference's reads ``sys.argv``): its
    return value and what it printed."""
    monkeypatch.setattr(sys, "argv", [path, *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))
    main = runpy.run_path(path)["main"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv)) if port else main()
    return rc, buf.getvalue()


def _port_argv(script, argv):
    engine = script in ("chaos.py", "cross_world.py") or "--engine" in argv
    return [*argv, "--device", "cpu"] if engine else list(argv)


@pytest.mark.parametrize("case", CASES, ids=" ".join)
def test_port_example_prints_the_reference_stdout(case, monkeypatch):
    script, *argv = case
    ref_rc, want = _stdout(os.path.join(ROOT, "examples", script), argv,
                           monkeypatch, port=False)
    rc, got = _stdout(os.path.join(ROOT, "examples", "torch", script),
                      _port_argv(script, argv), monkeypatch, port=True)
    assert rc == (ref_rc or 0) == 0
    assert want.strip()
    assert got.splitlines() == want.splitlines()


def test_port_examples_load_neither_jax_nor_the_reference():
    """All six port scripts, through ``runpy`` as ``__main__`` in one
    fresh interpreter: each exits 0, and no ``jax`` or ``timewarp_tpu``
    module was loaded (tests/test_torch_imports.py's predicate)."""
    runs = [("ping_pong.py",), ("socket_state.py",), ("token_ring.py",),
            ("playground.py", "--scenario", "cycles"),
            ("chaos.py", "--device", "cpu"),
            ("cross_world.py", "--nodes", "8", "--device", "cpu")]
    code = (
        "import runpy, sys\n"
        f"for script, *argv in {runs!r}:\n"
        f"    path = {os.path.join(ROOT, 'examples', 'torch')!r} + '/' + script\n"
        "    sys.argv = [path, *argv]\n"
        "    try:\n"
        "        runpy.run_path(path, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), (script, e.code)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'timewarp_tpu' or m.startswith('timewarp_tpu.')]\n"
        "print('LOADED', len(bad), sorted(bad)[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED 0 []" in out.stdout.splitlines()[-1]
    assert "CROSS-WORLD LAW HOLDS" in out.stdout
    assert "the ring survived the partition heal" in out.stdout


@pytest.mark.parametrize("script", ENGINE_SCRIPTS)
def test_engine_example_needs_a_card_unless_told_cpu(script, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    argv = ["--engine"] if script == "token_ring.py" else []
    with pytest.raises(SystemExit, match="--device cpu"):
        _stdout(os.path.join(ROOT, "examples", "torch", script), argv,
                monkeypatch, port=True)
