"""The sharded engines on NCCL, one card a rank: every case of
tests/torch_sharded_cases.py run by NCCL ranks on the card
(``parallel.launch.spawn(..., backend="nccl", device="cuda")``, rank r on
``cuda:r``, every collective of ``MeshComm`` on device tensors) equals
the same case run by as many gloo ranks on the CPU, leaf for leaf: one
rank, and four ranks (the ``two_axis`` case's (2, 2) mesh included)
where four cards are present. A rank that raises under
NCCL fails the launch within 60 s with that rank's traceback. Marked
``cuda``: every test skips without a card, the four-rank one with fewer
than four. The command line's ``--dist-backend nccl`` prints the gloo
ranks' summary, and a refusal raised in every NCCL rank is a clean
exit. The file imports no JAX (the card's machine has none).
Tolerance: exact.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from timewarp_tpu_torch.parallel.launch import RankFailed, spawn

#: per-process facts, not results: each case's seconds and the rank's
#: torch threads
NOT_RESULTS = ("seconds", "threads")
#: the case whose results name the temporary directory it wrote in
IN_TMP = "checkpoint"


def _cards():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _diff(a, b, where="result"):
    """The first place where ``a`` and ``b`` differ, or None: numpy
    arrays and tensors element for element with their dtypes, traces and
    other dataclasses field by field, containers entry by entry."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                for x in (a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        same = a.dtype == b.dtype and a.shape == b.shape \
            and np.array_equal(a, b)
        return None if same else where
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if type(a) is not type(b):
            return where
        for f in dataclasses.fields(a):
            d = _diff(getattr(a, f.name), getattr(b, f.name),
                      f"{where}.{f.name}")
            if d:
                return d
        return None
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return where
        for k in a:
            d = _diff(a[k], b[k], f"{where}[{k!r}]")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return where
        for i, (x, y) in enumerate(zip(a, b)):
            d = _diff(x, y, f"{where}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{where}: {a!r} != {b!r}"


def _errors_last_line(x):
    """A case that raised on every rank: its exception line (the
    traceback's frames name the rank's paths)."""
    if isinstance(x, tuple) and len(x) == 2 and x[0] == "error":
        return ("error", x[1].strip().splitlines()[-1])
    return x


def _in_dir(x, root):
    """``x`` with every path under ``root`` made relative to it."""
    if isinstance(x, str):
        return x.replace(root, "<dir>") if x.startswith(root) else x
    if isinstance(x, dict):
        return {k: _in_dir(v, root) for k, v in x.items()}
    return x


def _hold(card, cpu):
    """Every rank's results on the card against the same rank's on the
    CPU, leaf for leaf."""
    assert len(card) == len(cpu)
    for r, (a, b) in enumerate(zip(card, cpu)):
        assert a["sys_modules"] == b["sys_modules"] == []
        a, b = dict(a), dict(b)
        for k in NOT_RESULTS:
            a.pop(k), b.pop(k)
        for side in (a, b):
            if isinstance(side[IN_TMP], dict):
                side[IN_TMP] = _in_dir(side[IN_TMP], side[IN_TMP]["dir"])
        a = {k: _errors_last_line(v) for k, v in a.items()}
        b = {k: _errors_last_line(v) for k, v in b.items()}
        assert set(a) == set(b)
        diffs = {k: _diff(a[k], b[k], f"rank {r} {k}") for k in a}
        assert not {k: d for k, d in diffs.items() if d}, diffs


def _run(n, backend, device):
    return spawn("torch_sharded_cases:run_all", n, backend=backend,
                 device=device, threads=1 if device == "cpu" else None)


@pytest.mark.cuda
def test_one_nccl_rank_equals_one_gloo_cpu_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL ranks run on the card")
    _hold(_run(1, "nccl", "cuda"), _run(1, "gloo", "cpu"))


@pytest.mark.cuda
def test_four_nccl_ranks_equal_four_gloo_cpu_ranks():
    if _cards() < 4:
        pytest.skip(f"needs four CUDA devices (NCCL runs one rank a card), "
                    f"found {_cards()}")
    card, cpu = _run(4, "nccl", "cuda"), _run(4, "gloo", "cpu")
    _hold(card, cpu)
    two = card[0]["two_axis"]
    assert not (isinstance(two, tuple) and two[0] == "error"), two


@pytest.mark.cuda
def test_a_failing_nccl_rank_fails_the_launch_within_60_s():
    """The last rank raises; the others wait in a collective it never
    joins (with one card, the one rank raises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL ranks run on the card")
    n = min(_cards(), 4)
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match=f"rank {n - 1} of {n} failed"
                       f"(.|\n)*rank {n - 1} fails on purpose"):
        spawn("torch_sharded_cases:fail_on_rank", n, backend="nccl",
              device="cuda", args=(n - 1,), timeout=600)
    assert time.monotonic() - t0 < 60


CLI_GOSSIP = ["gossip", "--nodes", "4096", "--burst", "--fanout", "4",
              "--think-us", "3000", "--end-us", "400000", "--link",
              "quantize:1000:uniform:3000:9000", "--window", "3000",
              "--steps", "48", "--engine", "sharded"]


def _summary(capsys, argv):
    from timewarp_tpu_torch.cli import main
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.cuda
def test_cli_nccl_ranks_equal_gloo_ranks(capsys):
    """``--dist-backend nccl``, one card a rank, prints the summary of the
    same run over gloo ranks (one card a rank too, where there are
    enough)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL ranks run on the card")
    n = str(min(_cards(), 4))
    nccl = _summary(capsys, CLI_GOSSIP + ["--devices", n,
                                          "--dist-backend", "nccl"])
    gloo = _summary(capsys, CLI_GOSSIP + ["--devices", n])
    assert nccl == gloo and nccl["delivered"] > 0


@pytest.mark.cuda
def test_cli_refusal_in_every_nccl_rank_is_a_clean_exit():
    """A refusal raised in every NCCL rank exits as it would in one
    process, within 60 s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL ranks run on the card")
    from timewarp_tpu_torch.cli import main
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="needs --batch"):
        main(["gossip", "--nodes", "64", "--engine", "sharded-batched",
              "--devices", str(min(_cards(), 4)), "--dist-backend", "nccl"])
    assert time.monotonic() - t0 < 60
