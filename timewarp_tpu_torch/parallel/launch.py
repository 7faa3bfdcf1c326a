"""Start one rank per shard: the port's counterpart of what JAX's SPMD
runtime does implicitly for ``shard_map`` (one program per device).

:func:`spawn` starts ``n_ranks`` processes with the ``spawn`` start method
(a fresh interpreter each: never ``fork``, which would copy the caller's
threads and imported modules), joins them in a ``torch.distributed``
process group through a file rendezvous in a fresh temporary directory,
calls the target in every rank and returns each rank's result, passed
back through a file. The target is named as an importable
``"module:function"`` so a rank imports only the modules it needs. A
rank that raises fails the whole call with that rank's traceback; the
other ranks are stopped, and no partial result comes back.

Under ``nccl`` rank r runs on ``cuda:r`` and its process group is bound
to that card. A rank left behind by a failed one blocks inside a
collective, and a failed rank could block in NCCL's teardown: so the
failing rank writes its traceback and claims the failure before anything
else, leaves without a teardown, and :func:`spawn` stops every rank as
soon as the claim appears, never waiting out ``timeout``.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, List, Optional, Sequence

import torch

from .mesh import check_backend

__all__ = ["spawn", "RankFailed"]


class RankFailed(RuntimeError):
    """A rank raised (or died): the message carries its traceback."""


def _rank_device(device: str, rank: int) -> str:
    """The rank's device: ``cpu``, or for ``cuda`` the card ``rank`` modulo
    the cards present (one card a rank where there are enough, as NCCL's
    always are; gloo ranks share the cards otherwise)."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def _rank_main(target: str, rank: int, n_ranks: int, backend: str,
               device: str, args: tuple, rundir: str,
               threads: int) -> None:
    import torch.distributed as dist
    try:
        torch.set_num_threads(threads)
        dev = _rank_device(device, rank)
        bind = {}
        if dev != "cpu":
            torch.cuda.set_device(torch.device(dev))
        if backend == "nccl":
            # one host by construction (a file rendezvous): NCCL's
            # bootstrap stays on the loopback interface; the group is
            # bound to the rank's card, so a barrier needs no guess
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            bind["device_id"] = torch.device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{rundir}/rendezvous",
            world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(minutes=30), **bind)
        mod, _, fn = target.partition(":")
        result = getattr(importlib.import_module(mod), fn)(dev, *args)
        tmp = os.path.join(rundir, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(rundir, f"rank{rank}.pkl"))
    except BaseException:
        # the traceback for the caller, then the exception ends the rank
        # (exit code 1). The first rank to fail claims ``first`` (created
        # exclusively, after its traceback is written): the others fail
        # after it, in a collective it left (its connections close only
        # when it ends, after this claim)
        tb = traceback.format_exc()
        with open(os.path.join(rundir, f"rank{rank}.err"), "w") as f:
            f.write(tb)
        try:
            fd = os.open(os.path.join(rundir, "first"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(rank).encode())
            os.close(fd)
        except FileExistsError:
            pass
        if backend == "nccl":
            # no teardown: NCCL's can block on the ranks left inside a
            # collective, which spawn stops
            sys.stderr.write(tb)
            sys.stderr.flush()
            os._exit(1)
        raise
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(target: str, n_ranks: int, *, backend: str, device: str,
          args: Sequence[Any] = (), timeout: float = 3600.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``target`` (``"module:function"``) in ``n_ranks`` ranks of a
    ``backend`` process group and return the ranks' results in rank
    order. Each rank calls ``function(device, *args)``, ``device`` the
    rank's: ``"cpu"``, or ``"cuda:k"``. ``device="cuda"`` without a card
    raises, naming ``device="cpu"``; ``backend="nccl"`` with fewer GPUs
    than ranks raises. Each rank runs ``threads`` torch threads (default:
    the host's cores shared among the ranks). A rank that fails, or a run
    past ``timeout`` seconds, stops every rank and raises
    :class:`RankFailed`."""
    if ":" not in target:
        raise ValueError(f"target must be 'module:function', got "
                         f"{target!r}")
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spawn(device='cuda') but CUDA is not available; pass "
            "device='cpu' to run the ranks on the CPU")
    check_backend(backend, n_ranks)
    if backend == "nccl" and device != "cuda":
        raise ValueError(
            f"backend='nccl' ships device tensors, one GPU a rank, and "
            f"device={device!r}; run CPU ranks as backend='gloo'")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n_ranks)
    rundir = tempfile.mkdtemp(prefix="tw-ranks-")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, n_ranks, backend, device,
                               tuple(args), rundir, threads), daemon=True)
             for r in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        first = os.path.join(rundir, "first")
        while any(p.exitcode is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad or os.path.exists(first) \
                    or time.monotonic() > deadline:
                break
            procs[0].join(0.05) if procs[0].exitcode is None else \
                time.sleep(0.05)
        claimed = os.path.exists(first)
        failed = [r for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        late = [r for r, p in enumerate(procs) if p.exitcode is None]
        if failed or late or claimed:
            _stop(procs)
            if not (failed or claimed):
                raise RankFailed(
                    f"{target}: ranks {late} still running after "
                    f"{timeout} s; every rank stopped")
            # the first rank to fail names the fault; the others may have
            # failed after it, in a collective it left
            r = int(open(first).read()) if claimed else failed[0]
            err = os.path.join(rundir, f"rank{r}.err")
            tb = open(err).read() if os.path.exists(err) else (
                f"(exit code {procs[r].exitcode}, no traceback: the rank "
                "died before its target ran; a main module that starts "
                "ranks when imported needs the `if __name__ == "
                "'__main__':` guard, as the spawn start method imports it "
                "in every rank)")
            raise RankFailed(f"{target}: rank {r} of {n_ranks} failed; "
                             f"every rank stopped.\n{tb}")
        return [pickle.load(open(os.path.join(rundir, f"rank{r}.pkl"),
                                 "rb")) for r in range(n_ranks)]
    finally:
        _stop(procs)
        shutil.rmtree(rundir, ignore_errors=True)


def _stop(procs) -> None:
    """Kill every started rank still running and reap them all."""
    for p in procs:
        if p.pid is not None and p.exitcode is None:
            p.kill()
    for p in procs:
        if p.pid is not None:
            p.join()
