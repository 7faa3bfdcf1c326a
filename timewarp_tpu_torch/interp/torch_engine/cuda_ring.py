"""The dense ring's superstep kernel on Hopper (counterpart of the Pallas
kernel of ``timewarp_tpu/interp/jax_engine/fused_ring.py``): K4's wrapper
:func:`fused_ring` and its plain PyTorch version :func:`fused_ring_plain`.

The state is ten int32 planes of N nodes, ``[10, N]`` in the order of
the plane indices below, every time relative to the engine's epoch
(``I32MAX`` = empty slot / no timer). One call runs one superstep at the relative
instant ``t``: fire, deliver, the lean ring step, the shift to node
``i + 1`` (node ``N-1`` to node 0), first-free-slot insertion into the two
queue slots, and the rebase to the new epoch ``t``.

The wrapper takes the plain version for tensors on the CPU only. For a
CUDA tensor it launches ``csrc/fused_ring.cu`` (built with ``nvcc`` at
first use — utils/build.py) or raises: there is no fallback. Every launch
adds one to ``LAUNCHES["fused_ring"]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops.numeric import I32MAX
from .cuda_insert import LAUNCHES, _I, _P, _check_launch, _kernel, _on_card

__all__ = ["fused_ring", "fused_ring_plain"]

#: the planes of the stacked state, in order: the two queue slots' deliver
#: time, value and kind, then the node's wake, token count, value and
#: armed send time
QR0, QR1, QV0, QV1, QK0, QK1, WAKE, CNT, VAL, SEND = range(10)
TOKEN = 0


def fused_ring_plain(planes: torch.Tensor, t: int, alive: bool, think: int,
                     drel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: one dense-ring superstep on ``planes`` (int32
    ``[10, N]``) at the epoch-relative instant ``t``. ``alive`` (the
    superstep is before ``end_us``), ``think`` (µs) and ``drel`` (the
    link's delay, >= 1) are host scalars. Returns the new planes,
    relative to the new epoch ``t``, and int64 ``[2]`` counts
    ``(delivered, overflow)``. int32 arithmetic wraps, as on the TPU."""
    MAXI = I32MAX
    (r0, r1, qv0, qv1, qk0, qk1, w, c, v, s) = planes.unbind(0)
    tt = torch.tensor(t, dtype=torch.int32, device=planes.device)
    armed = tt + think
    fire = torch.minimum(w, torch.minimum(r0, r1)) == tt
    d0 = (r0 <= tt) & fire
    d1 = (r1 <= tt) & fire
    # the lean ring step: reductions are slot-order free
    tok0 = d0 & (qk0 == TOKEN)
    tok1 = d1 & (qk1 == TOKEN)
    got = tok0 | tok1
    cnt1 = c + tok0.to(torch.int32) + tok1.to(torch.int32)
    vmax = torch.maximum(torch.where(tok0, qv0, -2**31),
                         torch.where(tok1, qv1, -2**31))
    val1 = torch.where(got, torch.maximum(v, vmax), v)
    send1 = torch.where(got & (s >= MAXI), armed, s)
    due = (send1 <= tt) & (cnt1 > 0) & fire
    if not alive:
        due = torch.zeros_like(due)
    cnt2 = cnt1 - due.to(torch.int32) if alive else torch.zeros_like(c)
    send2 = torch.where(due, torch.where(cnt2 > 0, armed, MAXI),
                        send1 if alive else torch.full_like(s, MAXI))
    wake2 = torch.where(send2 >= MAXI, MAXI,
                        torch.maximum(send2, tt + 1) - tt)  # contract #5

    def rebase(x):
        return torch.where(x >= MAXI, MAXI, x - tt)
    # route by the ring shift: node i receives node i-1's send
    in_v = torch.roll(due, 1)
    in_x = torch.roll(val1 + 1, 1)
    # keep + rebase, insert into the first free slot
    rel0 = torch.where((r0 < MAXI) & ~d0, r0 - tt, MAXI)
    rel1 = torch.where((r1 < MAXI) & ~d1, r1 - tt, MAXI)
    free0, free1 = rel0 >= MAXI, rel1 >= MAXI
    ins0 = in_v & free0
    ins1 = in_v & ~free0 & free1
    ovf = in_v & ~free0 & ~free1
    out = torch.stack([
        torch.where(ins0, drel, rel0),
        torch.where(ins1, drel, rel1),
        torch.where(ins0, in_x, qv0),
        torch.where(ins1, in_x, qv1),
        torch.where(ins0, TOKEN, qk0),
        torch.where(ins1, TOKEN, qk1),
        torch.where(fire, wake2, rebase(w)),
        torch.where(fire, cnt2, c),
        torch.where(fire, val1, v),
        torch.where(fire, rebase(send2), rebase(s)),
    ])
    counts = torch.stack([(d0.sum() + d1.sum()).long(), ovf.sum().long()])
    return out, counts


_RING_ARGS = (_P, _P, _I, _I, _I, _I, _I, _P, _P)


def _require_planes(name: str, x: torch.Tensor, n: int, device) -> None:
    if x.device != device or x.dtype != torch.int32 \
            or tuple(x.shape) != (10, n) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 [10, {n}] "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def fused_ring(planes: torch.Tensor, t: int, alive: bool, think: int,
               drel: int, *, out: Optional[torch.Tensor] = None,
               acc: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: see :func:`fused_ring_plain` for the function. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/fused_ring.cu`` (one
    thread per node). ``out`` (an int32 ``[10, N]`` buffer, never
    ``planes`` itself: the kernel reads neighbours' inputs while it
    writes) and ``acc`` (int64 ``[2]``, to which the counts are added) let
    a driver reuse its buffers; fresh ones are allocated otherwise.
    Returns ``(out, acc)``."""
    if not _on_card(planes, "fused_ring"):
        res, counts = fused_ring_plain(planes, t, alive, think, drel)
        if out is not None:
            res = out.copy_(res)
        if acc is not None:
            counts = acc.add_(counts)
        return res, counts
    n = planes.shape[-1]
    dev = planes.device
    _require_planes("planes", planes, n, dev)
    if not 1 <= n < 2**31 // 10:
        raise ValueError(f"n={n} nodes: need 1 <= n and 10 * n < 2**31")
    if not (-2**31 <= t < 2**31 and 0 <= think < 2**31
            and 1 <= drel < 2**31):
        raise ValueError(f"t={t}, think={think}, drel={drel} must fit "
                         "int32 (drel >= 1, think >= 0)")
    if out is None:
        out = torch.empty_like(planes)
    _require_planes("out", out, n, dev)
    if out.data_ptr() == planes.data_ptr():
        raise ValueError("out must not be planes: K4 runs out of place")
    if acc is None:
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
    if acc.device != dev or acc.dtype != torch.int64 \
            or tuple(acc.shape) != (2,):
        raise ValueError("acc must be an int64 [2] tensor on the planes' "
                         "device")
    fn = _kernel("fused_ring", "tw_fused_ring", _RING_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(planes.data_ptr(), out.data_ptr(), n, int(t), int(alive),
                int(think), int(drel), acc.data_ptr(), stream)
    _check_launch("fused_ring", rc)
    LAUNCHES["fused_ring"] += 1
    return out, acc
