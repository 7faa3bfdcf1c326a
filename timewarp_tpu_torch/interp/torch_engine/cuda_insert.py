"""The engines' insertion kernels on Hopper (counterpart of
``timewarp_tpu/interp/jax_engine/pallas_insert.py``): the fire-compaction
kernel (K2), the mailbox-insertion kernel (K1), the sample-and-insert
kernel of the fused engine (K3), their plain PyTorch versions, the link
sampling they share (:func:`sample_nodrop`), and :class:`InsertStage`,
the general engine's counterpart of ``PallasInsertStage``.

Each wrapper takes its plain version for tensors on the CPU only. For a
CUDA tensor it launches the hand-written CUDA kernel (``csrc/``, built
with ``nvcc`` at first use — utils/build.py) or raises: there is no
fallback. A fake tensor (the sanitizer's trace, analysis/) gets the
kernel's opaque ``tw.*`` graph node (traced_ops.py) and runs nothing. Every launch adds one to :data:`LAUNCHES`. K2 and K1 (and
their plain versions) also take a fleet: a leading world axis B on
every operand, all B worlds in one launch, each world's result equal to
its own solo call.

No kernel writes into its inputs: outputs are allocated fresh. This
matters because the commutative path hands the previous state's
``mb_src``/``mb_payload`` to insertion unchanged — an in-place write
would mutate the caller's earlier ``EngineState``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ...core.rng import msg_bits
from ...net.delays import LinkModel
from ...ops.numeric import I32MAX, MASK32
from ...utils import build
from . import traced_ops

__all__ = ["LAUNCHES", "reset_launches", "fire_compact",
           "fire_compact_plain", "mailbox_insert", "mailbox_insert_plain",
           "bucket_bounds", "InsertStage", "LANES", "sample_nodrop",
           "link_sample", "flight_times",
           "compact_scratch_words", "compact_narrow_max", "COMPACT_MAX_P",
           "LoweredLink", "sample_insert", "sample_insert_plain"]

#: the compaction order's segment width (one CTA per segment on the card)
LANES = 1024

#: kernel launches on the card since the last reset, by kernel name (K4,
#: ``fused_ring``, has its wrapper in cuda_ring.py)
LAUNCHES = {"fire_compact": 0, "mailbox_insert": 0, "sample_insert": 0,
            "fused_ring": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


@functools.cache
def _kernel(lib: str, sym: str, argtypes: tuple):
    fn = getattr(build.library(lib), sym)
    fn.argtypes = list(argtypes)
    fn.restype = _I
    return fn


def _check_launch(lib: str, rc: int) -> None:
    if rc != 0:
        err = build.library(lib).tw_error_string
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{lib} kernel launch failed: CUDA error {rc} "
            f"({err(rc).decode()})")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _require(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    """Refuse what the kernel does not take: device, int32, shape,
    contiguity."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else is
    refused (never quietly moved)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device "
                     f"{x.device}")


# ----------------------------------------------------------------------
# K2 — fire-compaction
# ----------------------------------------------------------------------

def _compact_layout(n: int):
    """The reference kernel's write order as segments of LANES nodes:
    ``NR`` node rows of LANES (the last one ragged when ``n`` is not a
    multiple), grouped into blocks of ``RW`` rows (8 when ``NR % 8 ==
    0``, else 1 — pallas_insert.py ``PallasInsertStage``), and inside a
    block slot-major, then row, then lane."""
    NR = -(-n // LANES)
    RW = 8 if NR % 8 == 0 else 1
    return NR, RW


def compact_scratch_words(n: int, M: int, B: int = 1) -> int:
    """int32 words of K2's scratch for ``B`` worlds, allocated fresh for
    each call (so no two calls, engines or streams share it): one valid
    count per warp of each 256-lane unit of each world's write order (8
    warps, 4 units a segment of LANES), then one total per job of the
    cooperative grid, which never has more jobs than units."""
    NR, _ = _compact_layout(n)
    units = NR * M * (LANES // 256)
    return B * (units * 8 + units)


def fire_compact_plain(pdst: torch.Tensor, woff_n: Optional[torch.Tensor],
                       payload: torch.Tensor, S: int):
    """Plain version of K2. ``pdst`` int32 ``[(B,) M, N]`` (-1 = no
    message), ``woff_n`` int32 ``[(B,) N]`` in-window send offsets (None
    when the window is 1: the batch's woff column is then 0), ``payload``
    int32 ``[(B,) M, P, N]``; a leading world axis B is optional and, when
    present, leads every output. Returns ``(dst[S], woff[S], smrank[S],
    pay[P, S], drops)``: each world's valid messages in the reference
    kernel's order (``_compact_layout``), ``dst = n`` past its fired
    count, and the count of its messages beyond ``S`` (int32)."""
    solo = pdst.dim() == 2
    if solo:
        pdst, payload = pdst[None], payload[None]
        woff_n = None if woff_n is None else woff_n[None]
    B, M, n = pdst.shape
    P = payload.shape[2]
    dev = pdst.device
    NR, RW = _compact_layout(n)
    G = NR // RW
    L = NR * LANES
    padded = torch.full((B, M, L), -1, dtype=torch.int32, device=dev)
    padded[:, :, :n] = pdst
    # the write order: block, slot, row, lane
    order = (torch.arange(M * L, dtype=torch.int64, device=dev)
             .view(M, G, RW * LANES).permute(1, 0, 2).reshape(-1))
    d = padded.view(B, M * L)[:, order]                      # [B, M*L]
    node, slot = order % L, order // L
    valid = d >= 0
    pos = torch.cumsum(valid, dim=1) - 1                     # write slot
    total = valid.sum(dim=1)
    keep = valid & (pos < S)
    wb, lane = torch.nonzero(keep, as_tuple=True)
    at = pos[wb, lane]
    nodes, slots = node[lane], slot[lane]
    out_dst = torch.full((B, S), n, dtype=torch.int32, device=dev)
    out_dst[wb, at] = d[wb, lane]
    out_woff = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if woff_n is not None:
        out_woff[wb, at] = woff_n[wb, nodes]
    out_smrank = torch.zeros((B, S), dtype=torch.int32, device=dev)
    out_smrank[wb, at] = (nodes * M + slots).to(torch.int32)
    out_pay = torch.zeros((B, P, S), dtype=torch.int32, device=dev)
    out_pay[wb, :, at] = payload[wb, slots, :, nodes]
    drops = torch.clamp(total - S, min=0).to(torch.int32)
    if solo:
        return (out_dst[0], out_woff[0], out_smrank[0], out_pay[0],
                drops[0])
    return out_dst, out_woff, out_smrank, out_pay, drops


_COMPACT_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                 _P, _P)

#: the widest payload K2 takes: the widest the reference's fire-compaction
#: kernel admits at any shape (its 12 MiB VMEM budget, pallas_insert.py,
#: at S = 1024 entries, M = 1 and window 1: 4096·(5 + 3P) bytes)
COMPACT_MAX_P = 1022


@functools.cache
def compact_narrow_max(index: int) -> int:
    """The widest payload K2's narrow build stages in shared memory on
    CUDA device ``index`` (27 words on an H100); a wider one takes the
    wide build, which stages the send offsets alone."""
    fn = _kernel("fire_compact", "tw_fire_compact_narrow_max", (_P,))
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(ctypes.addressof(out))
    _check_launch("fire_compact", rc)
    return out.value


def fire_compact(pdst: torch.Tensor, woff_n: Optional[torch.Tensor],
                 payload: torch.Tensor, S: int):
    """K2: stream compaction of the raw outbox planes into the fired
    batch of static width ``S``, solo or over a leading world axis (see
    :func:`fire_compact_plain` for the function). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/fire_compact.cu``: one
    cooperative launch of a grid that is resident all at once, for every
    world. A payload of up to :func:`compact_narrow_max` words takes the
    narrow build, every payload word staged in shared memory (8 KB a CTA
    per word); a wider one, up to :data:`COMPACT_MAX_P`, the wide build,
    which reads the payload from global memory; a wider one still, or a
    refused launch, raises."""
    if traced_ops.is_fake(pdst):
        return traced_ops.fire_compact(pdst, woff_n, payload, S)
    if not _on_card(pdst, "fire_compact"):
        return fire_compact_plain(pdst, woff_n, payload, S)
    solo = pdst.dim() == 2
    if solo:
        pdst, payload = pdst[None], payload[None]
        woff_n = None if woff_n is None else woff_n[None]
    B, M, n = pdst.shape
    P = payload.shape[2]
    dev = pdst.device
    if P > COMPACT_MAX_P:
        raise ValueError(
            f"fire_compact: payload of P={P} words; K2 takes P up to "
            f"{COMPACT_MAX_P}, the widest the reference's fire-compaction "
            "kernel admits at any shape")
    wide = int(P > compact_narrow_max(dev.index if dev.index is not None
                                      else torch.cuda.current_device()))
    _require("pdst", pdst, (B, M, n), dev)
    _require("payload", payload, (B, M, P, n), dev)
    if woff_n is not None:
        _require("woff_n", woff_n, (B, n), dev)
    scratch = torch.empty(compact_scratch_words(n, M, B), dtype=torch.int32,
                          device=dev)
    out_dst = torch.empty((B, S), dtype=torch.int32, device=dev)
    out_woff = torch.empty((B, S), dtype=torch.int32, device=dev)
    out_smrank = torch.empty((B, S), dtype=torch.int32, device=dev)
    out_pay = torch.empty((B, P, S), dtype=torch.int32, device=dev)
    drops = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _kernel("fire_compact", "tw_fire_compact", _COMPACT_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pdst.data_ptr(), _ptr(woff_n), payload.data_ptr(), n, M, P,
                S, B, wide, scratch.data_ptr(), out_dst.data_ptr(),
                out_woff.data_ptr(), out_smrank.data_ptr(),
                out_pay.data_ptr(), drops.data_ptr(), stream)
    _check_launch("fire_compact", rc)
    LAUNCHES["fire_compact"] += 1
    if solo:
        return (out_dst[0], out_woff[0], out_smrank[0], out_pay[0],
                drops[0])
    return out_dst, out_woff, out_smrank, out_pay, drops


# ----------------------------------------------------------------------
# K1 — mailbox insertion
# ----------------------------------------------------------------------

def bucket_bounds(sd: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Per-destination bucket of a destination-sorted batch (sentinel
    ``n`` past the valid entries): ``start[d]`` is the index of d's first
    message and ``cnt[d]`` their number, int32 ``[n]`` each — ``[B, n]``
    for a ``[B, S]`` fleet batch, each world's row sorted on its own.
    Plain torch ops outside the kernel, as the reference computes them in
    XLA."""
    nodes = torch.arange(n, dtype=torch.int32, device=sd.device)
    if sd.dim() == 2:
        nodes = nodes.expand(sd.shape[0], n).contiguous()
    start = torch.searchsorted(sd, nodes, out_int32=True)
    end = torch.searchsorted(sd, nodes, right=True, out_int32=True)
    return start, end - start


def mailbox_insert_plain(start, cnt, counts, drel, src, pay,
                         mb_rel, mb_src, mb_payload):
    """Plain version of K1: merge a destination-sorted batch into the
    ``[K, N]`` mailbox. ``start``/``cnt`` int32 ``[N]`` are each node's
    bucket in the batch; ``drel``/``src`` int32 ``[S]`` and ``pay`` int32
    ``[P, S]`` are the batch columns (``src`` None when the scenario has
    no ``inbox_src``: ``mb_src`` then passes through). ``counts`` None
    selects the commutative inbox — the r-th message of node d fills d's
    r-th empty slot (``mb_rel == I32MAX``); otherwise (ordered inbox) it
    fills row ``counts[d] + r``. Returns ``(mb_rel, mb_src, mb_payload,
    overflow)`` with the messages that found no slot counted in the int32
    ``overflow``. A leading world axis B on every operand (a fleet)
    leads every result too."""
    solo = mb_rel.dim() == 2
    if solo:
        start, cnt, drel, pay, mb_rel, mb_src, mb_payload = (
            x[None] for x in (start, cnt, drel, pay, mb_rel, mb_src,
                              mb_payload))
        counts = None if counts is None else counts[None]
        src = None if src is None else src[None]
    B, K, n = mb_rel.shape
    P = mb_payload.shape[2]
    S = drel.shape[1]
    if counts is None:
        free = mb_rel == I32MAX
        h = torch.cumsum(free, dim=1, dtype=torch.int32) - free.to(
            torch.int32)
        want = free & (h < cnt[:, None, :])
        j = start[:, None, :] + h
        ovf = torch.clamp(cnt - free.sum(dim=1, dtype=torch.int32), min=0)
    else:
        rows = torch.arange(K, dtype=torch.int32, device=mb_rel.device)
        jr = rows[None, :, None] - counts[:, None, :]
        want = (jr >= 0) & (jr < cnt[:, None, :])
        j = start[:, None, :] + jr
        ovf = torch.clamp(cnt - (K - counts), min=0)
    jc = torch.where(want, j, 0).clamp(0, S - 1).long().view(B, K * n)
    o_rel = torch.where(want, drel.gather(1, jc).view(B, K, n), mb_rel)
    pj = pay.gather(2, jc[:, None, :].expand(B, P, K * n)).view(B, P, K, n)
    o_pay = torch.where(want[:, :, None, :], pj.permute(0, 2, 1, 3),
                        mb_payload)
    o_src = mb_src if src is None else torch.where(
        want, src.gather(1, jc).view(B, K, n), mb_src)
    overflow = ovf.sum(dim=1, dtype=torch.int32)
    if solo:
        return o_rel[0], o_src[0], o_pay[0], overflow[0]
    return o_rel, o_src, o_pay, overflow


_INSERT_ARGS = (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                _P, _P, _P, _P, _P)


def mailbox_insert(start, cnt, counts, drel, src, pay,
                   mb_rel, mb_src, mb_payload):
    """K1: see :func:`mailbox_insert_plain` for the function, solo or
    over a leading world axis. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/mailbox_insert.cu`` (one CTA per tile of 256
    nodes of one world loads the tile's entries in turn and fills its
    nodes' rows, the tile walk it shares with K3; every world in the one
    launch; outputs freshly allocated). The buckets must be contiguous in
    node order, as :func:`bucket_bounds` gives them, and an ordered
    inbox's ``counts`` lie in ``[0, K]``."""
    if traced_ops.is_fake(mb_rel):
        return traced_ops.mailbox_insert(start, cnt, counts, drel, src, pay,
                                         mb_rel, mb_src, mb_payload)
    if not _on_card(mb_rel, "mailbox_insert"):
        return mailbox_insert_plain(start, cnt, counts, drel, src, pay,
                                    mb_rel, mb_src, mb_payload)
    solo = mb_rel.dim() == 2
    if solo:
        start, cnt, drel, pay, mb_rel, mb_src, mb_payload = (
            x[None] for x in (start, cnt, drel, pay, mb_rel, mb_src,
                              mb_payload))
        counts = None if counts is None else counts[None]
        src = None if src is None else src[None]
    B, K, n = mb_rel.shape
    P = mb_payload.shape[2]
    S = drel.shape[1]
    dev = mb_rel.device
    for name, x, shape in (("start", start, (B, n)), ("cnt", cnt, (B, n)),
                           ("drel", drel, (B, S)), ("pay", pay, (B, P, S)),
                           ("mb_rel", mb_rel, (B, K, n)),
                           ("mb_src", mb_src, (B, K, n)),
                           ("mb_payload", mb_payload, (B, K, P, n))):
        _require(name, x, shape, dev)
    if counts is not None:
        _require("counts", counts, (B, n), dev)
    if src is not None:
        _require("src", src, (B, S), dev)
    o_rel = torch.empty_like(mb_rel)
    o_pay = torch.empty_like(mb_payload)
    o_src = mb_src if src is None else torch.empty_like(mb_src)
    overflow = torch.zeros((B,), dtype=torch.int32, device=dev)
    fn = _kernel("mailbox_insert", "tw_mailbox_insert", _INSERT_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(start.data_ptr(), cnt.data_ptr(), _ptr(counts),
                drel.data_ptr(), _ptr(src), pay.data_ptr(), S,
                mb_rel.data_ptr(), None if src is None else mb_src.data_ptr(),
                mb_payload.data_ptr(), n, K, P, B,
                o_rel.data_ptr(), None if src is None else o_src.data_ptr(),
                o_pay.data_ptr(), overflow.data_ptr(), stream)
    _check_launch("mailbox_insert", rc)
    LAUNCHES["mailbox_insert"] += 1
    if solo:
        return o_rel[0], o_src[0], o_pay[0], overflow[0]
    return o_rel, o_src, o_pay, overflow


# ----------------------------------------------------------------------
# the engine-facing stage
# ----------------------------------------------------------------------

class InsertStage:
    """The engine's routing front end and insertion back end: K2 turns
    the pre-masked ``[M, N]`` outbox into the compact fired batch (the
    adaptive regime only), K1 merges the sorted, sampled batch into the
    mailbox.

    ``insert_cap`` bounds the fired batch in messages, as in the
    reference: default ``n_nodes * max_out`` (nothing can drop), rounded
    UP to a multiple of 1024 — so a given cap drops exactly the messages
    the reference's ``PallasInsertStage`` drops, counted in
    ``route_drop``. Outside the adaptive regime (``adaptive`` False: a
    ``route_cap``, a droppy link, or window 1 with ``max_out`` 1) nothing
    is compacted and ``insert_cap`` is refused; the batch is the eager
    width ``n_nodes * max_out``, or ``route_cap`` when smaller, which is
    not rounded. A node-sharded engine's stage serves its rank: ``n`` the
    rank's nodes, ``batch`` the eager width after the exchange (``D ·
    bucket_cap``). Unlike the reference, ``n_nodes`` need not be a
    multiple of 1024."""

    def __init__(self, scenario, n: int, *, window: int,
                 insert_cap: Optional[int], adaptive: bool = True,
                 route_cap: Optional[int] = None,
                 batch: Optional[int] = None) -> None:
        M = scenario.max_out
        self.n, self.M = n, M
        self.W = int(window)
        self.inbox_src = scenario.inbox_src
        full = n * M if batch is None else int(batch)
        if insert_cap is not None:
            if int(insert_cap) < M:
                raise ValueError(f"insert_cap must be >= max_out={M} (one "
                                 f"whole sender), got {insert_cap}")
            if not adaptive:
                raise ValueError(
                    "insert_cap bounds the fire-compacted adaptive "
                    "batch; this engine's regime (route_cap / droppy "
                    "link / classic narrow outbox) never compacts — "
                    "drop the knob or use route_cap")
        if adaptive:
            cap = full if insert_cap is None else min(int(insert_cap), full)
            #: the fired batch's static width
            self.S = -(-cap // 1024) * 1024
        else:
            #: the sorted batch's width: eager, or sliced to route_cap
            self.S = full if route_cap is None else min(int(route_cap), full)

    def compact(self, pdst, woff_n, payload):
        """Raw pre-masked outbox planes in, compact fired batch out:
        ``(dst, woff, smrank, pay[P, S], route_drop)`` — each with the
        fleet's leading world axis when the planes have one."""
        return fire_compact(pdst, woff_n if self.W > 1 else None,
                            payload, self.S)

    def insert(self, sd, drel_s, src_s, pay_s, mb_rel, mb_src,
               mb_payload, counts):
        """One destination-sorted batch into the mailbox (``counts`` is
        the ordered inbox's kept-rows plane, None when commutative), solo
        or every world of a fleet at once."""
        start, cnt = bucket_bounds(sd, self.n)
        return mailbox_insert(start, cnt, counts, drel_s,
                              src_s if self.inbox_src else None, pay_s,
                              mb_rel, mb_src, mb_payload)


# ----------------------------------------------------------------------
# link sampling (shared by the general engine and K3's plain version)
# ----------------------------------------------------------------------

def link_sample(link, s0, s1, src, dst, tmsg, slot):
    """The link's draw for each message: the per-message entropy
    ``msg_bits(s0, s1, src, dst, tmsg, slot)`` (derived only when the
    model reads it) into ``link.sample``. For a fleet the seed words are
    ``[B, 1]`` tensors (and a swept link's parameters too) broadcasting
    over the ``[B, S]`` messages. Returns ``(delay int64, drop bool)``."""
    mbits = msg_bits(s0, s1, src, dst, tmsg, slot) if link.needs_key \
        else None
    return link.sample(src, dst, tmsg, mbits)


def flight_times(delay, woff, ok, W: int, w_now=None):
    """The ``>= 1 µs`` flight clamp, the epoch-relative deliver time
    ``woff + flight`` saturated to int32, and the ``bad_delay`` /
    ``short_delay`` counts over the ``ok`` entries of each batch row (the
    last axis; ``short`` only when the window bound ``W > 1``, counting
    flights shorter than the superstep's effective window ``w_now``: ``W``
    itself by default, or a dynamic window's int64 ``[B, 1]`` tensor).
    Returns ``(flight int64, drel int32, bad, short)``."""
    flight = torch.clamp(delay, min=1)                     # contract #4
    drel64 = woff.long() + flight
    bad = (ok & (drel64 > I32MAX - 1)).sum(dim=-1, dtype=torch.int32)
    if W > 1:
        short = (ok & (flight < (W if w_now is None else w_now))).sum(
            dim=-1, dtype=torch.int32)
    else:
        short = torch.zeros(ok.shape[:-1], dtype=torch.int32,
                            device=ok.device)
    drel = torch.clamp(drel64, max=I32MAX - 1).to(torch.int32)
    return flight, drel, bad, short


def sample_nodrop(link, s0, s1, W: int, src, dst, tmsg, slot, woff, ok):
    """Link sampling for the no-drop routing paths (lazy, adaptive and
    K3's plain version): :func:`link_sample` then :func:`flight_times`,
    the drop column unread."""
    delay, _ = link_sample(link, s0, s1, src, dst, tmsg, slot)
    return flight_times(delay, woff, ok, W)


# ----------------------------------------------------------------------
# K3 — sample and insert (the fused engine's kernel)
# ----------------------------------------------------------------------

class LoweredLink(NamedTuple):
    """A link model as K3 draws it (built by ``fused_sparse.lower_link``):
    ``kind`` one of :data:`LINK_KINDS`; ``ints`` four uint32 parameters
    (Fixed: delay; Uniform: lo, span; SeededHashUniform: lo, span and the
    model's two salt words); ``floats`` four float32 parameters
    (LogNormal: median, sigma, floor, cap); ``quantum`` the Quantize
    step, 0 when unwrapped; ``max_delay_us`` the largest delay it can
    draw; ``model`` the port's link model, whose ``sample`` is the plain
    torch sampler of the same function (and whose ``needs_key`` says
    whether the draw reads the message entropy)."""
    kind: str
    ints: Tuple[int, int, int, int]
    floats: Tuple[float, float, float, float]
    quantum: int
    max_delay_us: int
    model: LinkModel


#: the link kinds K3 draws in-kernel, by their code in csrc/sample_insert.cu
LINK_KINDS = {"fixed": 0, "uniform": 1, "seeded_hash": 2, "lognormal": 3}


def sample_insert_plain(start, cnt, sd, woff, smrank, pay, t, mb_rel,
                        mb_src, mb_payload, *, link: LoweredLink, s0: int,
                        s1: int, M: int, W: int, inbox_src: bool):
    """Plain version of K3: sample every valid entry of a batch sorted by
    ``(dst, woff, smrank)`` and merge it into the commutative ``[K, N]``
    mailbox. ``sd``/``woff``/``smrank`` int32 ``[S]`` and ``pay`` int32
    ``[P, S]`` are the batch (``sd = n`` past the valid entries);
    ``start``/``cnt`` int32 ``[N]`` each node's bucket; ``t`` the int64
    0-d epoch, so a message's send instant is ``t + woff``, its sender
    ``smrank // M`` and its outbox slot ``smrank % M``. Returns
    ``(mb_rel, mb_src, mb_payload, overflow, bad_delay, short_delay)``,
    the counters int32 scalars; ``bad_delay`` and ``short_delay`` count
    every valid entry, overflowed ones included. ``mb_src`` passes
    through unless ``inbox_src``."""
    n = mb_rel.shape[1]
    src = torch.div(smrank, M, rounding_mode="floor")
    flight, drel, bad, short = sample_nodrop(
        link.model, s0, s1, W, src, sd, t + woff.long(), smrank - src * M,
        woff, sd < n)
    o_rel, o_src, o_pay, ovf = mailbox_insert_plain(
        start, cnt, None, drel, src if inbox_src else None, pay, mb_rel,
        mb_src, mb_payload)
    return o_rel, o_src, o_pay, ovf, bad, short


_SAMPLE_ARGS = (_P, _P, _P, _P, _P, _I, _P,            # batch, t
                _I, _U, _I, _U, _U, _U, _U, _F, _F, _F, _F,  # link
                _U, _U, _I, _U,                          # s0, s1, M, W
                _P, _P, _P, _I, _I, _I,                  # mailbox in
                _P, _P, _P, _P, _P)                      # out, stream


def sample_insert(start, cnt, sd, woff, smrank, pay, t, mb_rel, mb_src,
                  mb_payload, *, link: LoweredLink, s0: int, s1: int,
                  M: int, W: int, inbox_src: bool):
    """K3: see :func:`sample_insert_plain` for the function. CPU tensors
    take the plain version; CUDA tensors launch
    ``csrc/sample_insert.cu`` (one CTA per tile of 256 nodes draws the
    tile's entries in turn and fills its nodes' holes; outputs freshly
    allocated). The buckets must be contiguous in node order, as
    :func:`bucket_bounds` gives them.
    ``sd`` is read only by the plain version: the kernel finds each
    node's entries through ``start``/``cnt``."""
    if traced_ops.is_fake(mb_rel):
        return traced_ops.sample_insert(start, cnt, sd, woff, smrank, pay,
                                        t, mb_rel, mb_src, mb_payload, M,
                                        W, inbox_src)
    if not _on_card(mb_rel, "sample_insert"):
        return sample_insert_plain(start, cnt, sd, woff, smrank, pay, t,
                                   mb_rel, mb_src, mb_payload, link=link,
                                   s0=s0, s1=s1, M=M, W=W,
                                   inbox_src=inbox_src)
    K, n = mb_rel.shape
    P = mb_payload.shape[1]
    S = woff.shape[0]
    dev = mb_rel.device
    for name, x, shape in (("start", start, (n,)), ("cnt", cnt, (n,)),
                           ("sd", sd, (S,)), ("woff", woff, (S,)),
                           ("smrank", smrank, (S,)), ("pay", pay, (P, S)),
                           ("mb_rel", mb_rel, (K, n)),
                           ("mb_src", mb_src, (K, n)),
                           ("mb_payload", mb_payload, (K, P, n))):
        _require(name, x, shape, dev)
    if t.dtype != torch.int64 or t.shape != () or t.device != dev:
        raise ValueError(f"t must be an int64 0-d tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= W < 2**32 or M < 1:
        raise ValueError(f"need 1 <= W < 2**32 and M >= 1, got W={W} M={M}")
    o_rel = torch.empty_like(mb_rel)
    o_pay = torch.empty_like(mb_payload)
    o_src = torch.empty_like(mb_src) if inbox_src else mb_src
    counters = torch.zeros(3, dtype=torch.int32, device=dev)
    fn = _kernel("sample_insert", "tw_sample_insert", _SAMPLE_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(start.data_ptr(), cnt.data_ptr(), woff.data_ptr(),
                smrank.data_ptr(), pay.data_ptr(), S, t.data_ptr(),
                LINK_KINDS[link.kind], link.quantum,
                int(link.model.needs_key),
                *(v & MASK32 for v in link.ints), *link.floats,
                s0 & MASK32, s1 & MASK32, M, W,
                mb_rel.data_ptr(),
                mb_src.data_ptr() if inbox_src else None,
                mb_payload.data_ptr(), n, K, P,
                o_rel.data_ptr(), o_src.data_ptr() if inbox_src else None,
                o_pay.data_ptr(), counters.data_ptr(), stream)
    _check_launch("sample_insert", rc)
    LAUNCHES["sample_insert"] += 1
    return o_rel, o_src, o_pay, counters[0], counters[1], counters[2]
