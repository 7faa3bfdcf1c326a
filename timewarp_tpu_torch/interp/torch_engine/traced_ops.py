"""The hand-written kernels as opaque nodes of the sanitizer's graphs.

The analysis package (analysis/determinism.py) traces an engine's
superstep with ``make_fx(tracing_mode="fake")``. The kernels K1-K4 are
``ctypes`` calls on raw device pointers (utils/build.py), which a fake
tensor has none of, and their plain versions compute data-dependent
shapes. So each wrapper hands a *fake* call to the custom op here
instead: one ``tw.*`` node whose outputs have the kernel's shapes and
dtypes, the same node whether the engine lives on the card or on the
CPU. A real call never comes here — the wrappers launch the kernel or
run its plain version, exactly as before — so these ops only stand in
a graph that is read, never run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["is_fake", "fire_compact", "mailbox_insert", "sample_insert",
           "fused_ring"]


def is_fake(x) -> bool:
    """True for a tensor of a fake trace (no storage: the sanitizer's)."""
    return isinstance(x, FakeTensor)


def _trace_only(name: str):
    raise RuntimeError(
        f"tw::{name} stands for its kernel in traced graphs only; call "
        "the wrapper in interp/torch_engine/cuda_insert.py or "
        "cuda_ring.py")


@torch.library.custom_op("tw::fire_compact", mutates_args=())
def fire_compact(pdst: Tensor, woff_n: Optional[Tensor], payload: Tensor,
                 S: int) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K2 (cuda_insert.fire_compact)."""
    _trace_only("fire_compact")


@fire_compact.register_fake
def _(pdst, woff_n, payload, S):
    lead = tuple(pdst.shape[:-2])
    P = payload.shape[-2]
    return (pdst.new_empty(lead + (S,)), pdst.new_empty(lead + (S,)),
            pdst.new_empty(lead + (S,)), pdst.new_empty(lead + (P, S)),
            pdst.new_empty(lead))


@torch.library.custom_op("tw::mailbox_insert", mutates_args=())
def mailbox_insert(start: Tensor, cnt: Tensor, counts: Optional[Tensor],
                   drel: Tensor, src: Optional[Tensor], pay: Tensor,
                   mb_rel: Tensor, mb_src: Tensor, mb_payload: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K1 (cuda_insert.mailbox_insert)."""
    _trace_only("mailbox_insert")


@mailbox_insert.register_fake
def _(start, cnt, counts, drel, src, pay, mb_rel, mb_src, mb_payload):
    return (torch.empty_like(mb_rel), torch.empty_like(mb_src),
            torch.empty_like(mb_payload),
            mb_rel.new_empty(tuple(mb_rel.shape[:-2])))


@torch.library.custom_op("tw::sample_insert", mutates_args=())
def sample_insert(start: Tensor, cnt: Tensor, sd: Tensor, woff: Tensor,
                  smrank: Tensor, pay: Tensor, t: Tensor, mb_rel: Tensor,
                  mb_src: Tensor, mb_payload: Tensor, M: int, W: int,
                  inbox_src: bool
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                             Tensor]:
    """K3 (cuda_insert.sample_insert; the link's lowered parameters and
    the seed words are the kernel's scalars, left out of the node)."""
    _trace_only("sample_insert")


@sample_insert.register_fake
def _(start, cnt, sd, woff, smrank, pay, t, mb_rel, mb_src, mb_payload,
      M, W, inbox_src):
    def scalar():
        return mb_rel.new_empty(())
    return (torch.empty_like(mb_rel), torch.empty_like(mb_src),
            torch.empty_like(mb_payload), scalar(), scalar(), scalar())


@torch.library.custom_op("tw::fused_ring", mutates_args=())
def fused_ring(planes: Tensor, t: int, alive: bool, think: int,
               drel: int) -> Tuple[Tensor, Tensor]:
    """K4 (cuda_ring.fused_ring)."""
    _trace_only("fused_ring")


@fused_ring.register_fake
def _(planes, t, alive, think, drel):
    return (torch.empty_like(planes),
            planes.new_empty((2,), dtype=torch.int64))
