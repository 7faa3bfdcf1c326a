"""Link models: per-message latency (port of ``timewarp_tpu/net/delays.py``).

A link model is a function of ``(src, dst, send_time, entropy)`` to
``(delay_µs, drop)``, written in elementwise torch ops that broadcast
over whatever layout the engine holds. Entropy is a pair of uint32 words
(int64 carriers) from ``core.rng.msg_bits``; models without randomness
declare ``needs_key = False``.

Ported so far: the drop-free models the engine's slice runs —
``FixedDelay``, ``UniformDelay``, ``LogNormalDelay``, ``Quantize`` (with
its ``>= 1 µs`` inner clamp) and ``FnDelay``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from ..core.rng import normal_f32, uniform_int

__all__ = ["LinkModel", "FixedDelay", "UniformDelay", "LogNormalDelay",
           "Quantize", "FnDelay"]


def _no_drop(dst: torch.Tensor) -> torch.Tensor:
    return torch.zeros(dst.shape, dtype=torch.bool, device=dst.device)


class LinkModel:
    """Base class. ``key`` is an ``(int64, int64)`` uint32-word pair
    (``None`` when ``needs_key`` is False)."""

    #: whether ``sample`` consumes entropy; engines skip derivation if not
    needs_key: bool = True

    def sample(self, src, dst, t, key) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (delay int64 µs, drop bool)."""
        raise NotImplementedError

    @property
    def min_delay_us(self) -> int:
        """Static lower bound on every delay this model can sample (after
        the engine's >= 1 µs clamp); windowed supersteps are exact only
        for window <= this bound."""
        return 1

    @property
    def can_drop(self) -> bool:
        """Whether ``sample`` can ever return ``drop=True``."""
        return True


@dataclass(frozen=True)
class FixedDelay(LinkModel):
    """Every message takes exactly ``delay`` µs."""
    delay: int
    needs_key = False

    def sample(self, src, dst, t, key):
        d = torch.full(dst.shape, self.delay, dtype=torch.int64,
                       device=dst.device)
        return d, _no_drop(dst)

    @property
    def min_delay_us(self) -> int:
        return max(int(self.delay), 1)

    @property
    def can_drop(self) -> bool:
        return False


@dataclass(frozen=True)
class UniformDelay(LinkModel):
    """Uniform integer delay in [lo, hi] µs. Integer-only: bit-exact on
    every backend."""
    lo: int
    hi: int

    def sample(self, src, dst, t, key):
        b0, _ = key
        return uniform_int(b0, self.lo, self.hi), _no_drop(dst)

    @property
    def min_delay_us(self) -> int:
        return max(int(self.lo), 1)

    @property
    def can_drop(self) -> bool:
        return False


@dataclass(frozen=True)
class LogNormalDelay(LinkModel):
    """Lognormal latency: delay = round(median * exp(sigma * N(0,1))),
    clipped to [floor, cap] µs. Float32 internally, so a draw may differ
    from the reference's by one rounding step where torch's and XLA's
    float32 ``log``/``exp``/``cos`` differ by an ulp."""
    median_us: int
    sigma: float
    cap_us: int = 60_000_000
    floor_us: int = 1

    def sample(self, src, dst, t, key):
        b0, b1 = key
        z = normal_f32(b0, b1)
        f32 = dict(dtype=torch.float32, device=z.device)
        d = torch.tensor(self.median_us, **f32) * torch.exp(
            torch.tensor(self.sigma, **f32) * z)
        d = torch.clamp(d, torch.tensor(float(self.floor_us), **f32),
                        torch.tensor(float(self.cap_us), **f32))
        return torch.round(d).to(torch.int64), _no_drop(dst)

    @property
    def min_delay_us(self) -> int:
        return max(int(self.floor_us), 1)

    @property
    def can_drop(self) -> bool:
        return False


@dataclass(frozen=True)
class Quantize(LinkModel):
    """Round the inner model's delays *up* to a multiple of
    ``quantum_us``. The inner draw is clamped to >= 1 µs before rounding,
    so ``min_delay_us`` (>= quantum) is a true lower bound of every
    sampled value."""
    inner: LinkModel
    quantum_us: int

    @property
    def needs_key(self):  # type: ignore[override]
        return self.inner.needs_key

    def sample(self, src, dst, t, key):
        d, drop = self.inner.sample(src, dst, t, key)
        q = int(self.quantum_us)
        d = torch.clamp(d, min=1)
        return torch.div(d + q - 1, q, rounding_mode="floor") * q, drop

    @property
    def min_delay_us(self) -> int:
        q = int(self.quantum_us)
        m = max(self.inner.min_delay_us, 1)
        return ((m + q - 1) // q) * q

    @property
    def can_drop(self) -> bool:
        return self.inner.can_drop


@dataclass(frozen=True)
class FnDelay(LinkModel):
    """Arbitrary per-link behavior from ``fn(src, dst, t, key) ->
    (delay, drop)`` in broadcasting torch ops. It may drop (the base
    class's conservative ``can_drop``), as in the reference."""
    fn: Callable

    def sample(self, src, dst, t, key):
        delay, drop = self.fn(src, dst, t, key)
        return delay.to(torch.int64), drop.to(torch.bool)
