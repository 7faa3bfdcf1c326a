"""Link models: per-message latency (port of ``timewarp_tpu/net/delays.py``).

A link model is a function of ``(src, dst, send_time, entropy)`` to
``(delay_µs, drop)``, written in elementwise torch ops that broadcast
over whatever layout the engine holds. A fleet's swept parameters
(batched.py ``rebind_link``) are ``[B, 1]`` tensors that broadcast over
its ``[B, S]`` messages. Entropy is a pair of uint32 words
(int64 carriers) from ``core.rng.msg_bits``; models without randomness
declare ``needs_key = False``.

Every model of the reference is ported: ``FixedDelay``,
``UniformDelay``, ``LogNormalDelay``, ``ParetoDelay``, ``WithDrop``,
``Quantize`` (with its ``>= 1 µs`` inner clamp), ``SeededHashUniform``
and ``FnDelay``. The float models (lognormal, Pareto) are float32 inside
and may differ from the reference by one rounding step on a draw where
torch's and XLA's float32 ``log``/``exp``/``cos`` differ by an ulp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from ..core.rng import (bernoulli, normal_f32, seed_words, split_bits,
                        threefry2x32, uniform_int)
from ..ops.numeric import thi, tlo

__all__ = ["LinkModel", "FixedDelay", "UniformDelay", "LogNormalDelay",
           "ParetoDelay", "WithDrop", "Quantize", "SeededHashUniform",
           "FnDelay", "NEVER_CONNECTED"]

#: drop probability 1 (the reference's ``NeverConnected`` outcome)
NEVER_CONNECTED = 1.0


def _no_drop(dst: torch.Tensor) -> torch.Tensor:
    return torch.zeros(dst.shape, dtype=torch.bool, device=dst.device)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A parameter as float32: a Python number, or a fleet's per-world
    ``[B, 1]`` tensor (cast as the reference casts its float64 vector)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=like.device)


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
        if isinstance(self.delay, torch.Tensor):
            # a fleet's per-world delays, ``[B, 1]`` (batched.py)
            d = self.delay.to(torch.int64).expand(dst.shape).clone()
        else:
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
        d = _f32(self.median_us, z) * torch.exp(_f32(self.sigma, z) * z)
        d = torch.clamp(d, _f32(float(self.floor_us), z),
                        _f32(float(self.cap_us), z))
        return torch.round(d).to(torch.int64), _no_drop(dst)

    @property
    def min_delay_us(self) -> int:
        return max(int(self.floor_us), 1)

    @property
    def can_drop(self) -> bool:
        return False


@dataclass(frozen=True)
class ParetoDelay(LinkModel):
    """Pareto latency (heavy upper tail): delay = round(xm · U^(-1/alpha))
    clamped to [max(floor, 1), cap] µs, U a 24-bit uniform in (0, 1).
    ``min_delay_us`` declares ``floor_us``, not ``xm_us``, as the
    reference does. Float32 inside, like :class:`LogNormalDelay`."""
    xm_us: int
    alpha: float
    cap_us: int = 60_000_000
    floor_us: int = 1

    def sample(self, src, dst, t, key):
        b0, _ = key
        u = (b0 >> 8).to(torch.float32) * _f32(2.0 ** -24, b0) \
            + _f32(2.0 ** -25, b0)
        d = _f32(self.xm_us, u) * torch.exp(
            (_f32(-1.0, u) / _f32(self.alpha, u)) * torch.log(u))
        d = torch.clamp(d, torch.maximum(_f32(self.floor_us, u),
                                         _f32(1.0, u)),
                        _f32(self.cap_us, u))
        return torch.round(d).to(torch.int64), _no_drop(dst)

    @property
    def min_delay_us(self) -> int:
        return max(int(self.floor_us), 1)

    @property
    def can_drop(self) -> bool:
        return False


@dataclass(frozen=True)
class WithDrop(LinkModel):
    """Wrap a model with i.i.d. message loss: ``drop_prob`` from the
    first entropy word (an integer threshold compare, bit-exact), the
    inner model fed an independent substream (``split_bits``).
    ``drop_prob=1`` is ``NEVER_CONNECTED``."""
    inner: LinkModel
    drop_prob: float

    def sample(self, src, dst, t, key):
        b0, b1 = key
        drop = bernoulli(b0, self.drop_prob)
        delay, inner_drop = self.inner.sample(
            src, dst, t, split_bits(b0, b1, 0x1A7E5EED))
        return delay, drop | inner_drop

    @property
    def min_delay_us(self) -> int:
        return self.inner.min_delay_us


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
        q = self.quantum_us    # an int, or a fleet's [B, 1] tensor
        q = q if isinstance(q, torch.Tensor) else int(q)
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
class SeededHashUniform(LinkModel):
    """Uniform ``[lo_us, hi_us]`` delay from a self-contained threefry
    hash of ``(dst, t)`` under the model's own ``salt``: it needs no
    message key, so the same model gives the same delays whatever the
    sender or outbox slot. The salt's two words are expanded once, at
    construction."""
    lo_us: int
    hi_us: int
    salt: int = 0
    needs_key = False

    def __post_init__(self):
        s0, s1 = seed_words(self.salt)
        object.__setattr__(self, "_s0", s0)
        object.__setattr__(self, "_s1", s1)

    def sample(self, src, dst, t, key):
        t64 = torch.as_tensor(t, dtype=torch.int64, device=dst.device)
        bits, _ = threefry2x32(self._s0 ^ (dst.to(torch.int64) & 0xFFFFFFFF),
                               self._s1, tlo(t64), thi(t64))
        return uniform_int(bits, self.lo_us, self.hi_us), _no_drop(dst)

    @property
    def min_delay_us(self) -> int:
        return int(self.lo_us)

    @property
    def can_drop(self) -> bool:
        return False


@dataclass(frozen=True)
class FnDelay(LinkModel):
    """Arbitrary per-link behavior from ``fn(src, dst, t, key) ->
    (delay, drop)`` in broadcasting torch ops. It may drop (the base
    class's conservative ``can_drop``), as in the reference."""
    fn: Callable

    def sample(self, src, dst, t, key):
        delay, drop = self.fn(src, dst, t, key)
        return delay.to(torch.int64), drop.to(torch.bool)
