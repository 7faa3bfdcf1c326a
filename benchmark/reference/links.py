"""The link models a configuration file names, as plain draws.

A link is a JSON object: ``{"kind": "uniform", "lo": .., "hi": ..}``,
``{"kind": "lognormal", "median_us": .., "sigma": .., "cap_us": ..,
"floor_us": ..}``, ``{"kind": "fixed", "delay": ..}``, or ``{"kind":
"quantize", "quantum_us": .., "inner": LINK}``. ``draw`` returns each
message's delay in µs (int64) from its two entropy words; ``floor``
is the least delay the model can give (after the 1 µs clamp).
"""

from __future__ import annotations

import torch

from .rng import normal, uniform_int


def draw(link: dict, b0: torch.Tensor, b1: torch.Tensor,
         float_dtype=torch.float32) -> torch.Tensor:
    kind = link["kind"]
    if kind == "fixed":
        return torch.full_like(b0, int(link["delay"]))
    if kind == "uniform":
        return uniform_int(b0, int(link["lo"]), int(link["hi"]))
    if kind == "lognormal":
        def c(x):
            return torch.tensor(float(x), dtype=float_dtype,
                                device=b0.device)
        z = normal(b0, b1, float_dtype)
        d = c(link["median_us"]) * torch.exp(c(link["sigma"]) * z)
        d = torch.clamp(d, c(link["floor_us"]), c(link["cap_us"]))
        return torch.round(d).to(torch.int64)
    if kind == "quantize":
        q = int(link["quantum_us"])
        d = torch.clamp(draw(link["inner"], b0, b1, float_dtype), min=1)
        return torch.div(d + q - 1, q, rounding_mode="floor") * q
    raise ValueError(f"no reference draw for link kind {kind!r}")


def floor(link: dict) -> int:
    kind = link["kind"]
    if kind == "fixed":
        return max(int(link["delay"]), 1)
    if kind == "uniform":
        return max(int(link["lo"]), 1)
    if kind == "lognormal":
        return max(int(link["floor_us"]), 1)
    if kind == "quantize":
        q = int(link["quantum_us"])
        return -(-floor(link["inner"]) // q) * q
    raise ValueError(f"no reference floor for link kind {kind!r}")
