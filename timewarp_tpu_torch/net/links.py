"""The ``--link`` spec grammar (port of ``timewarp_tpu/net/links.py``):
one parser that builds the port's link models (net/delays.py).

Malformed specs die with a ``SystemExit`` naming :data:`LINK_GRAMMAR`,
never a raw IndexError/ValueError; library callers that want an
exception catch the SystemExit.
"""

from __future__ import annotations

__all__ = ["LINK_GRAMMAR", "parse_link"]

#: the --link grammar, named in every parse error
LINK_GRAMMAR = ("fixed:D | uniform:LO:HI | lognormal:MEDIAN:SIGMA | "
                "pareto:XM:ALPHA | "
                "drop:P:<inner> | quantize:Q:<inner> | never  "
                "(D/LO/HI/MEDIAN/XM/Q integer µs; P/SIGMA/ALPHA float; "
                "never = drop probability 1, the old NeverConnected)")


def parse_link(spec: str):
    """``fixed:D`` | ``uniform:LO:HI`` | ``lognormal:MEDIAN:SIGMA`` |
    ``pareto:XM:ALPHA`` — optionally wrapped ``drop:P:<inner>`` and/or
    ``quantize:Q:<inner>``; ``never`` is the fully severed link
    (``WithDrop(FixedDelay(1), NEVER_CONNECTED)``). Malformed specs die
    with a message naming the grammar."""
    from .delays import (NEVER_CONNECTED, FixedDelay, LogNormalDelay,
                         ParetoDelay, Quantize, UniformDelay, WithDrop)
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind == "never":
            if len(parts) != 1:
                raise ValueError("never takes no parameters (every "
                                 "message is dropped)")
            return WithDrop(FixedDelay(1), NEVER_CONNECTED)
        if kind == "drop":
            if len(parts) < 3 or not parts[2]:
                raise ValueError("drop needs a probability and an "
                                 "inner spec")
            return WithDrop(parse_link(":".join(parts[2:])),
                            float(parts[1]))
        if kind == "quantize":
            if len(parts) < 3 or not parts[2]:
                raise ValueError("quantize needs a grid and an "
                                 "inner spec")
            return Quantize(parse_link(":".join(parts[2:])),
                            int(parts[1]))
        if kind == "fixed":
            if len(parts) != 2:
                raise ValueError("fixed takes exactly one delay")
            return FixedDelay(int(parts[1]))
        if kind == "uniform":
            if len(parts) != 3:
                raise ValueError("uniform takes exactly LO and HI")
            return UniformDelay(int(parts[1]), int(parts[2]))
        if kind == "lognormal":
            if len(parts) != 3:
                raise ValueError("lognormal takes exactly MEDIAN "
                                 "and SIGMA")
            return LogNormalDelay(int(parts[1]), float(parts[2]))
        if kind == "pareto":
            if len(parts) != 3:
                raise ValueError("pareto takes exactly XM and ALPHA")
            xm, alpha = int(parts[1]), float(parts[2])
            if xm < 1:
                raise ValueError(f"pareto XM must be >= 1 µs, got {xm}")
            if not alpha > 0:
                raise ValueError(
                    f"pareto ALPHA must be > 0, got {alpha}")
            return ParetoDelay(xm, alpha)
    except SystemExit:
        raise                   # an inner spec already named the grammar
    except (IndexError, ValueError) as e:
        raise SystemExit(
            f"malformed link spec {spec!r} ({e}); "
            f"grammar: {LINK_GRAMMAR}") from None
    raise SystemExit(
        f"unknown link spec kind {kind!r} in {spec!r}; "
        f"grammar: {LINK_GRAMMAR}")
