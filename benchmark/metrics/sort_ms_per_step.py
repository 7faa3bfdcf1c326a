"""``sort_ms_per_step``: device ms a superstep in the sort kernels that
order the routed batch and the live senders (torch's radix, segmented
and bitonic sorts and their helpers), from the traced slice. Matched by
name: a kernel whose name holds ``sort`` in any case and is none of the
``searchsorted`` kernels (the bucket bounds, not a sort). Moves
``msgs_per_s``."""

import re

#: what a sort kernel's name holds, and what it must not
INCLUDE = re.compile(r"sort", re.IGNORECASE)
EXCLUDE = re.compile(r"searchsorted", re.IGNORECASE)


def read(ctx):
    if ctx.supersteps <= 0:
        return None
    us = sum(e - s for n, s, e in ctx.ops
             if INCLUDE.search(n) and not EXCLUDE.search(n))
    if us <= 0:
        return None
    return us / 1e3 / ctx.supersteps
