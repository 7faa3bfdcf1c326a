"""``launches_per_step``: kernels the device ran in the traced slice
over its supersteps (a fleet superstep serves every world). Copies and
fills (``Memcpy``, ``Memset``) are not kernels and are left out. Moves
``msgs_per_s``: the host loop launches them one by one."""


def read(ctx):
    if ctx.supersteps <= 0:
        return None
    kernels = [o for o in ctx.ops
               if not o[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / ctx.supersteps
