"""``device_ms_per_step``: device busy ms (the union of the device
operations' intervals) a superstep over the traced slice. Moves
``msgs_per_s``."""


def read(ctx):
    if ctx.supersteps <= 0:
        return None
    return ctx.busy_s * 1e3 / ctx.supersteps
