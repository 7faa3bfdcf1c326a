"""``idle_share``: the share in % of the traced slice's wall time in
which no operation ran on the device (1 - the union of the device
operations' intervals over the slice). Moves ``msgs_per_s``: it is the
room a faster host loop can use."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
