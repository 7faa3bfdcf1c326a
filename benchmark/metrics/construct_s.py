"""``construct_s``: seconds of set-up spent building the cell's engine
(its constructor, the scenario's construction lint included), from the
benchmark's span around the call. Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("construct")
