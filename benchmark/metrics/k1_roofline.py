"""``k1_roofline``: K1's share of its roofline in %, over the traced
slice: the bytes its function needs (``roofline/k1.py``) at the H100's
3.35 TB/s over K1's device time by symbol name. None where K1 did not
run. Moves ``msgs_per_s``."""


def read(ctx):
    return ctx.roofline_share("k1")
