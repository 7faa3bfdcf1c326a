"""``k3_roofline``: K3's share of its roofline in %, over the traced
slice: the bytes its function needs (``roofline/k3.py``) at the H100's
3.35 TB/s over K3's device time by symbol name. None where K3 did not
run. Moves ``msgs_per_s``."""


def read(ctx):
    return ctx.roofline_share("k3")
