"""K3, the sample-and-insert of the fused engine
(``sample_insert_kernel``): the bytes its function needs.

Each routed entry of the sorted batch is read once with the inputs of
its delay draw, its send offset and its sender-major rank (the entropy
key and the link's parameters are scalars), and its payload words; the
mailbox slot it lands in is read and written once (deliver time and
payload; no family of the reference reads its senders, so none is
counted). Slots no entry lands
in need nothing, whatever an implementation copies. The draw's
arithmetic (three Threefry-2x32 blocks, a log, a cos and an exp an
entry) is not counted: bytes bound the count, and at the H100's rates
the draw's operations would bound it only if they were counted as well,
which would make the share harder to reach, never easier.
"""

#: the kernel's symbol, matched in the device trace's names
KERNEL = "sample_insert_kernel"


def bytes_needed(entries: int, landed: int, P: int) -> int:
    """``entries`` routed entries read once (send offset, rank and ``P``
    payload words), ``landed`` of them into a slot of ``1 + P`` words
    read and written once."""
    return 4 * ((2 + P) * entries + 2 * (1 + P) * landed)
