"""K1, the mailbox insertion (``mailbox_insert_kernel``): the bytes its
function needs.

Inserting a destination-sorted batch into the ``[K, N]`` mailboxes needs
each routed entry read once (its deliver time and payload words) and the
mailbox slot it lands in read and written once (the same words). No
family of the reference reads its senders (its superstep keeps no
sender), so none is counted; a family whose inbox reads them needs a
count of its own. Slots no entry lands in need
nothing: a kernel that copies the whole mailbox, as an out-of-place one
does, moves bytes of its own choosing, which this count leaves out. The
count is the same whatever kernel or path does the insertion. Bytes
bound it: the function does no arithmetic to speak of.
"""

#: the kernel's symbol, matched in the device trace's names
KERNEL = "mailbox_insert_kernel"


def bytes_needed(entries: int, landed: int, P: int) -> int:
    """``entries`` routed entries read once, ``landed`` of them into a
    slot read and written once; an entry and a slot are ``1 + P`` int32
    words (deliver time and payload)."""
    return 4 * (1 + P) * (entries + 2 * landed)
