"""The kernels' byte counts against a hand count on a tiny mailbox."""

import torch

from benchmark import harness
from benchmark.reference.engine import I32MAX, RefEngine


def tiny_landing():
    """Two nodes with K = 2 slots and one payload word: node 0 has one
    free slot, node 1 two. Four messages: three to node 0 (one lands,
    two overflow), one to node 1 (lands)."""
    mb_rel = torch.tensor([[[5, I32MAX], [I32MAX, I32MAX]]],
                          dtype=torch.int32)
    mb_pay = torch.zeros((1, 2, 1, 2), dtype=torch.int32)
    ok = torch.ones((1, 1, 4), dtype=torch.bool)
    dst = torch.tensor([[[0, 0, 1, 0]]])
    woff = torch.zeros((1, 1, 4), dtype=torch.int64)
    rank = torch.arange(4)[None, None, :]
    land = torch.full((1, 1, 4), 9, dtype=torch.int64)
    pay = torch.arange(4, dtype=torch.int32).view(1, 1, 1, 4)
    eng = RefEngine.__new__(RefEngine)
    rel, _, overflow = eng._land(mb_rel, mb_pay, ok, dst, woff, rank, land,
                                 pay)
    landed = int((rel < I32MAX).sum()) - int((mb_rel < I32MAX).sum())
    return 4, landed, int(overflow)


def test_tiny_mailbox_counts():
    entries, landed, overflow = tiny_landing()
    assert (entries, landed, overflow) == (4, 2, 2)


def test_k1_bytes_by_hand(small_root):
    k1 = harness.Bench(small_root).roofline("k1")
    entries, landed, _ = tiny_landing()
    # each entry: deliver time + 1 payload word = 8 bytes, read once (32);
    # each landed slot: 8 bytes read and 8 written (2 x 16 = 32)
    assert k1.bytes_needed(entries, landed, 1) == 32 + 32
    # Praos' two payload words: 12-byte entries and slots
    assert k1.bytes_needed(entries, landed, 2) == 48 + 48
    assert k1.KERNEL == "mailbox_insert_kernel"


def test_k3_bytes_by_hand(small_root):
    k3 = harness.Bench(small_root).roofline("k3")
    entries, landed, _ = tiny_landing()
    # each entry: send offset, rank and 1 payload word = 12 bytes (48);
    # each landed slot: deliver time + payload = 8 bytes read, 8 written
    assert k3.bytes_needed(entries, landed, 1) == 48 + 32
    # Praos' two payload words: 16-byte entries, 12-byte slots
    assert k3.bytes_needed(entries, landed, 2) == 64 + 48
    assert k3.KERNEL == "sample_insert_kernel"
