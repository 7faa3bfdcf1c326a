"""The control and the faults: each cell's check at a size a test run
holds must pass the program and fail the control (the reference in the
program's place at the precision below the configuration's: Threefry
with 12 rounds for gossip, the lognormal link in bfloat16 for Praos),
and fail a run whose timed path is broken underneath: a superstep that
returns its state unchanged, half of each destination's batch left out,
and an answer altered where it is produced. The exchange between chips
does not exist in these one-chip cells."""

import pytest
import torch

from benchmark import harness, system

CELLS = ["praos-1m-general.fleet4",
         "gossip-1m.fleet8", "praos-1m.diffusion"]


def run(root, cell, seed=2**31 + 77, **kw):
    return harness.run_cell(cell, seed, 0.3, False, "cpu", root, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_control_fails(small_root, cell):
    assert run(small_root, cell)["correct"] is True
    line = run(small_root, cell, control=True)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def unchanged_state(monkeypatch):
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine

    def superstep(self, st, node_next, t, with_trace):
        return st, None, None
    monkeypatch.setattr(TorchEngine, "_superstep", superstep)


def half_batch(monkeypatch):
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    insert, sample = ci.mailbox_insert_plain, ci.sample_insert_plain

    def half_insert(start, cnt, *a, **k):
        return insert(start, cnt // 2, *a, **k)

    def half_sample(start, cnt, *a, **k):
        return sample(start, cnt // 2, *a, **k)
    monkeypatch.setattr(ci, "mailbox_insert_plain", half_insert)
    monkeypatch.setattr(ci, "sample_insert_plain", half_sample)


def altered_answer(monkeypatch):
    build = system.scenario

    def scenario(config):
        sc = build(config)
        step = sc.step

        def altered(states, inbox, now, ids, bits):
            new, out, wake = step(states, inbox, now, ids, bits)
            bump = (ids % 97 == 5).to(out.payload.dtype)
            return new, out._replace(payload=out.payload + bump), wake
        sc.step = altered
        return sc
    monkeypatch.setattr(system, "scenario", scenario)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(small_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run(small_root, cell)
    assert line["correct"] is False, line["checks"]


def late_leader(monkeypatch):
    """Praos' leadership draw wrong from the second slot boundary on, so
    that the warm-up's first boundary does not see it, nor a compared
    chunk that holds no boundary."""
    build = system.scenario

    def scenario(config):
        sc = build(config)
        step = sc.step

        def altered(states, inbox, now, ids, bits):
            new, out, wake = step(states, inbox, now, ids, bits)
            late = (new["slot"] > states["slot"]) & (states["slot"] >= 1)
            return dict(new, best=new["best"] + late.to(torch.int32)), \
                out, wake
        sc.step = altered
        return sc
    monkeypatch.setattr(system, "scenario", scenario)


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("praos")])
def test_fault_at_a_later_slot_is_not_correct(small_root, monkeypatch,
                                              cell):
    late_leader(monkeypatch)
    line = run(small_root, cell)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["warm_diff"]["value"] == 0
