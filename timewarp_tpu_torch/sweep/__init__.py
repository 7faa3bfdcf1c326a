"""Fault-tolerant sweep service for heterogeneous world packs
(the port's copy of ``timewarp_tpu/sweep/__init__.py``).

The production face of the emulator (ROADMAP "emulation-as-a-service";
Revati's frame in PAPERS.md — the time-warp emulator as the
high-traffic system): accept a pack of heterogeneous run configs
(differing n_nodes, budgets, link sweeps, fault schedules, scenario
families), shape-bucket them into batched engines (bucket.py: one
``TorchEngine(batch=BatchSpec(...), faults=FaultFleet(...))`` a
bucket, on the card unless ``device="cpu"``), and execute under a
JobCurator supervision loop
(service.py) with watchdog timeouts, bounded retry + backoff,
OOM-degradation bucket splitting, and a crash-safe journal
(journal.py) that streams per-world results as worlds quiesce and
resumes a killed sweep exactly.

The contract that makes it trustworthy — the **sweep survival law**:
every world's streamed result record is bit-identical to the solo run
of that config, regardless of bucketing, per-world budgets, retries,
splits, or resume boundaries (docs/sweeps.md; tests/test_zsweep.py).
"""

from .bucket import Bucket, build_bucket_engine, plan_buckets
from .journal import SweepJournal, SweepJournalError
from .runner import BucketRunner
from .service import (InjectPlan, SimulatedOOM, SimulatedTransient,
                      SweepKilled, SweepReport, SweepService)
from .spec import (RunConfig, SweepConfigError, SweepPack, chain_digest,
                   solo_engine, solo_result)

__all__ = [
    "RunConfig", "SweepPack", "SweepConfigError",
    "Bucket", "plan_buckets", "build_bucket_engine",
    "SweepJournal", "SweepJournalError", "BucketRunner",
    "SweepService", "SweepReport", "SweepKilled",
    "SimulatedTransient", "SimulatedOOM", "InjectPlan",
    "chain_digest", "solo_engine", "solo_result",
]
