"""Predictive bucket packing: superstep forecasting + slot allocation
(the port's copy of ``timewarp_tpu/pack/__init__.py``).

The serving core admits worlds with zero recompiles (r20), but
placement was first-fit by arrival order — so heterogeneous packs
waste throughput two ways the ``bucket_util`` journal already
measures: pow2 scan-pad waste when a short world shares a bucket with
a long one, and budget-mask inefficiency when quiesced slots idle
until the whole bucket drains. This package closes that gap:

- :mod:`predict` — a deterministic superstep forecaster fit from
  run-ledger history (``RunLedger`` ``pack_stats`` rows, assembled at
  ingest from each run's ``world_done`` results + configs). Fitted
  coefficients save as a **sha-stamped artifact**, so a prediction is
  a pure function of ``(features, artifact)`` — the TempoNet
  decision-source discipline. With no artifact (or no matching
  history) the forecast falls back to the config's **budget**,
  honestly: never a fabricated number, always the documented upper
  bound.
- :mod:`allocate` — the packing planner: best-fit-decreasing by
  predicted supersteps behind ``--pack first-fit|predicted``
  (``sweep/bucket.plan_buckets``), plus the serve-side placement
  scorer (``ServeFrontend`` picks the open bucket whose predicted
  remaining horizon best matches an admitted config).

Every packing *choice* that is not a pure function of the pack alone
journals as a ``pack_decision`` event **before** its effect, so
resume/steal replay it bit-identically (sweep/journal.py). The
extended survival law (results independent of bucketing) makes
correctness free — packing is pure throughput.
"""

from .allocate import (PACK_MODE_GRAMMAR, PACK_MODES, predicted_order,
                       validate_pack_mode)
from .predict import (PackFitError, feature_key, fit_rows,
                      load_artifact, pack_features, predict_supersteps,
                      save_artifact, training_rows)

__all__ = ["PACK_MODES", "PACK_MODE_GRAMMAR", "validate_pack_mode",
           "predicted_order", "pack_features", "feature_key",
           "predict_supersteps", "fit_rows", "training_rows",
           "save_artifact", "load_artifact", "PackFitError"]
