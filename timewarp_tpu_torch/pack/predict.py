"""Deterministic superstep forecasting from run-ledger history
(the port's copy of ``timewarp_tpu/pack/predict.py``).

A world's *budget* is its superstep upper bound; how many supersteps
it actually runs before quiescing is what packing cares about — a
gossip burst quiesces in a fraction of its budget, a token ring runs
to the wire. The forecaster learns the **realized-fraction** of the
budget per feature key from history the ledger already holds:

- **features** (:func:`pack_features`): scenario family, node count,
  link signature + sweepable link values, fault-schedule summary
  (crash/partition/link-window row counts), resolved window. Exactly
  the facts that determine a world's quiescence behavior and are
  statically known at admission time.
- **labels**: the ``supersteps`` field of journaled ``world_done``
  results. ``timewarp-tpu ledger add <journal>`` assembles
  ``(features, budget, supersteps)`` rows (``pack_stats``) at ingest,
  so every sweep/serve run already archived is training data.
- **model** (:func:`fit_rows`): mean realized-fraction per exact
  feature key, backed off to per-family, backed off to global — three
  nested means, no iterative fitting, bit-deterministic from the row
  multiset.

The fitted coefficients save as a **sha-stamped artifact**
(:func:`save_artifact` / :func:`load_artifact` — the sha covers the
coefficient payload, so a tampered or torn artifact is refused
loudly). :func:`predict_supersteps` is then a *pure function* of
``(config, artifact)``: same config + same artifact = same forecast,
on every host, across resume — which is what lets the packing planner
stay deterministic (allocate.py) and the journaled ``pack_decision``
records replay bit-identically.

**The honest fallback:** with ``artifact=None``, or a key/family the
artifact never saw, the forecast is the config's **budget** — the
provable upper bound, never an invented number. First-fit behavior
degrades gracefully into budget-ordered packing, which is still the
right relative order for budget-dominated packs.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional

from ..sweep.spec import (RunConfig, SweepConfigError, link_signature,
                          link_sweep_params, resolve_window)

__all__ = ["pack_features", "feature_key", "training_rows",
           "fit_rows", "fit_from_ledger", "predict_supersteps",
           "save_artifact", "load_artifact", "PackFitError",
           "ARTIFACT_KIND"]

#: artifact self-identification (the loader refuses anything else)
ARTIFACT_KIND = "timewarp-pack-predictor"

#: coefficient schema version — bumped when the model form changes
ARTIFACT_VERSION = 1


class PackFitError(ValueError):
    """Fitting was asked for but the history cannot support it (no
    ledger, no ingested runs, no per-world rows) — always actionable,
    never a silent empty artifact."""


def pack_features(cfg: RunConfig) -> Dict[str, Any]:
    """The statically-known facts that determine a world's quiescence
    behavior — the forecaster's feature vector. Pure function of the
    config (window resolution included); raises
    :class:`SweepConfigError` for a config that does not parse."""
    link = cfg.parse_link()
    sched = cfg.parse_faults()
    return {
        "family": cfg.family,
        "nodes": int(dict(cfg.params).get("nodes", 0) or 0),
        "link": repr(link_signature(link)),
        "link_params": {k: float(v) for k, v in
                        sorted(link_sweep_params(link).items())},
        "faults": ([0, 0, 0] if sched is None else
                   [len(sched.crashes), len(sched.partitions),
                    len(sched.link_windows)]),
        "window": int(resolve_window(cfg)),
    }


def feature_key(cfg: RunConfig) -> str:
    """Canonical (sorted-key JSON) string of :func:`pack_features` —
    the exact-match grouping key for fitting and prediction."""
    return json.dumps(pack_features(cfg), sort_keys=True)


def training_rows(configs: Iterable[RunConfig],
                  done: Mapping[str, Mapping[str, Any]]) -> List[dict]:
    """Assemble ``(key, family, budget, supersteps)`` rows from a
    run's configs and its journaled ``world_done`` results — what the
    ledger stores as ``pack_stats`` at ingest. Configs without a
    result (unfinished, failed) and configs that no longer parse are
    skipped: ingest is best-effort archival, never a refusal."""
    rows: List[dict] = []
    for cfg in configs:
        res = done.get(cfg.run_id)
        if not isinstance(res, Mapping) or "supersteps" not in res:
            continue
        try:
            key = feature_key(cfg)
        except SweepConfigError:
            continue
        rows.append({"key": key, "family": cfg.family,
                     "budget": int(cfg.budget),
                     "supersteps": int(res["supersteps"])})
    return rows


def _mean_fraction(rows: List[dict]) -> Dict[str, Any]:
    fracs = [min(1.0, r["supersteps"] / r["budget"])
             for r in rows if r["budget"] > 0]
    if not fracs:
        return {"fraction": 1.0, "n": 0}
    return {"fraction": round(sum(fracs) / len(fracs), 6),
            "n": len(fracs)}


def fit_rows(rows: List[dict]) -> Dict[str, Any]:
    """Fit the three nested realized-fraction means (module
    docstring) from training rows. Deterministic: the coefficients
    depend only on the row multiset, never on iteration order.
    Raises :class:`PackFitError` on an empty row set — an artifact
    that predicts from nothing would silently shadow the honest
    budget fallback."""
    rows = [r for r in rows
            if isinstance(r, Mapping) and r.get("budget")
            and r.get("supersteps") is not None and r.get("key")]
    if not rows:
        raise PackFitError(
            "no per-world training rows — ingest finished runs first "
            "(`timewarp-tpu ledger add <journal-dir> --ledger DIR`), "
            "then re-run `pack fit`")
    by_key: Dict[str, List[dict]] = {}
    by_family: Dict[str, List[dict]] = {}
    for r in rows:
        by_key.setdefault(r["key"], []).append(r)
        by_family.setdefault(str(r.get("family", "?")), []).append(r)
    coeffs = {
        "version": ARTIFACT_VERSION,
        "keys": {k: _mean_fraction(v)
                 for k, v in sorted(by_key.items())},
        "families": {f: _mean_fraction(v)
                     for f, v in sorted(by_family.items())},
        "global": _mean_fraction(rows),
    }
    return {"artifact": ARTIFACT_KIND, "rows": len(rows),
            **coeffs, "sha": _coeff_sha(coeffs)}


def fit_from_ledger(ledger_root: str) -> Dict[str, Any]:
    """Fit an artifact from every ``pack_stats`` row the ledger
    holds (sweep and serve ingests alike), read through the port's
    :class:`~timewarp_tpu_torch.obs.ledger.RunLedger`. Loud,
    actionable refusals for an absent/empty ledger — the `pack fit`
    CLI surfaces them verbatim as its one-line error."""
    from ..obs.ledger import RunLedger
    index_path = os.path.join(ledger_root, "index.jsonl")
    if not os.path.exists(index_path):
        raise PackFitError(
            f"{ledger_root!r} is not a run ledger (no index.jsonl) — "
            "create one by ingesting a finished run: `timewarp-tpu "
            f"ledger add <journal-dir> --ledger {ledger_root}`")
    rows: List[dict] = []
    for rec in RunLedger(ledger_root).index():
        for kind in ("sweep", "serve"):
            block = rec.get(kind)
            if isinstance(block, Mapping):
                rows.extend(r for r in block.get("pack_stats", ())
                            if isinstance(r, Mapping))
    if not rows:
        raise PackFitError(
            f"ledger {ledger_root!r} holds no pack_stats rows (no "
            "ingested sweep/serve runs with per-world results) — run "
            "a sweep, `timewarp-tpu ledger add <journal-dir> "
            f"--ledger {ledger_root}`, then re-run `pack fit`")
    return fit_rows(rows)


def _coeff_sha(coeffs: Mapping[str, Any]) -> str:
    payload = {k: coeffs[k] for k in ("version", "keys", "families",
                                      "global")}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def save_artifact(artifact: Mapping[str, Any], path: str) -> str:
    """Atomically write the sha-stamped artifact; returns its sha."""
    from ..utils.checkpoint import atomic_write

    def write(f):
        json.dump(dict(artifact), f, indent=1, sort_keys=True)
        f.write("\n")
    atomic_write(path, write, mode="w")
    return str(artifact["sha"])


def load_artifact(path: str) -> Dict[str, Any]:
    """Load and VERIFY an artifact: wrong kind, missing coefficients,
    or a sha that does not match the payload is refused loudly — a
    silently-corrupt predictor would skew every packing decision
    downstream of it."""
    try:
        with open(path) as f:
            art = json.load(f)
    except OSError as e:
        raise ValueError(
            f"pack artifact {path!r} is unreadable: {e}") from None
    except json.JSONDecodeError as e:
        raise ValueError(
            f"pack artifact {path!r} is not JSON ({e}) — refit with "
            "`timewarp-tpu pack fit`") from None
    if not isinstance(art, dict) \
            or art.get("artifact") != ARTIFACT_KIND:
        raise ValueError(
            f"{path!r} is not a {ARTIFACT_KIND} artifact — fit one "
            "with `timewarp-tpu pack fit --ledger DIR --out PATH`")
    try:
        want = _coeff_sha(art)
    except KeyError as e:
        raise ValueError(
            f"pack artifact {path!r} is missing coefficient block "
            f"{e} — refit with `timewarp-tpu pack fit`") from None
    if art.get("sha") != want:
        raise ValueError(
            f"pack artifact {path!r} FAILED its sha check (stamped "
            f"{str(art.get('sha'))[:12]}.., payload hashes to "
            f"{want[:12]}..) — the file was modified after fitting; "
            "refit with `timewarp-tpu pack fit`")
    return art


def predict_supersteps(cfg: RunConfig,
                       artifact: Optional[Mapping[str, Any]] = None
                       ) -> int:
    """The forecast: a PURE function of ``(config, artifact)``.
    Exact-key mean fraction, else the family mean, else the global
    mean, else — and always with ``artifact=None`` — the config's
    budget (the honest fallback, module docstring). Clamped to
    ``[1, budget]``: a forecast must never promise more work than the
    budget allows, nor less than one superstep."""
    budget = int(cfg.budget)
    if artifact is None:
        return max(1, budget)
    ent = artifact.get("keys", {}).get(feature_key(cfg)) \
        or artifact.get("families", {}).get(cfg.family) \
        or artifact.get("global")
    if not ent or not ent.get("n"):
        return max(1, budget)
    return max(1, min(budget,
                      int(round(float(ent["fraction"]) * budget))))
