"""Plan lint (TW6xx): fleet-scale pre-flight verification of sweep
packs and serve submissions (port of
``timewarp_tpu/analysis/plan_lint.py`` over the port's ``sweep/spec.py``
packs).

Everything the sweep service or the serving frontend would reject
*mid-bucket* — after JSON parsing succeeded, after engines compiled —
is statically decidable from the pack alone, because every refusal in
the runtime path (engine.py window validation, speculation floor
checks, the bucketer's shape keys) is a pure function of the config.
This module mirrors those decisions without building a single engine:

- **TW600** (error) — a pack entry does not parse (the PACK_GRAMMAR
  contract, sweep/spec.py): unknown family/param, controller x
  speculate, malformed link/fault/speculate specs, duplicate run_ids.
  Parse failures become findings instead of exceptions so one broken
  entry never hides the rest of the report.
- **TW601** (info) — the predicted bucket plan: worlds -> buckets
  (= engine builds), fleet widths, resolved windows, fault-pad
  shapes. The number the zero-recompile serving contract (r20) is
  about, made visible before anything compiles.
- **TW602** (error) — an explicit window the engine would refuse:
  wider than the link floor, *degraded by the config's own fault
  schedule* for static configs (a degrade window undercutting the
  declared floor is the classic mid-bucket surprise); controller /
  speculate configs validate against the undegraded floor exactly as
  the engine does (the device-side clamp covers degradation,
  docs/dispatch.md, docs/speculation.md).
- **TW603** (error) — a ``speculate="fixed:W"`` horizon that provably
  cannot exceed its conservative floor: at or below the floor the
  static window already proves exactness, and the engine refuses at
  construction — mid-bucket, after the pack was accepted.
- **TW604** (error) — speculation on an engine that bakes the window
  into kernel arithmetic: no dynamic clamp point, refused by the
  engine (docs/speculation.md). The port's sweep and serve buckets
  build ``TorchEngine``, which threads the dynamic window (only K3's
  ``FusedSparseEngine`` refuses speculation, and no pack builds one),
  so the rule cannot fire on a pack — the reference's answer under
  its CPU resolution (``insert="xla"``).
- **TW605** (warning) — pad-growth rebuilds: a bucket whose
  fault-table row counts GROW along pack order. A batch sweep pads
  once, but serving-style mid-bucket admission (docs/serving.md)
  compiles at the first world's pad — a later, wider schedule forces
  the rebuild the r20 zero-recompile contract exists to prevent.
  Front-load the widest schedule (or pre-pad with ``pad``).
- **TW606** (warning) — occupancy skew under first-fit packing: a
  bucket whose forecast per-world supersteps (declared budgets — the
  honest no-artifact predictor, pack/predict.py) spread
  wider than :data:`TW606_SPREAD`. Short worlds quiesce early and
  their slots idle budget-masked while every chunk still pays the
  longest member's pow2 scan pad; ``--pack predicted`` re-sorts each
  shape group best-fit-decreasing to equalize per-bucket quiescence
  horizons (docs/sweeps.md "Predictive packing").

Per config, the plan lint also runs the scenario sanitizer the
engines would (graph contract + capacity, cached per family/params),
the TW5xx fault lints against the config's own schedule, and the
fault-aware capacity proof (TW205/TW206, capacity.py) at the
config's resolved window — so ``timewarp-tpu lint-pack`` is the whole
pre-flight, not just the plan rules.

Entry points: :func:`lint_run_config` (one parsed config — the serve
admission gate), :func:`lint_pack` (a parsed pack — the sweep prepare
gate), :func:`lint_pack_json` / :func:`lint_pack_path` (raw JSON —
the CLI, where parse failures must become TW600 findings).
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Any, List, Optional, Tuple

from ..sweep.spec import (RunConfig, SweepConfigError, SweepPack,
                          build_scenario, resolve_window)
from .capacity import lint_capacity_faulted
from .report import ERROR, INFO, WARNING, Finding, LintReport

__all__ = ["lint_run_config", "lint_pack", "lint_pack_json",
           "lint_pack_path", "TW606_SPREAD"]

#: TW606 threshold: warn when a first-fit bucket's forecast
#: supersteps spread (1 - shortest/longest) exceeds this — i.e. the
#: shortest member is forecast to finish in under half the longest
#: member's horizon, leaving its slot budget-masked for the rest
TW606_SPREAD = 0.5


@lru_cache(maxsize=64)
def _scenario(family: str, params: Tuple[Tuple[str, Any], ...]):
    """Scenario build cache: a pack has few distinct (family, params)
    shapes but many worlds, and admission lints per submission — the
    cached object also carries ``_lint_cache`` (analysis/__init__.py),
    so the step trace happens once per shape, not once per world."""
    return build_scenario(family, params)


def shape_report(family: str, params) -> LintReport:
    """The probe-free scenario report of one (family, params) shape,
    cached with its scenario: what the sweep's engines and solo twins
    take as their construction lint (sweep/spec.py ``linted_scenario``),
    so a shape is traced once per process however often it is built."""
    return _scenario_report(_scenario(family, params))


def _scenario_report(sc) -> LintReport:
    from . import lint_scenario
    rep = getattr(sc, "_lint_cache", None)
    if rep is None:
        rep = lint_scenario(sc, probe=False)
        try:
            sc._lint_cache = rep
        except Exception:  # noqa: BLE001 — cache is best-effort
            pass
    return rep


def _fault_rows(cfg: RunConfig) -> Tuple[int, int, int]:
    """The config's fault-table row counts (crash, partition,
    link-window), pad included — the shape component mid-bucket
    admission must not grow (TW605)."""
    sched = cfg.parse_faults()
    if sched is None:
        return (0, 0, 0)
    return (len(sched.crashes) + sched.pad[0],
            len(sched.partitions) + sched.pad[1],
            len(sched.link_windows) + sched.pad[2])


def _resolved_insert() -> Tuple[str, bool]:
    """The engine a sweep/serve bucket builds and whether it threads
    the dynamic window — the lint must predict the runtime's refusal:
    the bucket builder (sweep/bucket.py) always builds ``TorchEngine``
    (K2 + K1), whose ``_dyn_ok`` holds."""
    from ..interp.torch_engine.engine import TorchEngine
    return "TorchEngine", bool(TorchEngine._dyn_ok)


def lint_run_config(cfg: RunConfig, *, deep: bool = True) -> LintReport:
    """Every statically decidable refusal for ONE config: the TW6xx
    window/speculation mirrors of engine validation, plus (``deep``)
    the scenario sanitizer, the TW5xx fault lints, and the
    fault-aware capacity proof at the config's resolved window.
    Scenario-level ``meta["lint_ignore"]`` suppression applies to the
    whole report (the documented opt-out, docs/authoring.md)."""
    rep = LintReport()
    who = f"config {cfg.run_id!r}"
    try:
        link = cfg.parse_link()
        sched = cfg.parse_faults()
    except SweepConfigError as e:
        rep.add(Finding("TW600", ERROR, who, str(e)))
        return rep

    link_floor = int(link.min_delay_us)
    degraded = sched.min_delay_floor(link_floor) if sched is not None \
        else link_floor
    dyn = cfg.controller == "auto" or cfg.speculate != "off"
    insert, dyn_ok = _resolved_insert()
    if cfg.speculate != "off" and not dyn_ok:
        rep.add(Finding(
            "TW604", ERROR, who,
            f"speculate={cfg.speculate!r} threads the dynamic "
            f"per-superstep window, but the bucket engine resolves "
            f"to {insert!r}, which bakes the window into kernel "
            "arithmetic — no clamp point, refused at engine "
            "construction; run speculation on TorchEngine "
            "(docs/speculation.md)"))
    # the engine's floor choice (engine.py window validation): static
    # configs — and kernel-window engines regardless — take the
    # fault-DEGRADED floor; dynamic-window configs keep the undegraded
    # floor (the device clamp narrows per superstep)
    floor = link_floor if (dyn and dyn_ok) else degraded
    if cfg.window != "auto" and int(cfg.window) > 1 \
            and int(cfg.window) > floor:
        under = (f" (the fault schedule degrades the declared "
                 f"min_delay_us={link_floor} to {degraded})"
                 ) if floor < link_floor else ""
        rep.add(Finding(
            "TW602", ERROR, who,
            f"window={cfg.window} us exceeds the provable link floor "
            f"{floor}{under}; windowed supersteps would reorder "
            "causally dependent events and the engine refuses at "
            "construction — mid-bucket, after the pack was accepted. "
            f"Use window <= {floor}, window='auto', or speculate "
            "(docs/speculation.md)"))
    if cfg.speculate.startswith("fixed"):
        from ..speculate.plane import parse_speculate
        _, W = parse_speculate(cfg.speculate, who)
        spec_floor = resolve_window(cfg)
        if W is not None and W <= spec_floor:
            rep.add(Finding(
                "TW603", ERROR, who,
                f"speculate='fixed:{W}' cannot exceed its "
                f"conservative floor: the config resolves window "
                f"{spec_floor} us, and at or below the floor the "
                "static window already proves exactness — nothing to "
                "speculate; widen W past the floor or use "
                "speculate='auto' (docs/speculation.md)"))

    if not deep:
        return rep
    try:
        sc = _scenario(cfg.family, cfg.params)
    except SweepConfigError as e:
        rep.add(Finding("TW600", ERROR, who, str(e)))
        return rep
    except Exception as e:  # noqa: BLE001 — a build crash is a finding
        rep.add(Finding("TW600", ERROR, who,
                        f"scenario failed to build: {e!r}"))
        return rep
    rep.extend(_scenario_report(sc))
    if sched is not None:
        from .fault_lint import lint_fault_schedule
        rep.extend(lint_fault_schedule(sched, sc))
        rep.extend(lint_capacity_faulted(
            sc, sched, link, resolve_window(cfg), subject=who))
    ignore = ()
    if isinstance(sc.meta, dict):
        ignore = tuple(sc.meta.get("lint_ignore", ()))
    return rep.filtered(ignore) if ignore else rep


def lint_pack(pack: SweepPack, *, max_bucket: int = 64) -> LintReport:
    """The whole pre-flight for a parsed pack: per-config rules
    (:func:`lint_run_config`), the predicted bucket plan (TW601), the
    pad-growth rebuild warning (TW605), and the first-fit occupancy
    skew warning (TW606)."""
    from ..sweep.bucket import plan_buckets
    rep = LintReport()
    plannable: List[RunConfig] = []
    for cfg in pack.configs:
        r = lint_run_config(cfg)
        rep.extend(r)
        # a config whose link/faults do not even parse cannot be
        # bucketed (resolve_window would raise)
        if not any(f.code == "TW600" for f in r.errors):
            plannable.append(cfg)
    if not plannable:
        return rep
    try:
        buckets = plan_buckets(plannable, max_bucket=max_bucket)
    except (SweepConfigError, ValueError) as e:
        rep.add(Finding("TW600", ERROR, "pack",
                        f"bucket planning failed: {e}"))
        return rep
    pads = {}
    for b in buckets:
        rows = [_fault_rows(c) for c in b.configs]
        pads[b.bucket_id] = tuple(max(r[i] for r in rows)
                                  for i in range(3))
        high = rows[0]
        for c, r in zip(b.configs[1:], rows[1:]):
            if any(x > h for x, h in zip(r, high)):
                rep.add(Finding(
                    "TW605", WARNING, f"config {c.run_id!r}",
                    f"bucket {b.bucket_id}: fault tables grow from "
                    f"{high} to row counts {r} along pack order — a "
                    "batch sweep pads once, but mid-bucket admission "
                    "(serve) compiles at the first world's pad and "
                    "this world would force an engine REBUILD, "
                    "defeating the zero-recompile serving contract "
                    "(docs/serving.md). Front-load the widest "
                    "schedule or pre-pad the earlier worlds"))
            high = tuple(max(x, h) for x, h in zip(r, high))
    from ..pack.predict import predict_supersteps
    for b in buckets:
        if b.B < 2:
            continue
        preds = [predict_supersteps(c, None) for c in b.configs]
        spread = 1.0 - (min(preds) / max(preds))
        if spread > TW606_SPREAD:
            rep.add(Finding(
                "TW606", WARNING, f"bucket {b.bucket_id}",
                f"first-fit occupancy skew: forecast supersteps span "
                f"{min(preds)}..{max(preds)} (spread "
                f"{spread:.0%} > {TW606_SPREAD:.0%}) — short worlds "
                "quiesce early and idle budget-masked while every "
                "chunk pays the longest member's pow2 scan pad; "
                "re-plan with `--pack predicted` (docs/sweeps.md "
                "'Predictive packing')"))
    widths = [b.B for b in buckets]
    windows = sorted({b.window for b in buckets})
    pad_note = ", ".join(
        f"{bid}:{p}" for bid, p in pads.items() if p != (0, 0, 0))
    rep.add(Finding(
        "TW601", INFO, "pack",
        f"plan: {len(plannable)} world(s) -> {len(buckets)} bucket(s)"
        f" = {len(buckets)} engine build(s); fleet widths {widths}; "
        f"resolved windows {windows}"
        + (f"; fault pads {pad_note}" if pad_note else "")))
    return rep


def lint_pack_json(data: Any, *,
                   max_bucket: int = 64,
                   speculate_default: Optional[str] = None
                   ) -> Tuple[int, LintReport]:
    """Lint raw pack JSON: every entry that fails PACK_GRAMMAR
    parsing becomes a TW600 finding (controller x speculate, unknown
    keys, type violations — the refusals RunConfig.__post_init__
    cannot represent as a parsed config), and the parseable remainder
    is linted as a pack. Returns ``(n_entries, report)``."""
    rep = LintReport()
    if isinstance(data, dict):
        # unwrap the {"worlds": [...]} form by hand, mirroring
        # SweepPack.from_json's pack-level defaults, so ONE
        # unparseable entry becomes one finding rather than refusing
        # to look at the rest of the pack
        default_ctrl = data.get("controller")
        if speculate_default is None:
            spec = data.get("speculate")
            if isinstance(spec, str):
                speculate_default = spec
        data = data.get("worlds", data)
        if isinstance(data, list) and default_ctrl is not None:
            data = [({**d, "controller": default_ctrl}
                     if isinstance(d, dict) and "controller" not in d
                     else d) for d in data]
    if not isinstance(data, list):
        rep.add(Finding(
            "TW600", ERROR, "pack",
            "a pack file is a JSON list of config objects (or "
            "{'worlds': [...]})"))
        return 0, rep
    configs: List[RunConfig] = []
    seen = set()
    for i, d in enumerate(data):
        if speculate_default is not None and isinstance(d, dict) \
                and "speculate" not in d:
            d = {**d, "speculate": speculate_default}
        try:
            cfg = RunConfig.from_json(d, i)
        except SweepConfigError as e:
            rep.add(Finding("TW600", ERROR, f"pack entry {i}", str(e)))
            continue
        if cfg.run_id in seen:
            rep.add(Finding(
                "TW600", ERROR, f"pack entry {i}",
                f"duplicate run_id {cfg.run_id!r} — results are "
                "journaled per run_id, so ids must be unique"))
            continue
        seen.add(cfg.run_id)
        configs.append(cfg)
    if not data:
        rep.add(Finding("TW600", ERROR, "pack",
                        "a sweep pack needs at least one config"))
    if configs:
        rep.extend(lint_pack(SweepPack(tuple(configs)),
                             max_bucket=max_bucket))
    return len(data), rep


def lint_pack_path(path: str, *, max_bucket: int = 64,
                   speculate_default: Optional[str] = None
                   ) -> Tuple[int, LintReport]:
    """:func:`lint_pack_json` over a pack FILE (JSON or JSONL, the
    loader's dual grammar) — unreadable/undecodable files become
    TW600 findings, so ``lint-pack`` always produces a report."""
    rep = LintReport()
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        rep.add(Finding("TW600", ERROR, path,
                        f"pack file is unreadable: {e}"))
        return 0, rep
    try:
        data = json.loads(text)
    except json.JSONDecodeError as e:
        try:
            data = [json.loads(line) for line in text.splitlines()
                    if line.strip()]
        except json.JSONDecodeError:
            rep.add(Finding(
                "TW600", ERROR, path,
                f"pack file is neither a JSON list nor JSONL ({e})"))
            return 0, rep
    n, r = lint_pack_json(data, max_bucket=max_bucket,
                          speculate_default=speculate_default)
    return n, rep.extend(r)
