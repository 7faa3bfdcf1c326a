"""Sweep run configs: what one emulated world of a pack looks like
(the port's copy of ``timewarp_tpu/sweep/spec.py``).

A :class:`RunConfig` is one world of a heterogeneous sweep — scenario
family + builder params, a ``--link``-grammar link spec, a seed, a
window, a superstep budget, and an optional ``--faults``-grammar fault
schedule. Configs are plain JSON (the pack file the CLI takes), so a
pack can be generated, diffed, and journaled; every config has a
stable ``run_id`` that the journal keys results by.

The module also owns the *identity* questions the bucketer
(:mod:`timewarp_tpu_torch.sweep.bucket`) asks:

- :func:`link_signature` — the structural identity of a link model
  (nested types plus every non-sweepable field). Two configs whose
  links share a signature can run in one batched executable, with the
  **sweepable** numeric fields (delay bounds, medians, sigmas, quanta
  — the fields ``LinkModel.sample`` uses arithmetically, batched.py)
  carried as per-world ``BatchSpec.link_params`` vectors.
- :func:`resolve_window` — the window a *solo* run of the config
  would resolve ("auto" derives from the link's declared minimum
  delay, degraded by the config's own fault schedule) — part of the
  bucket key, so every world of a bucket runs the exact window its
  solo twin would.

And the law's right-hand side: :func:`solo_engine` /
:func:`solo_result` build and run the config standalone, producing
the same result record (chained trace digest + never-silent counters)
the sweep journal streams — the **sweep survival law** says the two
are equal byte-for-byte, regardless of bucketing, retries, splits, or
resume boundaries (docs/sweeps.md).

On the port the engines are :class:`~timewarp_tpu_torch.interp.
torch_engine.engine.TorchEngine`, on the card unless ``device="cpu"``
is passed. ``lint`` is the reference's knob (``"warn"``, ``"error"``,
``"off"``; :func:`check_lint`): the engines lint their scenario at
construction, the sweep service the whole pack before any build
(analysis/plan_lint.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "RunConfig", "SweepPack", "SweepConfigError",
    "build_scenario", "linted_scenario", "link_signature", "link_sweep_params",
    "resolve_window", "solo_engine", "solo_result",
    "chain_digest", "DIGEST_ZERO", "world_result", "check_lint",
]

#: scenario families a pack may name, and the params their builders
#: accept (a loud whitelist: a typo'd param must not silently build a
#: different scenario than the solo twin)
FAMILIES = {
    "token-ring": ("nodes", "n_tokens", "think_us", "bootstrap_us",
                   "end_us", "with_observer", "mailbox_cap"),
    "gossip": ("nodes", "fanout", "think_us", "gossip_interval",
               "end_us", "steady", "burst", "mailbox_cap"),
    "praos": ("nodes", "n_slots", "leader_prob", "fanout", "burst",
              "mailbox_cap"),
    "ping-pong": ("rounds",),
}


class SweepConfigError(ValueError):
    """A pack config is malformed — raised naming the ``run_id``."""


def check_lint(lint: str, who: str) -> str:
    """Validate a service's ``lint`` knob (analysis ``LINT_MODES``:
    ``"error"``, ``"warn"``, ``"off"``) and return it; anything else
    raises ``ValueError`` naming ``who``."""
    from ..analysis import LINT_MODES
    if lint not in LINT_MODES:
        raise ValueError(
            f"{who}: lint must be one of {LINT_MODES}, got {lint!r}")
    return lint


#: the pack-entry grammar, quoted by every malformed-field refusal —
#: the LINK_GRAMMAR/FAULT_GRAMMAR discipline (net/links.py,
#: faults/schedule.py): a typo dies naming the field, never a raw
#: KeyError/TypeError from deeper in the machinery
PACK_GRAMMAR = (
    'a pack entry is {"scenario": FAMILY, "id": str?, '
    '"params": {name: value}?, "link": LINK_SPEC?, "seed": int?, '
    '"window": int_us|"auto"?, "budget": int?, "faults": FAULT_SPEC?, '
    '"controller": "off"|"auto"?, '
    '"speculate": "off"|"auto"|"fixed:W"?} (docs/sweeps.md)')


@lru_cache(maxsize=256)
def _parse_faults(text: str):
    """A ``--faults`` spec's schedule, parsed once a process: schedules
    are immutable, and validating a partition of 10^5 nodes takes
    seconds, which the pack lint, bucket planning, the bucket's identity
    and each solo twin would otherwise pay again per world."""
    from ..faults.schedule import parse_faults
    return parse_faults(text)


@dataclass(frozen=True)
class RunConfig:
    """One world of a sweep pack (module docstring). ``params`` is
    held as a sorted item tuple so configs hash (bucket keys, dedup)."""
    run_id: str
    family: str
    params: Tuple[Tuple[str, Any], ...] = ()
    link: str = "uniform:1000:5000"
    seed: int = 0
    window: Any = 1            # int µs or "auto"
    budget: int = 1000
    faults: Optional[str] = None
    #: online adaptive dispatch (dispatch/, docs/dispatch.md):
    #: "auto" runs the world's bucket under a telemetry-driven
    #: controller whose per-chunk decisions are journaled, and the
    #: survival law's solo twin REPLAYS those decisions (the replay
    #: law carries the survival law)
    controller: str = "off"
    #: optimistic time-warp execution (speculate/,
    #: docs/speculation.md): "auto" | "fixed:W" runs the world's
    #: bucket with a speculative window wider than the provable link
    #: floor, rolling back on causality violations; the committed
    #: per-chunk window choices are journaled as dispatch_decision
    #: events and the survival law's solo twin replays them — exactly
    #: the controller's journaled-decision contract
    speculate: str = "off"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise SweepConfigError(
                f"config {self.run_id!r}: unknown scenario family "
                f"{self.family!r}; choose from {sorted(FAMILIES)}")
        allowed = FAMILIES[self.family]
        params = tuple(sorted(dict(self.params).items()))
        for k, _ in params:
            if k not in allowed:
                raise SweepConfigError(
                    f"config {self.run_id!r}: {self.family} takes no "
                    f"param {k!r}; allowed: {sorted(allowed)}")
        object.__setattr__(self, "params", params)
        if not isinstance(self.budget, int) or self.budget < 1:
            raise SweepConfigError(
                f"config {self.run_id!r}: budget must be an int >= 1, "
                f"got {self.budget!r}")
        if not isinstance(self.seed, int):
            raise SweepConfigError(
                f"config {self.run_id!r}: seed must be an int, "
                f"got {self.seed!r}")
        if self.window != "auto" and (
                isinstance(self.window, bool)
                or not isinstance(self.window, int)
                or self.window < 1):
            raise SweepConfigError(
                f"config {self.run_id!r}: window must be an int µs "
                f">= 1 or 'auto', got {self.window!r}")
        if self.controller not in ("off", "auto"):
            raise SweepConfigError(
                f"config {self.run_id!r}: controller must be 'off' or "
                f"'auto', got {self.controller!r} (replay is the "
                "verify path's business, not a pack knob)")
        if self.speculate != "off":
            from ..speculate import parse_speculate
            try:
                parse_speculate(self.speculate)
            except ValueError as e:
                raise SweepConfigError(
                    f"config {self.run_id!r}: {e}") from None
            if self.controller == "auto":
                raise SweepConfigError(
                    f"config {self.run_id!r}: speculate and "
                    "controller are both per-chunk window decision "
                    "sources — a bucket runs under exactly one "
                    "(docs/speculation.md)")

    # -- JSON (the pack file / journal form) ------------------------------

    @classmethod
    def from_json(cls, d: Dict[str, Any], index: int) -> "RunConfig":
        if not isinstance(d, dict):
            raise SweepConfigError(
                f"pack entry {index} must be a JSON object, got {d!r}")
        known = {"id", "scenario", "params", "link", "seed", "window",
                 "budget", "faults", "controller", "speculate"}
        extra = set(d) - known
        if extra:
            raise SweepConfigError(
                f"pack entry {index}: unknown keys {sorted(extra)}; "
                f"allowed: {sorted(known)} — {PACK_GRAMMAR}")
        if "scenario" not in d:
            raise SweepConfigError(
                f"pack entry {index}: missing \"scenario\" — every "
                f"entry names its family; {PACK_GRAMMAR}")

        def intf(key, default):
            # validate, don't coerce: int("abc") would be a raw
            # traceback and int(50.9) a silent truncation — both
            # violate the loud-config contract
            v = d.get(key, default)
            if isinstance(v, bool) or not isinstance(v, int):
                raise SweepConfigError(
                    f"pack entry {index}: {key} must be an integer, "
                    f"got {v!r} — {PACK_GRAMMAR}")
            return v

        def strf(key, default):
            v = d.get(key, default)
            if v is not default and not isinstance(v, str):
                raise SweepConfigError(
                    f"pack entry {index}: {key} must be a string "
                    f"spec, got {v!r} — {PACK_GRAMMAR}")
            return v
        params = d.get("params") or {}
        if not isinstance(params, dict):
            raise SweepConfigError(
                f"pack entry {index}: params must be a JSON object "
                f"of builder params, got {params!r} — {PACK_GRAMMAR}")
        window = d.get("window", 1)
        if isinstance(window, bool):
            # bool ⊂ int would silently read true as window=1 µs
            raise SweepConfigError(
                f"pack entry {index}: window must be an int µs or "
                f"'auto', got {window!r} — {PACK_GRAMMAR}")
        return cls(
            run_id=str(d.get("id", f"w{index}")),
            family=strf("scenario", ""),
            params=tuple(sorted(params.items())),
            link=strf("link", "uniform:1000:5000"),
            seed=intf("seed", 0),
            window=window,
            budget=intf("budget", 1000),
            faults=strf("faults", None),
            controller=strf("controller", "off"),
            speculate=strf("speculate", "off"),
        )

    def to_json(self) -> Dict[str, Any]:
        out = {"id": self.run_id, "scenario": self.family,
               "params": dict(self.params), "link": self.link,
               "seed": self.seed, "window": self.window,
               "budget": self.budget}
        if self.faults is not None:
            out["faults"] = self.faults
        if self.controller != "off":
            out["controller"] = self.controller
        if self.speculate != "off":
            out["speculate"] = self.speculate
        return out

    # -- parsed views ------------------------------------------------------

    def parse_link(self):
        """The config's link model; a malformed spec raises
        :class:`SweepConfigError` naming the run_id (the CLI grammar
        error is a SystemExit — wrong species for a library path).
        One grammar serves the CLI and the pack loader (net/links.py),
        so a pack world and its ``--link`` solo twin cannot drift."""
        from ..net.links import parse_link
        try:
            return parse_link(self.link)
        except SystemExit as e:
            raise SweepConfigError(
                f"config {self.run_id!r}: {e}") from None

    def parse_faults(self):
        """The config's fault schedule (or None)."""
        if self.faults is None:
            return None
        try:
            return _parse_faults(self.faults)
        except SystemExit as e:
            raise SweepConfigError(
                f"config {self.run_id!r}: {e}") from None


@dataclass(frozen=True)
class SweepPack:
    """An ordered pack of configs with unique run_ids. Order is part
    of the pack's identity: the bucket plan is derived from it, and
    resume re-derives the same plan from the journaled pack."""
    configs: Tuple[RunConfig, ...]

    def __post_init__(self):
        seen = set()
        for c in self.configs:
            if c.run_id in seen:
                raise SweepConfigError(
                    f"duplicate run_id {c.run_id!r} in pack — results "
                    "are journaled per run_id, so ids must be unique")
            seen.add(c.run_id)
        if not self.configs:
            raise SweepConfigError("a sweep pack needs at least one "
                                   "config")

    @classmethod
    def from_json(cls, data: Any,
                  speculate_default: Optional[str] = None
                  ) -> "SweepPack":
        default_ctrl = None
        default_spec = speculate_default
        if isinstance(data, dict):
            # pack-level controller/speculate defaults:
            # {"controller": "auto", "worlds": [...]} turns the knob
            # on for every config that does not say otherwise
            # (explicit per-config wins)
            default_ctrl = data.get("controller")
            # the operator's explicit flag beats the pack-file-level
            # default (CLI-beats-file, the usual convention); explicit
            # PER-CONFIG values beat both, below
            if default_spec is None:
                default_spec = data.get("speculate")
            data = data.get("worlds", data)
        if not isinstance(data, list):
            raise SweepConfigError(
                "a pack file is a JSON list of config objects (or "
                "{'worlds': [...]})")
        if default_ctrl is not None:
            data = [({**d, "controller": default_ctrl}
                     if isinstance(d, dict) and "controller" not in d
                     else d) for d in data]
        if default_spec is not None:
            data = [({**d, "speculate": default_spec}
                     if isinstance(d, dict) and "speculate" not in d
                     else d) for d in data]
        return cls(tuple(RunConfig.from_json(d, i)
                         for i, d in enumerate(data)))

    @classmethod
    def load(cls, path: str,
             speculate_default: Optional[str] = None) -> "SweepPack":
        """Load a pack file. ``speculate_default`` (the CLI's
        ``sweep run --speculate``) applies at the JSON layer — only
        to entries with NO ``"speculate"`` key, so a config that
        explicitly says ``"off"`` keeps its opt-out (an explicit off
        is indistinguishable from the dataclass default after
        parsing, which is why this cannot live post-parse)."""
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            # JSONL form: one config object per line
            try:
                data = [json.loads(line) for line in text.splitlines()
                        if line.strip()]
            except json.JSONDecodeError as e:
                raise SweepConfigError(
                    f"pack file {path!r} is neither a JSON list nor "
                    f"JSONL ({e})") from None
        return cls.from_json(data, speculate_default=speculate_default)

    def to_json(self) -> List[Dict[str, Any]]:
        return [c.to_json() for c in self.configs]

    def sha(self) -> str:
        """Content identity — resume refuses a journal written for a
        different pack."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def by_id(self, run_id: str) -> RunConfig:
        for c in self.configs:
            if c.run_id == run_id:
                return c
        raise KeyError(run_id)


# -- scenario construction -------------------------------------------------

def build_scenario(family: str, params):
    """Build the family's scenario from a config's param dict — the
    same builders the run CLI uses, so a pack world and a CLI solo run
    agree on what a family name means."""
    kw = dict(params)
    try:
        if family == "token-ring":
            from ..models.token_ring import token_ring
            return token_ring(kw.pop("nodes"), **kw)
        if family == "gossip":
            from ..models.gossip import gossip
            return gossip(kw.pop("nodes"), **kw)
        if family == "praos":
            from ..models.praos import praos
            return praos(kw.pop("nodes"), **kw)
        if family == "ping-pong":
            from ..models.ping_pong import ping_pong
            return ping_pong(**kw)
    except KeyError as e:
        raise SweepConfigError(
            f"{family} config is missing required param {e}") from None
    raise SweepConfigError(f"unknown scenario family {family!r}")


def linted_scenario(family: str, params, lint: str):
    """:func:`build_scenario`, carrying its shape's construction-lint
    report from the pack lint's per-(family, params) cache
    (analysis/plan_lint.py ``shape_report``) unless ``lint`` is
    ``"off"``: the bucket engines, solo twins and resumed or split
    runners of one shape then trace its step once, not once each."""
    sc = build_scenario(family, params)
    if lint != "off":
        from ..analysis.plan_lint import shape_report
        try:
            sc._lint_cache = shape_report(family, params)
        except TypeError:   # unhashable params: the engine lints its own
            pass
    return sc


# -- link identity ---------------------------------------------------------

#: per-link-class fields BatchSpec.link_params may sweep per world:
#: the values ``sample`` uses *arithmetically* (batched.py module
#: docstring). Everything else — WithDrop.drop_prob (trace-time
#: threshold), SeededHashUniform.salt (host-expanded) — is structural
#: and lands in the signature verbatim.
_SWEEPABLE = {
    "FixedDelay": ("delay",),
    "UniformDelay": ("lo", "hi"),
    "LogNormalDelay": ("median_us", "sigma", "cap_us", "floor_us"),
    "ParetoDelay": ("xm_us", "alpha", "cap_us", "floor_us"),
    "Quantize": ("quantum_us",),
}


def link_signature(link) -> tuple:
    """Structural identity of a link model: the nested dataclass types
    plus every non-sweepable field value, with sweepable fields as
    holes. Configs whose links share a signature can share one batched
    executable (the sweepable values ride in per-world vectors)."""
    from ..net.delays import LinkModel
    name = type(link).__name__
    sweep = _SWEEPABLE.get(name, ())
    sig: list = [name]
    for f in dataclasses.fields(link):
        v = getattr(link, f.name)
        if isinstance(v, LinkModel):
            sig.append((f.name, link_signature(v)))
        elif f.name in sweep:
            sig.append((f.name, None))
        else:
            sig.append((f.name, v))
    return tuple(sig)


def link_sweep_params(link, prefix: str = "") -> Dict[str, Any]:
    """The dotted-path -> value map of a link's sweepable fields —
    one world's row of the bucket's ``BatchSpec.link_params``."""
    from ..net.delays import LinkModel
    out: Dict[str, Any] = {}
    sweep = _SWEEPABLE.get(type(link).__name__, ())
    for f in dataclasses.fields(link):
        v = getattr(link, f.name)
        if isinstance(v, LinkModel):
            out.update(link_sweep_params(v, prefix + f.name + "."))
        elif f.name in sweep:
            out[prefix + f.name] = v
    return out


def resolve_window(cfg: RunConfig) -> int:
    """The window a solo run of ``cfg`` resolves (TorchEngine.__init__
    order: the link floor, degraded by the config's own fault
    schedule, then "auto" -> max(1, floor), int32-clamped). Buckets
    key on this so the batched engine runs exactly the window every
    member's solo twin would. Controller configs resolve the dynamic
    window's BOUND instead — the UNDEGRADED floor, exactly as the
    engine does (degradation clamps on-device per superstep,
    docs/dispatch.md). Speculate configs resolve their CONSERVATIVE
    floor the same undegraded way (the speculative bound is derived
    by the engine from the speculate spec; degradation clamps
    on-device — docs/speculation.md)."""
    from ..ops.numeric import I32MAX
    link = cfg.parse_link()
    floor = link.min_delay_us
    sched = cfg.parse_faults()
    if sched is not None and cfg.controller == "off" \
            and cfg.speculate == "off":
        floor = sched.min_delay_floor(floor)
    if cfg.window == "auto":
        return max(1, min(int(floor), I32MAX - 1))
    return int(cfg.window)


# -- the solo (law right-hand-side) run ------------------------------------

def solo_engine(cfg: RunConfig, *, lint: str = "warn",
                decisions=None, device=None):
    """The standalone engine for one config — what the sweep's
    streamed result must be bit-identical to — on ``device`` (the
    card by default). Controller configs take the bucket's journaled
    ``decisions`` (dispatch_decision records) and get a REPLAY
    controller: the replay law (dispatch/) then carries the survival
    law — the solo twin re-applies exactly the chunking/window
    sequence the bucket decided."""
    from ..interp.torch_engine.engine import TorchEngine
    check_lint(lint, "solo_engine")
    sc = linted_scenario(cfg.family, cfg.params, lint)
    controller = None
    if cfg.controller == "auto":
        if decisions is None:
            raise SweepConfigError(
                f"config {cfg.run_id!r} runs under a dispatch "
                "controller; its solo twin needs the journaled "
                "decision records (sweep journal dispatch_decision "
                "events) — an auto solo run would decide its own "
                "chunking and legitimately diverge")
        from ..dispatch import DispatchController
        controller = DispatchController(mode="replay",
                                        replay=decisions)
    if cfg.speculate != "off" and decisions is None:
        # a fresh speculative solo run would roll back on its OWN
        # violations, not the bucket fleet's (any world's violation
        # rolls the whole bucket chunk back), so its committed window
        # sequence — and therefore its superstep granularity — would
        # legitimately diverge from the streamed result
        raise SweepConfigError(
            f"config {cfg.run_id!r} runs under optimistic "
            "speculation; its solo twin needs the bucket's journaled "
            "decision records (sweep journal dispatch_decision "
            "events) to replay the committed window sequence "
            "(docs/speculation.md)")
    return TorchEngine(sc, cfg.parse_link(), seed=cfg.seed,
                       window=resolve_window(cfg),
                       faults=cfg.parse_faults(), controller=controller,
                       speculate=cfg.speculate, lint=lint, device=device)


#: the digest chain seed (hex of 32 zero bytes)
DIGEST_ZERO = "0" * 64

#: one trace row packed little-endian: t(int64), fired(int32),
#: fired_hash(uint32), recv, recv_hash, sent, sent_hash, overflow
_ROW = struct.Struct("<qiIiIiIi")


def chain_digest(h: str, trace) -> str:
    """Fold a :class:`SuperstepTrace`'s rows into a running sha256
    chain (hex in, hex out). Chaining — rather than one digest over a
    materialized trace — is what lets the sweep journal a world's
    digest incrementally across chunks, checkpoints, retries, and
    resume boundaries, and still land on the same value a single solo
    run computes."""
    cur = bytes.fromhex(h)
    for i in range(len(trace)):
        cur = hashlib.sha256(cur + _ROW.pack(*trace.row(i))).digest()
    return cur.hex()


#: never-silent counters every result record carries (per world)
_COUNTERS = ("overflow", "bad_dst", "bad_delay", "short_delay",
             "route_drop", "fault_dropped", "delivered")


def world_result(cfg: RunConfig, state, b: Optional[int],
                 digest: str, supersteps: int,
                 host: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The result record streamed to the journal for one world:
    chained trace digest, superstep/virtual-time totals, and every
    never-silent counter. ``b`` indexes a batched state's world axis
    (None for a solo state). ``host`` is :func:`result_leaves`'s copy
    of the state's counters, when the caller already made it (one
    device read a chunk for every world)."""
    if host is None:
        host = result_leaves(state)

    def leaf(name):
        v = host[name]
        return int(v if b is None else v[b])

    out = {"run_id": cfg.run_id, "supersteps": int(supersteps),
           "trace_digest": digest,
           "steps": leaf("steps"),
           "virtual_time_us": leaf("time")}
    for c in _COUNTERS:
        out[c] = leaf(c)
    return out


def result_leaves(state) -> Dict[str, Any]:
    """The leaves a result record reads (``steps``, ``time`` and the
    never-silent counters), every world's, copied to the host in one
    transfer."""
    import torch
    names = ("steps", "time") + _COUNTERS
    host = torch.stack([getattr(state, n).to(torch.int64)
                        for n in names]).cpu().numpy()
    return dict(zip(names, host))


def solo_result(cfg: RunConfig, *, lint: str = "warn",
                decisions=None, with_trace: bool = False, device=None):
    """Run ``cfg`` standalone and produce the exact record the sweep
    journal would stream for it — the right-hand side of the sweep
    survival law (tests/test_zsweep.py; the bench and CI smoke gates).
    Controller configs replay the bucket's journaled ``decisions``
    (see :func:`solo_engine`). ``with_trace=True`` returns
    ``(result, trace)`` so a ``--verify`` mismatch can auto-bisect
    against the rows this run already computed instead of re-running
    the whole solo twin. ``device`` defaults to the card."""
    eng = solo_engine(cfg, lint=lint, decisions=decisions,
                      device=device)
    if cfg.controller == "auto":
        final, trace = eng.run_controlled(cfg.budget)
    elif cfg.speculate != "off":
        # replay the bucket's committed window sequence — committed
        # chunks are violation-free by construction, so the replay
        # never rolls back and is bit-identical to the streamed run
        # (the speculation replay law, docs/speculation.md)
        final, trace = eng.run_speculative(cfg.budget,
                                           replay=decisions)
    else:
        final, trace = eng.run(cfg.budget)
    res = world_result(cfg, final, None,
                       chain_digest(DIGEST_ZERO, trace), len(trace))
    return (res, trace) if with_trace else res
