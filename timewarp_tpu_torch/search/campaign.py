"""The ChaosSearch campaign driver: evolve schedules, fork, minimize
(the port of ``timewarp_tpu/search/campaign.py``: every fleet it builds
— evaluations, the fork snapshot and fork fleet, confirmations and the
minimizer's rounds — is a batched ``TorchEngine`` on ``device``, the
card unless the caller passes ``device="cpu"``; K2 and K1 run once per
fleet superstep of each on the card).

One campaign is: seed a population of fault schedules around a base
:class:`~timewarp_tpu_torch.sweep.spec.RunConfig`, evaluate each generation
as ONE shape-shared batched fleet (objectives.evaluate_configs —
candidates differ only by fault tables, padded to the domain caps, so
the whole campaign reuses one executable shape per fleet width),
select by objective score, and breed the next generation with the
seeded operators (mutate.py). Optionally, each generation spends part
of its budget on **counterfactual forking** (fork.py): snapshot the
current best candidate mid-run (digest-verified checkpoint) and fan K
suffix mutations out from that snapshot, paying only for the suffix
that differs; fork-discovered candidates join the breeding pool, and
any fork-phase violation is RE-CONFIRMED from t=0 before it is ever
reported (a suffix trace cannot soundly witness a whole-run property
on its own).

Found counterexamples are delta-minimized (minimize.py) and emitted
as a replayable repro artifact — config + seed + ``--faults`` grammar
string — written atomically into the journal dir as ``repro.json``.

**The determinism law** (tests/test_zzzzzzzzsearch.py): the whole
campaign is a pure function of (base config, knobs, seed). Mutation
streams derive from sha256(seed, generation, slot); evaluation is the
deterministic engines; selection breaks ties on candidate index;
journal records carry no wall-clock facts. Re-running a campaign
yields an identical generation history, identical counterexample, and
an identical minimized repro string — and the repro replays the
violation bit-for-bit solo. No search state lives inside any engine:
this module is host-side composition only.

Campaigns journal through the sweep journal (``search_campaign``,
``search_gen``, ``search_fork``, ``search_counterexample``,
``search_minimized``, ``search_done`` events in ``journal.jsonl``)
and ingest into the run ledger as the ``search`` kind
(obs/ledger.py), so counterexamples and search progress are
queryable history.
"""

from __future__ import annotations

import hashlib
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..faults.schedule import FaultSchedule, format_faults
from ..sweep.spec import RunConfig, resolve_window
from .domain import ScheduleDomain, candidate_config, domain_for
from .minimize import minimize_counterexample
from .mutate import crossover, mutate, suffix_mutate
from .objectives import (Objective, WorldEval, evaluate_configs,
                         parse_objective)

__all__ = ["ChaosSearch", "CampaignResult"]


def _rng(seed: int, *words) -> random.Random:
    """One deterministic stream per (campaign seed, role words) —
    sha256-derived so streams are independent and platform-stable."""
    tag = f"tw-search:{seed}:" + ":".join(str(w) for w in words)
    h = hashlib.sha256(tag.encode()).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


def _key(s: FaultSchedule) -> str:
    return format_faults(s) if s.events else ""


class _Verdict(NamedTuple):
    violated: bool
    score: int
    origin: str            # "fleet" | "confirm"
    supersteps: int = 0    # what the evaluation actually executed —
    #                        anchors the fork point (a world usually
    #                        quiesces far below its superstep budget)


class CampaignResult(NamedTuple):
    found: bool
    counterexample: Optional[str]     # --faults grammar string
    minimized: Optional[str]          # minimized grammar string
    repro: Optional[dict]             # the repro artifact
    repro_path: Optional[str]         # repro.json (journaled runs)
    generations: List[dict]           # per-gen history (journal twin)
    evaluations: int                  # full t=0 world evaluations
    fork: dict                        # fork bookkeeping + saving

    def to_json(self) -> dict:
        return {"found": self.found,
                "counterexample": self.counterexample,
                "minimized": self.minimized,
                "repro_path": self.repro_path,
                "generations": len(self.generations),
                "evaluations": self.evaluations,
                "fork": self.fork}


@dataclass
class ChaosSearch:
    """One adversarial campaign (module docstring). ``base`` supplies
    everything but the fault schedule; ``objective`` the violation
    predicate + pressure gradient; ``domain`` the mutation bounds
    (default: derived from the base config's params). ``fork_k > 0``
    enables the counterfactual-forking refinement phase. Every engine
    the campaign builds runs on ``device`` (the card unless the caller
    passes ``device="cpu"``; without a card and without ``device=``
    the constructor raises). ``lint`` is the engines' construction-lint
    knob (``sweep.spec.check_lint``; ``"off"`` by default, as the
    reference's)."""
    base: RunConfig
    objective: Objective
    domain: Optional[ScheduleDomain] = None
    population: int = 12
    generations: int = 8
    seed: int = 0
    elites: int = 0                    # 0 = max(2, population // 4)
    fork_k: int = 0
    fork_frac: float = 0.5
    max_bucket: int = 64
    chunk: int = 64
    lint: str = "off"
    journal_dir: Optional[str] = None
    stop_on_violation: bool = True
    minimize_trials: int = 256
    device: Optional[str] = None
    _journal: object = field(default=None, repr=False)

    def __post_init__(self):
        from ..interp.torch_engine.engine import resolve_device
        from ..sweep.spec import check_lint
        check_lint(self.lint, "ChaosSearch")
        self.device = resolve_device(self.device, "ChaosSearch")
        if isinstance(self.objective, str):
            self.objective = parse_objective(self.objective)
        if self.domain is None:
            self.domain = domain_for(self.base)
        if self.population < 2:
            raise ValueError("a campaign needs population >= 2")
        if self.generations < 1:
            raise ValueError("a campaign needs generations >= 1")
        if not (0.0 < self.fork_frac < 1.0):
            raise ValueError(
                f"fork_frac must be in (0, 1), got {self.fork_frac}")
        if self.elites == 0:
            # always strictly below the population: elites ==
            # population would silently disable breeding (every
            # generation re-ranks the same cached schedules forever)
            self.elites = max(1, min(self.population - 1,
                                     max(2, self.population // 4)))
        if self.elites >= self.population:
            raise ValueError(
                f"elites={self.elites} >= population="
                f"{self.population}: no offspring would ever be "
                "bred — the campaign would re-rank the same "
                "schedules every generation")
        base_sched = self.base.parse_faults() or FaultSchedule(())
        if not self.domain.admissible(base_sched):
            raise ValueError(
                "the base config's own fault schedule exceeds the "
                "search domain's table caps "
                f"{self.domain.table_pad} — raise the caps "
                "(ScheduleDomain) so every candidate shares one "
                "executable shape")
        if self.journal_dir:
            from ..sweep.journal import SweepJournal
            self._journal = SweepJournal(self.journal_dir)
            if self._journal.exists():
                # campaigns have no resume: appending a second
                # campaign's stream to an existing journal would mix
                # histories (and the ledger's `search` ingest reads
                # the FIRST campaign records next to the LAST
                # repro.json) — one journal dir per campaign, the
                # sweep's one-dir-per-pack convention
                raise ValueError(
                    f"{self.journal_dir!r} already holds a campaign "
                    "journal — campaigns have no resume; use a "
                    "fresh --journal dir per campaign")
            self._journal.ensure_dir()

    # -- journaling --------------------------------------------------------

    def _append(self, rec: dict) -> None:
        if self._journal is not None:
            self._journal.append(rec)

    # -- evaluation --------------------------------------------------------

    def _evaluate_fresh(self, gen: int,
                        population: List[FaultSchedule],
                        cache: Dict[str, _Verdict]) -> int:
        """Evaluate every not-yet-seen candidate of this generation
        as one fleet; fold verdicts into the cache. Returns the
        number of fresh t=0 evaluations."""
        fresh: List[Tuple[str, RunConfig]] = []
        seen = set(cache)
        for i, s in enumerate(population):
            k = _key(s)
            if k in seen:
                continue
            seen.add(k)
            fresh.append((k, candidate_config(self.base, s,
                                              f"g{gen}c{i}")))
        if fresh:
            evals = evaluate_configs(
                [c for _, c in fresh],
                fault_pad=self.domain.table_pad,
                max_bucket=self.max_bucket, chunk=self.chunk,
                lint=self.lint, device=self.device)
            for k, cfg in fresh:
                ev = evals[cfg.run_id]
                violated, score = self.objective.judge(ev)
                cache[k] = _Verdict(violated, score, "fleet",
                                    ev.supersteps)
        return len(fresh)

    def _confirm(self, s: FaultSchedule,
                 cache: Dict[str, _Verdict]) -> _Verdict:
        """A from-scratch verdict for one schedule (the sound form a
        fork-phase violation must pass before it is reported)."""
        cfg = candidate_config(self.base, s, "confirm")
        ev = evaluate_configs([cfg],
                              fault_pad=self.domain.table_pad,
                              chunk=self.chunk, lint=self.lint,
                              device=self.device)["confirm"]
        violated, score = self.objective.judge(ev)
        v = _Verdict(violated, score, "confirm", ev.supersteps)
        cache[_key(s)] = v
        return v

    # -- the fork refinement phase ----------------------------------------

    def _fork_phase(self, gen: int, best: FaultSchedule,
                    cache: Dict[str, _Verdict], stats: dict,
                    pool: List[FaultSchedule]
                    ) -> Optional[FaultSchedule]:
        """Snapshot the generation's best candidate at
        ``fork_frac × budget`` supersteps and fan ``fork_k`` suffix
        mutations out from the snapshot (module docstring). Returns a
        CONFIRMED counterexample schedule, or None; scored suffix
        candidates join ``pool`` for breeding either way."""
        import tempfile

        from ..sweep.bucket import Bucket, build_bucket_engine
        from ..utils.checkpoint import save_state
        from .fork import fork_bucket, load_fork_state, run_fork
        base_cfg = candidate_config(self.base, best, f"g{gen}fb")
        bucket = Bucket(f"g{gen}fb", (base_cfg,),
                        resolve_window(base_cfg),
                        fault_pad=self.domain.table_pad)
        eng = build_bucket_engine(bucket, lint=self.lint,
                                  device=self.device)
        # fork at fork_frac of the supersteps this candidate ACTUALLY
        # executed (its cached evaluation) — a world usually quiesces
        # far below its nominal budget, and forking past quiescence
        # forks nothing
        executed = cache[_key(best)].supersteps or self.base.budget
        fork_budget = max(1, int(executed * self.fork_frac))
        # the engine's own chunked fleet driver runs to quiesce-or-
        # budget — the one quiesce/budget-law implementation, never
        # a hand-rolled twin
        st, _ = eng.run_stream(
            np.asarray([fork_budget], np.int64), chunk=self.chunk)
        if not bool(eng.world_active(st)[0]):
            return None      # quiesced before the fork point
        t_fork = int(st.time[0])
        # suffix events must open past the snapshot's EXECUTED
        # horizon — the last superstep already fired the whole band
        # [t_fork, t_fork + window) (fork.validate_fork_suffix)
        t_open = t_fork + resolve_window(base_cfg)
        suffixes: List[FaultSchedule] = []
        seen = {_key(best)}
        for k in range(4 * self.fork_k):
            if len(suffixes) == self.fork_k:
                break
            s = suffix_mutate(_rng(self.seed, "fork", gen, k), best,
                              t_open, self.domain)
            if s is not None and _key(s) not in seen:
                seen.add(_key(s))
                suffixes.append(s)
        if not suffixes:
            return None
        tmp = None
        if self.journal_dir:
            ckpt = os.path.join(self.journal_dir,
                                f"fork-g{gen}.npz")
        else:
            tmp = tempfile.mkdtemp(prefix="tw_fork_")
            ckpt = os.path.join(tmp, "fork.npz")
        save_state(ckpt, st, meta={"fork_gen": gen,
                                   "t_fork_us": t_fork,
                                   "base": format_faults(best)
                                   if best.events else ""},
                   scenario=eng.scenario)
        fengine, _fcfgs = fork_bucket(
            base_cfg, suffixes, t_fork,
            fault_pad=self.domain.table_pad, lint=self.lint,
            device=self.device)
        state, t_fork2, _meta = load_fork_state(fengine, ckpt, 0)
        # the snapshot is only needed until the fleet admitted it:
        # nothing reads it afterwards (campaigns have no resume), so
        # a full engine-state .npz per generation must not pile up —
        # in the journal dir OR /tmp
        import shutil
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            try:
                os.unlink(ckpt)
            except OSError:
                pass
        fr = run_fork(fengine, state, self.base.budget,
                      chunk=self.chunk)
        stats["forks"] += 1
        stats["fork_worlds"] += len(suffixes)
        stats["prefix_supersteps"] += fr.prefix_supersteps
        stats["suffix_supersteps"] += sum(fr.suffix_supersteps)
        # what from-scratch evaluation of these K suffix candidates
        # would have cost: every world re-executes the shared prefix
        stats["full_supersteps"] += (
            len(suffixes) * fr.prefix_supersteps
            + sum(fr.suffix_supersteps))
        self._append({"ev": "search_fork", "gen": gen,
                      "t_fork_us": t_fork, "worlds": len(suffixes),
                      "prefix_supersteps": fr.prefix_supersteps,
                      "suffix_supersteps": fr.suffix_supersteps,
                      "saving_frac": fr.saving_frac})
        found: Optional[FaultSchedule] = None
        for k, s in enumerate(suffixes):
            ev = WorldEval(
                run_id=f"g{gen}f{k}", trace=fr.traces[k],
                schedule=s,
                supersteps=fr.prefix_supersteps
                + fr.suffix_supersteps[k],
                budget=self.base.budget, quiesced=fr.quiesced[k],
                trace_from=t_fork)
            violated, _score = self.objective.judge(ev)
            if violated:
                # EVERY fork-judged violation is confirmed from t=0
                # (sound), and the confirmed verdict is what lands in
                # the cache — a second genuine counterexample must
                # never be mislabeled non-violating just because an
                # earlier suffix already hit
                v = self._confirm(s, cache)
                stats["confirmations"] += 1
                if v.violated and found is None:
                    found = s
            # non-violating suffixes deliberately leave NO cache
            # entry: their scores are suffix-relative (incomparable
            # to full-run scores), so a fork schedule that later
            # enters a population evaluates from t=0 like any other
            # candidate — fork influence on the search is pool
            # membership (breeding), nothing else
            pool.append(s)
        return found

    @staticmethod
    def _fork_saving(stats: dict) -> float:
        """``fork_saving_frac``: 1 − supersteps actually spent
        (each fork's snapshot-prefix run PLUS all suffixes — the
        prefix run exists only to create the fork point, so honest
        accounting charges it) / what from-scratch re-runs of every
        fork world would have cost (K × prefix + suffix per fork) —
        0.0 when no fork ran."""
        full = stats["full_supersteps"]
        spent = stats["prefix_supersteps"] + stats["suffix_supersteps"]
        return round(1.0 - spent / full, 4) if full else 0.0

    # -- the campaign ------------------------------------------------------

    def run(self) -> CampaignResult:
        """Run the campaign (module docstring). The journal handle
        closes on EVERY exit — a raise mid-campaign (the fault-free-
        world guard, an engine failure) must not leak the append
        handle for the embedding process's lifetime."""
        try:
            return self._run()
        finally:
            if self._journal is not None:
                self._journal.close()

    def _run(self) -> CampaignResult:
        dom = self.domain
        base_sched = self.base.parse_faults() or FaultSchedule(())
        self._append({
            "ev": "search_campaign",
            "base": self.base.to_json(),
            "objective": self.objective.name,
            "population": self.population,
            "generations": self.generations,
            "elites": self.elites, "seed": self.seed,
            "fork_k": self.fork_k, "fork_frac": self.fork_frac,
            "domain": {"n_nodes": dom.n_nodes,
                       "horizon_us": dom.horizon_us,
                       "table_pad": list(dom.table_pad)}})
        population = [base_sched]
        for i in range(1, self.population):
            population.append(
                mutate(_rng(self.seed, 0, i), base_sched, dom))
        cache: Dict[str, _Verdict] = {}
        history: List[dict] = []
        evaluations = 0
        fork_stats = {"forks": 0, "fork_worlds": 0,
                      "prefix_supersteps": 0, "suffix_supersteps": 0,
                      "full_supersteps": 0, "confirmations": 0}
        counterexample: Optional[FaultSchedule] = None
        found_gen = None
        for g in range(self.generations):
            evaluations += self._evaluate_fresh(g, population, cache)
            scored = [(cache[_key(s)], i, s)
                      for i, s in enumerate(population)]
            violations = sorted(
                (i, s) for v, i, s in scored if v.violated)
            if any(not s.events for _, s in violations):
                # an EMPTY schedule judged violated — gen 0's base,
                # or a later drop-mutation candidate — means the
                # property fails with no faults at all: not a
                # counterexample (it has no grammar form and nothing
                # to minimize), a broken objective/scenario pairing
                raise ValueError(
                    f"the fault-free world already violates "
                    f"{self.objective.name!r} — there is nothing to "
                    "search for; fix the objective (or the "
                    "scenario) first")
            best_v, _, best_s = max(
                scored, key=lambda t: (t[0].score, -t[1]))
            gen_rec = {
                "ev": "search_gen", "gen": g,
                "population": len(population),
                "evaluations": evaluations,
                "best_score": min(best_v.score, 1 << 62),
                "best_faults": _key(best_s),
                "violations": [_key(s) for _, s in violations]}
            history.append({k: v for k, v in gen_rec.items()
                            if k != "ev"})
            self._append(gen_rec)
            if violations:
                if counterexample is None:
                    counterexample = violations[0][1]
                    found_gen = g
                if self.stop_on_violation:
                    break
            # selection: rank by (score desc, index asc), dedupe
            ranked = sorted(scored,
                            key=lambda t: (-t[0].score, t[1]))
            pool: List[FaultSchedule] = []
            seen_k = set()
            for _, _, s in ranked:
                k = _key(s)
                if k not in seen_k:
                    seen_k.add(k)
                    pool.append(s)
                if len(pool) == self.elites:
                    break
            if self.fork_k > 0 and g + 1 < self.generations:
                hit = self._fork_phase(g, pool[0], cache,
                                       fork_stats, pool)
                if hit is not None:
                    if counterexample is None:
                        counterexample = hit
                        found_gen = g
                    if self.stop_on_violation:
                        break
            if g + 1 == self.generations:
                break
            # breed the next generation
            nxt = list(pool[:self.elites])
            slot = 0
            while len(nxt) < self.population:
                rng = _rng(self.seed, g + 1, "breed", slot)
                slot += 1
                a = rng.choice(pool)
                child = None
                if len(pool) >= 2 and rng.random() < 0.3:
                    b = rng.choice(pool)
                    child = crossover(rng, a, b, dom)
                if child is None:
                    child = mutate(rng, a, dom)
                nxt.append(child)
            population = nxt
        fork_out = dict(fork_stats)
        fork_out["saving_frac"] = self._fork_saving(fork_stats)
        if counterexample is None:
            self._append({"ev": "search_done", "found": False,
                          "evaluations": evaluations,
                          "fork": fork_out})
            return CampaignResult(False, None, None, None, None,
                                  history, evaluations, fork_out)
        ce_str = format_faults(counterexample)
        self._append({"ev": "search_counterexample",
                      "gen": found_gen, "faults": ce_str,
                      "objective": self.objective.name})
        mres = minimize_counterexample(
            self.base, counterexample, self.objective,
            max_trials=self.minimize_trials, chunk=self.chunk,
            fault_pad=dom.table_pad, lint=self.lint,
            device=self.device)
        evaluations += mres.trials
        min_str = format_faults(mres.schedule)
        self._append({"ev": "search_minimized", "faults": min_str,
                      "trials": mres.trials,
                      "dropped_events": mres.dropped_events,
                      "tightened_us": mres.tightened_us})
        repro = {
            "repro_schema": 1, "kind": "chaos-search-repro",
            "scenario": self.base.family,
            "params": dict(self.base.params),
            "link": self.base.link, "seed": self.base.seed,
            "window": self.base.window, "budget": self.base.budget,
            "objective": self.objective.name,
            "faults": min_str, "events": len(mres.schedule.events),
            "search_seed": self.seed, "found_gen": found_gen,
        }
        repro_path = None
        if self.journal_dir:
            import json

            from ..utils.checkpoint import atomic_write
            repro_path = os.path.join(self.journal_dir, "repro.json")

            def write(f):
                json.dump(repro, f, indent=1, sort_keys=True)
                f.write("\n")
            atomic_write(repro_path, write, mode="w")
        self._append({"ev": "search_done", "found": True,
                      "evaluations": evaluations,
                      "counterexample": ce_str,
                      "minimized": min_str, "fork": fork_out})
        return CampaignResult(True, ce_str, min_str, repro,
                              repro_path, history, evaluations,
                              fork_out)
