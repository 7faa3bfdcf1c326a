"""The port's effect layer held against the reference's: the same timed
programs — built once against each package's own effects, errors, jobs
and sync primitives — run through ``timewarp_tpu_torch``'s emulator
(``interp/ref/des.py``) and real-time interpreter (``interp/aio/
timed.py``) and through ``timewarp_tpu``'s, and must agree: the main
program's result, the final virtual time and the order and text of the
thread deaths each interpreter logs. Programs follow
``tests/test_timed_emulation.py`` and ``tests/test_jobs.py``: ``Wait``,
``Fork``, ``ThrowTo``, ``timeout``, ``JobCurator`` with ``Plain``,
``WithTimeout`` and ``Force``, nested curators, ``Flag``, and a
hypothesis property over random waits. The real-time cases wait a few
milliseconds, spaced far enough apart that their order is the wall
clock's.

Tolerance: exact (results, virtual times and log lines are compared
with ``==``).
"""

import importlib
import logging
from types import SimpleNamespace

import pytest

ROOTS = ("timewarp_tpu", "timewarp_tpu_torch")


def _ns(root):
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        eff=mod("core.effects"), err=mod("core.errors"),
        time=mod("core.time"), jobs=mod("manage.jobs"),
        sync=mod("manage.sync"), des=mod("interp.ref.des"),
        aio=mod("interp.aio.timed"))


NS = {root: _ns(root) for root in ROOTS}


class _Deaths(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _run(ns, build, real: bool):
    """``build(ns)`` -> a program function; run it under ``ns``'s
    emulator (or real-time interpreter) and return ``(result, final
    virtual time, thread deaths)``."""
    h = _Deaths()
    log = logging.getLogger("timewarp.realtime" if real
                            else "timewarp.emulation")
    old = log.level
    log.addHandler(h)
    log.setLevel(logging.DEBUG)
    try:
        if real:
            return ns.aio.run_real_time(build(ns)), None, h.lines
        emu = ns.des.PureEmulation()
        return emu.run(build(ns)), emu.virtual_time, h.lines
    finally:
        log.removeHandler(h)
        log.setLevel(old)


def both(build, real: bool = False):
    """The same program through both packages; every observable equal."""
    ref, port = (_run(NS[r], build, real) for r in ROOTS)
    assert port == ref, f"\n  reference: {ref}\n  port:      {port}"
    return port


# -- Wait, Fork, ThrowTo, timeout ----------------------------------------

def _forks(ns):
    E = ns.eff

    def main():
        log = []

        def child(i, dt):
            def prog():
                yield E.Wait(dt)
                log.append((i, (yield E.GetTime())))
            return prog
        for i, dt in enumerate((30_000, 10_000, 20_000, 10_000)):
            yield E.Fork(child(i, dt))
        yield E.Wait(ns.time.for_(ns.time.ms(25)))
        mid = list(log)
        yield E.Wait(ns.time.till(ns.time.sec(1)))
        return mid, log, (yield E.GetTime())
    return main


def _throws(ns):
    E, err = ns.eff, ns.err

    def main():
        out = []

        def sleeper():
            try:
                yield E.Wait(10_000_000)
            finally:
                out.append(("sleeper-finally", (yield E.GetTime())))

        def catcher():
            try:
                yield E.Wait(10_000_000)
            except ValueError as e:
                out.append(("caught", str(e), (yield E.GetTime())))

        def crasher():
            yield E.Wait(3_000)
            raise RuntimeError("boom in a fork")
        t1 = yield E.Fork(sleeper)
        t2 = yield E.Fork(catcher)
        yield E.Fork(crasher)
        yield E.Wait(1_000)
        yield E.ThrowTo(t1, err.ThreadKilled())
        yield E.ThrowTo(t2, ValueError("delivered"))
        yield E.Wait(5_000)
        return out
    return main


def _timeouts(ns):
    E, err = ns.eff, ns.err

    def main():
        res = []
        for limit, work in ((5_000, 2_000), (2_000, 5_000),
                            (3_000, 3_000)):
            def body(work=work):
                yield E.Wait(work)
                return work
            try:
                res.append(("ok", (yield from E.timeout(limit, body)),
                            (yield E.GetTime())))
            except err.TimeoutExpired as e:
                res.append(("expired", str(e), (yield E.GetTime())))
        return res
    return main


@pytest.mark.parametrize("build", [_forks, _throws, _timeouts],
                         ids=["wait-fork", "throw-to", "timeout"])
def test_effects_equal_reference(build):
    result, vt, deaths = both(build)
    assert result and vt > 0
    if build is _throws:
        assert any("boom in a fork" in m for _, m in deaths)


# -- JobCurator: Plain, WithTimeout, Force; nesting -----------------------

def _curator(ns):
    E, J = ns.eff, ns.jobs

    def main():
        log = []
        jc, child = J.JobCurator(), J.JobCurator()

        def worker(i):
            def prog():
                try:
                    yield E.Wait(10_000_000)
                finally:
                    log.append(("cleanup", i, (yield E.GetTime())))
            return prog

        def stubborn():
            yield E.Wait(50_000)
            log.append(("stubborn-done", (yield E.GetTime())))

        def on_timeout():
            log.append(("timeout-fired", (yield E.GetTime())))

        for i in range(3):
            yield from jc.add_thread_job(worker(i))
        yield from child.add_thread_job(worker(9))
        yield from jc.add_manager_as_job(child)
        yield E.Wait(1_000)
        yield from jc.stop_all_jobs()
        counts = [jc.job_count, child.job_count, child.is_interrupted]
        force = J.JobCurator()
        yield from force.add_safe_thread_job(stubborn)
        yield E.Wait(1_000)
        yield from force.stop_all_jobs(J.WithTimeout(5_000, on_timeout))
        counts.append(force.job_count)
        late = J.JobCurator()
        yield from late.add_thread_job(worker(7))
        yield from late.interrupt_all_jobs(J.Plain)
        yield from late.interrupt_all_jobs(J.Force)
        yield from late.await_all_jobs()
        yield E.Wait(100_000)
        return log, counts, (yield E.GetTime())
    return main


def test_job_curator_equal_reference():
    (log, counts, _), _, _ = both(_curator)
    assert counts == [0, 0, True, 0]
    assert log[-1][0] == "stubborn-done"


# -- Flag ----------------------------------------------------------------

def _flag(ns):
    E = ns.eff

    def main():
        flag, seen = ns.sync.Flag(), []

        def waiter(i):
            def prog():
                yield from flag.wait()
                seen.append((i, (yield E.GetTime())))
            return prog
        for i in range(3):
            yield E.Fork(waiter(i))
        yield E.Wait(7_000)
        before = list(seen)
        yield from flag.set()
        yield E.Wait(1)
        yield from flag.wait()          # set: returns at once
        return before, seen, flag.is_set
    return main


def test_flag_equal_reference():
    (before, seen, is_set), _, _ = both(_flag)
    assert before == [] and len(seen) == 3 and is_set


# -- the property: random waits ------------------------------------------

hypothesis = pytest.importorskip(
    "hypothesis", reason="property suite needs hypothesis")
from hypothesis import given  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@given(waits=st.lists(st.integers(min_value=0, max_value=600_000_000),
                      min_size=1, max_size=8),
       kill=st.integers(min_value=0, max_value=7))
def test_random_waits_equal_reference(waits, kill):
    def build(ns):
        E = ns.eff

        def main():
            log, tids = [], []

            def child(i, dt):
                def prog():
                    yield E.Wait(dt)
                    log.append((i, (yield E.GetTime())))
                return prog
            for i, dt in enumerate(waits):
                tids.append((yield E.Fork(child(i, dt))))
            yield E.Wait(waits[0] // 2)
            yield E.ThrowTo(tids[kill % len(tids)], ns.err.ThreadKilled())
            return log
        return main
    both(build)


# -- the real-time interpreter, millisecond waits ------------------------

def _real_jobs(ns):
    E, J = ns.eff, ns.jobs

    def main():
        log, jc = [], J.JobCurator()

        def worker(i):
            def prog():
                try:
                    yield E.Wait(5_000_000)
                finally:
                    log.append(f"cleanup-{i}")
            return prog
        for i in range(2):
            yield from jc.add_thread_job(worker(i))
        yield E.Wait(2_000)
        yield from jc.stop_all_jobs(J.WithTimeout(20_000, None))
        return sorted(log), jc.job_count
    return main


def _real_timeout(ns):
    E, err = ns.eff, ns.err

    def main():
        def slow():
            yield E.Wait(40_000)

        def fast():
            yield E.Wait(1_000)
            return "fast"
        out = [(yield from E.timeout(30_000, fast))]
        try:
            yield from E.timeout(5_000, slow)
        except err.TimeoutExpired:
            out.append("expired")
        return out
    return main


def _real_flag(ns):
    E = ns.eff

    def main():
        flag, order = ns.sync.Flag(), []

        def waiter():
            yield from flag.wait()
            order.append("woken")
        yield E.Fork(waiter)
        yield E.Wait(3_000)
        order.append("set")
        yield from flag.set()
        yield E.Wait(3_000)
        return order
    return main


@pytest.mark.parametrize("build,want", [
    (_real_jobs, (["cleanup-0", "cleanup-1"], 0)),
    (_real_timeout, ["fast", "expired"]),
    (_real_flag, ["set", "woken"])], ids=["jobs", "timeout", "flag"])
def test_real_time_equal_reference(build, want):
    result, _, _ = both(build, real=True)
    assert result == want
