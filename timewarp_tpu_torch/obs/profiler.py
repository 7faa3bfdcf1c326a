"""Optional ``torch.profiler`` integration (port of
``timewarp_tpu/obs/profiler.py``).

The telemetry counters (obs/telemetry.py) answer *what the emulation
did*; the profiler answers *where the device time went*. This module
wraps it so callers can always write ``with profile_session(logdir):``
— a session records the CPU and, when a card is present, the CUDA
activity (the hand-written kernels appear by their symbol names,
``fire_compact_kernel``, ``mailbox_insert_kernel``, one event per
launch) and writes a Chrome trace (``trace.json``) into ``logdir`` on
exit. When profiling is unavailable (no CUPTI, a sandbox that refuses
the tracer) the session degrades to a warned no-op instead of killing
the run. Nothing here runs at engine construction; the zero-overhead
law is untouched.
"""

from __future__ import annotations

import contextlib
import logging
import os
from contextlib import contextmanager
from typing import Optional

__all__ = ["profile_session", "annotate", "TRACE_FILE"]

_log = logging.getLogger("timewarp.obs")

#: the Chrome trace a session writes into its logdir
TRACE_FILE = "trace.json"


@contextmanager
def profile_session(logdir: Optional[str]):
    """A ``torch.profiler`` session writing ``logdir/trace.json`` (view it
    in Perfetto or ``chrome://tracing``). Yields the ``logdir`` — or
    None for ``logdir=None`` and on any profiler failure, where the run
    goes on without a device profile: the emulation must never die for
    its own instrumentation."""
    if not logdir:
        yield None
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — degrade, never kill the run
        _log.warning("torch.profiler session unavailable (%s); running "
                     "without a device profile", e)
        yield None
        return
    try:
        yield logdir
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        except Exception as e:  # noqa: BLE001
            _log.warning("torch.profiler stop/export failed: %s", e)


def annotate(name: str):
    """A named ``record_function`` range (a labeled span in the
    profile), or a null context when unavailable."""
    try:
        from torch.profiler import record_function
        return record_function(name)
    except Exception:  # noqa: BLE001
        return contextlib.nullcontext()
