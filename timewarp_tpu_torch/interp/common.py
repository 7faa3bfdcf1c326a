"""Shared interpreter machinery — single source of truth for semantics
both interpreters must agree on (the parity these modules promise)
(the port's copy of ``timewarp_tpu/interp/common.py``)."""

from __future__ import annotations

import logging

from ..core.errors import ThreadKilled

__all__ = ["NO_TOKEN", "log_thread_death"]

#: sentinel: no unpark token pending (the Park/Unpark token protocol)
NO_TOKEN = object()


def log_thread_death(log: logging.Logger, name: str,
                     exc: BaseException) -> None:
    """≙ ``threadKilledNotifier`` (TimedT.hs:306-316): uncaught forked
    exceptions are logged, never propagated — ``ThreadKilled`` at DEBUG,
    anything else at WARNING."""
    level = logging.DEBUG if isinstance(exc, ThreadKilled) \
        else logging.WARNING
    log.log(level, "[%s] Thread killed by exception: %r", name, exc)
