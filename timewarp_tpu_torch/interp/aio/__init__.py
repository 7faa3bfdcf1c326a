"""Real wall-clock interpreter over asyncio (≙ ``TimedIO`` + the real
``Transfer`` network, SURVEY.md §1 L1a/L3)
(the port's copy of ``timewarp_tpu/interp/aio/__init__.py``)."""

from .timed import AioThreadId, RealTime, run_real_time

__all__ = ["AioThreadId", "RealTime", "run_real_time"]
