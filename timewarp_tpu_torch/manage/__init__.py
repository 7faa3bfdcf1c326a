"""Lifecycle & coordination: sync primitives over the effect API and the
job manager (≙ ``Control.TimeWarp.Manager``, SURVEY.md §1 L2)
(the port's copy of ``timewarp_tpu/manage/__init__.py``)."""

from .jobs import Force, InterruptType, JobCurator, Plain, WithTimeout
from .sync import CLOSED, Channel, Flag, MVar

__all__ = ["CLOSED", "Channel", "Flag", "MVar", "JobCurator",
           "InterruptType", "Plain", "Force", "WithTimeout"]
