"""Network bench harness — the reference's 4-point latency measurement
pipeline (time-warp's `bench/Network/`): sender + receiver programs
emitting PingSent/PingReceived/PongSent/PongReceived measure events,
and a log reader joining them per message id into ``measures.csv``."""

from .commons import (MeasureEvent, Ping, Pong, log_measure,
                      parse_measure_line)
from .log_reader import join_measures, write_csv
from .receiver import receiver
from .sender import sender

__all__ = [
    "MeasureEvent", "Ping", "Pong", "log_measure", "parse_measure_line",
    "join_measures", "write_csv", "receiver", "sender",
]
