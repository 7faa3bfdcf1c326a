"""Run-time observability of the torch engines (the port of the
``timewarp_tpu/obs/`` planes the engines carry): per-superstep telemetry
(:mod:`.telemetry`), the schema-validated JSONL metrics stream
(:mod:`.metrics`) and the causal flight recorder (:mod:`.flight`).

The contract is the reference's: **free when off, exact when on.** With
a plane off an engine runs no code of it and launches nothing for it;
with it on, states, traces and counters equal the plane-off run's bit
for bit, and the plane's own output equals the JAX package's.
"""

from .flight import (RECORD_MODES, FlightLog, FlightRecorderMixin,
                     FlightWriter, RecordRow, concat_flight,
                     decode_flight, load_flight_jsonl, validate_record)
from .metrics import (METRICS_SCHEMA, MetricsRegistry, validate_line,
                      validate_metrics_file)
from .telemetry import (TELEMETRY_MODES, TelemetryFrames, TelemetryRow,
                        concat_frames, decode_frames, summarize_frames,
                        validate_mode)

__all__ = [
    "TELEMETRY_MODES", "TelemetryRow", "TelemetryFrames",
    "decode_frames", "summarize_frames", "validate_mode", "concat_frames",
    "METRICS_SCHEMA", "MetricsRegistry", "validate_line",
    "validate_metrics_file",
    "RECORD_MODES", "RecordRow", "FlightLog", "FlightWriter",
    "FlightRecorderMixin", "validate_record", "decode_flight",
    "concat_flight", "load_flight_jsonl",
]
