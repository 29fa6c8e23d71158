"""Telemetry: spans, counters and step records (``repro.obs``; DESIGN.md
§13), written as the reference's versioned JSONL rows."""
from repro_torch.obs.recorder import (COUNTERS, CounterRegistry, Recorder,
                                      SCHEMA_VERSION, TraceRecorder,
                                      get_recorder, read_trace, recording,
                                      set_recorder)

__all__ = [
    "COUNTERS", "CounterRegistry", "Recorder", "SCHEMA_VERSION",
    "TraceRecorder", "get_recorder", "read_trace", "recording",
    "set_recorder",
]
