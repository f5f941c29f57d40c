"""Host runtime: stream framing, the pipeline, telemetry."""
