"""The port's telemetry (``fedtpu.telemetry``): ``trace`` (the span/event
tracer writing the schema-v2 JSONL sink, its flight recorder), ``metrics``
(counters, gauges, histograms, the compile probe, the device-memory
gauges), ``manifest`` (the run manifest and its config hash), ``log`` (the
leveled logger that keeps the reference-parity lines byte for byte),
``report`` (``fedtpu_torch.cli report``), ``timeline`` and ``timeline_sim``
(``fedtpu_torch.cli timeline``). No module here imports CUDA at import
time."""
