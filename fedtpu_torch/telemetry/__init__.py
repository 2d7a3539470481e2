"""The port's telemetry: the pieces of ``fedtpu.telemetry`` that the
serving path imports (``metrics``, ``_percentiles``, ``NullTracer``,
``TelemetryLogger``). The event sink, reports and timelines are ROADMAP
A11."""
