"""Trace-driven FL serving front-end on the port's asynchronous engine (the
port's copy of ``fedtpu.serving``).

    traces    — versioned JSONL arrival-trace schema, a heavy-tailed
                synthesizer (Zipf user popularity x lognormal burstiness),
                and deterministic replay
    admission — token-bucket rate limiting, staleness-aware
                accept / deprioritize / reject, queue-depth backpressure
    protocol  — the newline-delimited-JSON socket protocol ``serve``
                speaks (versioned; batch frames for load)
    engine    — ServingEngine: admitted arrivals map onto a bounded
                cohort of engine slots and become DRIVEN async ticks
                (build_async_round_fn(driven=True)), one CUDA graph
                replay each on the card
    server    — the long-running ``serve`` process: socket loop,
                SIGTERM -> drain -> checkpoint -> exit 75
    client    — the retrying, session-stamping protocol client
    loadgen   — ``loadgen``: replays an arrival trace against a running
                server for millions of simulated users

Import-light: nothing here imports torch at module scope; the engine
imports it at construction. The gateway fleet and the wire-fault proxy
are ROADMAP A8c.
"""

from fedtpu_torch.serving.admission import (AdmissionController,  # noqa: F401
                                            TokenBucket, VERDICTS)
from fedtpu_torch.serving.traces import (TRACE_SCHEMA_VERSION,  # noqa: F401
                                         TRACE_SCHEMA_VERSION_POISON,
                                         poisoned_user_ids, read_trace,
                                         synthesize_trace, write_trace)
