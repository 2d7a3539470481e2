"""The gang's identity variables and the heartbeat path rule (the port's
copy of the pieces of ``fedtpu.resilience.distributed`` that the gateway
fleet, the autoscale signals, the round loop's heartbeat and the
supervisor's clean-exit hygiene read; the collective watchdog and the
checkpoint agreement are ROADMAP A10)."""

from __future__ import annotations

# This process's index in its gang (set by the gang supervisor; a gateway
# without --gateway-index takes it as its index).
ENV_PROCESS_ID = "FEDTPU_PROCESS_ID"
# Launch-unique nonce, identical across the gang, fresh per relaunch: a
# gateway's failover generation, so a survivor never adopts a previous
# life's export.
ENV_LAUNCH_ID = "FEDTPU_LAUNCH_ID"


def heartbeat_path_for(base: str, process_index: int) -> str:
    """Per-process liveness file: process 0 keeps the configured base path,
    peers get ``<base>.p<i>``."""
    return base if process_index == 0 else f"{base}.p{process_index}"
