"""fedtpu_torch.resilience: deterministic fault injection, supervised
restart and divergence rollback (``fedtpu.resilience``).

* ``faults`` — the seeded FaultPlan (client dropout, straggler delay, NaN
  corruption, process kill, checkpoint corruption) applied inside the
  round loop via ``RunConfig.fault_plan`` / ``run --fault-plan``.
* ``supervisor`` — the exit-code contract (0 done / 3 diverged / 75
  preempted / 76 resharded), the heartbeat file, and ``supervise``: one
  child, restarted with ``--resume`` under bounded exponential backoff.
* ``oracles`` — the invariant-oracle library (bitwise history, the exit
  contract, checkpoint restorability, ...), one pure function per bar.
* ``chaos`` — ``chaos``: the single-process scenario matrix (SIGKILL,
  preemption, NaN rollback, dropout, straggler).
* ``netfaults`` / ``net_sim`` — the wire-fault plan and its deterministic
  replay; ``distributed`` — the gang's identity variables and the
  heartbeat path rule.

Not ported yet: the gang supervisor, the collective watchdog and the
checkpoint agreement (ROADMAP A10), ``fuzz`` and the gateway, poisoning
and wire chaos rows (ROADMAP A11b, second part).
"""

from fedtpu_torch.resilience.distributed import heartbeat_path_for
from fedtpu_torch.resilience.supervisor import (EXIT_DIVERGED, EXIT_OK,
                                                EXIT_PREEMPTED,
                                                EXIT_RESHARDED, Preempted,
                                                read_heartbeat,
                                                restart_backoff, supervise,
                                                write_heartbeat)

__all__ = [
    "EXIT_OK", "EXIT_DIVERGED", "EXIT_PREEMPTED", "EXIT_RESHARDED",
    "Preempted", "read_heartbeat", "write_heartbeat", "restart_backoff",
    "supervise", "heartbeat_path_for",
]
