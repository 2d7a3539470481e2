"""fedtpu_torch.resilience: deterministic fault injection, supervised
restart and divergence rollback (``fedtpu.resilience``).

* ``faults`` — the seeded FaultPlan (client dropout, straggler delay, NaN
  corruption, process kill, checkpoint corruption) applied inside the
  round loop via ``RunConfig.fault_plan`` / ``run --fault-plan``.
* ``supervisor`` — the exit-code contract (0 done / 3 diverged / 75
  preempted / 76 resharded), the heartbeat file, ``supervise``: one
  child, restarted with ``--resume`` under bounded exponential backoff,
  and ``supervise_gang``: N members torn down and relaunched as a unit.
* ``oracles`` — the invariant-oracle library (bitwise history, the exit
  contract, checkpoint restorability, ...), one pure function per bar.
* ``chaos`` — ``chaos``: the scenario matrix, its single-process rows
  (SIGKILL, preemption, NaN rollback, dropout, straggler) and its gateway,
  poisoning and wire rows (two-gateway fleets under the gang supervisor).
* ``fuzz`` — ``fuzz``: seeded composed fault campaigns replayed against a
  deterministic in-process two-gateway gang, judged by the oracles,
  failures ddmin-shrunk to reproducers; the committed corpus gate.
* ``netfaults`` / ``net_sim`` — the wire-fault plan and its deterministic
  replay; ``distributed`` — the gang's identity variables, the heartbeat
  path rule, the collective watchdog, the checkpoint agreement and the
  reshard records of a training gang (``run`` under ``supervise
  --num-processes N``).
* ``reshard`` — the live elastic reshard's protocol: the plan's and the
  signals' notices, their agreement, the two-phase ack barrier, the grow
  spool and the parked member's wait (exit 76).
"""

from fedtpu_torch.resilience.distributed import heartbeat_path_for
from fedtpu_torch.resilience.supervisor import (EXIT_DIVERGED, EXIT_OK,
                                                EXIT_PREEMPTED,
                                                EXIT_RESHARDED, Preempted,
                                                read_heartbeat,
                                                restart_backoff, supervise,
                                                supervise_gang,
                                                write_heartbeat)

__all__ = [
    "EXIT_OK", "EXIT_DIVERGED", "EXIT_PREEMPTED", "EXIT_RESHARDED",
    "Preempted", "read_heartbeat", "write_heartbeat", "restart_backoff",
    "supervise", "supervise_gang", "heartbeat_path_for",
]
