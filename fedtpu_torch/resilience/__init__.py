"""The port's resilience pieces: the wire-fault plan (``netfaults``), its
deterministic replay (``net_sim``), and the two pieces of ``fedtpu``'s
multi-process layer the gateway fleet and the autoscale signals read
(``distributed``: the process-id and launch-id variables and the heartbeat
path rule; ``supervisor``: ``read_heartbeat``). The supervisor itself
(``supervise --gang``), fault plans, chaos and fuzzing are ROADMAP A11."""
