"""SLO-driven autoscaling control plane (the port's copy of
``fedtpu.autoscale``).

Three layers, strictly stacked so every one is testable on its own:

- :mod:`fedtpu_torch.autoscale.signals` — a :class:`SignalBus` folds live
  telemetry (serving ``stats`` payloads, heartbeat files) into a
  versioned, immutable :class:`Snapshot` per control tick.
- :mod:`fedtpu_torch.autoscale.policy` — pure virtual-clock policy
  functions map a snapshot to an ordered decision list (``grow`` /
  ``shrink`` / ``set_cohort_size`` / ``set_tick_cadence`` / ``pre_drain``
  / ``hold``), bitwise-replayable.
- :mod:`fedtpu_torch.autoscale.controller` — the actuator: the serving
  engine's ``configure`` / ``pre_drain`` protocol ops, SIGUSR1/SIGUSR2 to
  a gang supervisor, and a deterministic virtual-time simulator.

Import the submodules directly (``from fedtpu_torch.autoscale import
policy``); this package initializer deliberately imports nothing.
"""

__all__ = ["signals", "policy", "controller"]
