"""Poisoning defense at serving scale (the port's copy of
``fedtpu.robust``).

1. **Streaming screening**: ``fedtpu_torch.parallel.async_fed``'s driven
   tick screens each submitted update on the device (non-finite guard,
   norm against the rolling median, cosine against the server direction)
   BEFORE it touches the K-buffer; the serving engine reads the tick's
   screened flags back and never counts a screened update as
   incorporated.
2. **Reputation / quarantine**: screened strikes accumulate per user id in
   the ServingEngine; at the configured threshold the id is quarantined
   (refused at offer()), and flagged durably in an attached cohort
   store's record.

This package holds the deterministic defense simulation that drives the
screening engine over a seeded adversarial trace.
"""

from fedtpu_torch.robust.defense_sim import (SIM_POISON_FRAC,  # noqa: F401
                                             SIM_POISON_SCALE, SIM_SEED,
                                             SIM_USERS, simulate)
