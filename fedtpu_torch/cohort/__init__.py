"""The port's cohort engine (``fedtpu.cohort``): the per-client state store
(``cohort.store.ClientStateStore``), which the serving engine and the
gateway fleet use too, and the streaming cohort scheduler over it
(``cohort.scheduler``: ``CohortSampler``, ``CohortScheduler``,
``run_cohort_experiment``)."""

from fedtpu_torch.cohort.scheduler import (CohortSampler,  # noqa: F401
                                           CohortScheduler,
                                           run_cohort_experiment)
from fedtpu_torch.cohort.store import ClientStateStore  # noqa: F401

__all__ = ["ClientStateStore", "CohortSampler", "CohortScheduler",
           "run_cohort_experiment"]
