"""The port's cohort pieces: the per-client state store
(``cohort.store.ClientStateStore``), which the serving engine and the
gateway fleet use. ``fedtpu``'s cohort scheduler is ROADMAP A9."""

from fedtpu_torch.cohort.store import ClientStateStore  # noqa: F401

__all__ = ["ClientStateStore"]
