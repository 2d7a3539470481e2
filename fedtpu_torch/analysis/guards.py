"""Runtime guards: a recompile sentinel, the transfer guard and the
finiteness check (``fedtpu.analysis.guards`` in torch terms).

``RecompileSentinel`` counts the port's compile events while armed: CUDA
graph captures and nvcc kernel builds, the ``graph_captures`` and
``kernel_builds`` counters that ``telemetry.metrics.compile_event`` keeps
in the default registry (``fedtpu``'s sentinel counts XLA backend
compiles). After the warm-up and the capture, a steady-state round loop
replays its graphs and builds nothing, so any armed-window event is an
unexpected recapture or rebuild. The counters are process-wide, as
``fedtpu``'s ``jax.monitoring`` listener is: another thread's capture
inside the window counts too.

``guards()`` scopes ``torch.cuda.set_sync_debug_mode`` over a block,
``fedtpu``'s ``jax.transfer_guard`` levels mapped as allow 0, log 1
(warn on every synchronising call) and disallow 2 (raise). A chunk-end
host read is a deliberate synchronisation (``fedtpu``'s guard allows its
explicit ``device_get``), so callers arm the guard around the queued work
only. On the CPU there is nothing to synchronise and the guard does not
apply.

``first_nonfinite`` is the ``--debug-nans`` check: the name of the first
state tensor holding a NaN or an infinity, or None.

torch is imported lazily, so that importing this module never touches a
device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from fedtpu_torch.telemetry.metrics import MetricsRegistry, default_registry

__all__ = ["RecompileSentinel", "guards", "RetraceError", "first_nonfinite",
           "TRANSFER_LEVELS"]

# fedtpu's transfer-guard levels -> torch.cuda.set_sync_debug_mode's.
TRANSFER_LEVELS = {"allow": 0, "log": 1, "disallow": 2}

# The default registry's compile counters (telemetry.metrics.compile_event).
_COMPILE_COUNTERS = ("graph_captures", "kernel_builds")


class RetraceError(RuntimeError):
    """An armed RecompileSentinel observed unexpected compilations."""


def _compile_events() -> int:
    counters = default_registry().snapshot()["counters"]
    return int(sum(counters.get(name, 0) for name in _COMPILE_COUNTERS))


class RecompileSentinel:
    """Counts compile events (graph captures, kernel builds) observed while
    armed.

    Usage::

        sentinel = RecompileSentinel(label="round_step")
        graph = capture_round_step(step, state, batch)  # uncounted
        with sentinel.armed():
            for _ in range(rounds):
                graph()
        assert sentinel.count == 0  # or fail=True to raise on exit

    ``fail=True`` raises :class:`RetraceError` when the armed block exits
    with a nonzero count. Each window's count is added to ``registry``'s
    ``unexpected_retraces`` counter (the default registry's by default),
    as ``fedtpu``'s."""

    def __init__(self, *, label: str = "step",
                 registry: Optional[MetricsRegistry] = None,
                 fail: bool = False):
        self.label = label
        self.registry = (registry if registry is not None
                         else default_registry())
        self.fail = fail
        # The counters always exist: the sentinel can always count.
        self.available = True
        self._count = 0
        self._start: Optional[int] = None

    @property
    def count(self) -> int:
        if self._start is None:
            return self._count
        return self._count + _compile_events() - self._start

    def arm(self) -> None:
        if self._start is None:
            self._start = _compile_events()

    def disarm(self) -> None:
        if self._start is not None:
            seen = _compile_events() - self._start
            self._start = None
            self._count += seen
            if seen:
                self.registry.counter("unexpected_retraces").inc(seen)

    @contextlib.contextmanager
    def armed(self) -> Iterator["RecompileSentinel"]:
        self.arm()
        try:
            yield self
        finally:
            self.disarm()
            if self.fail and self._count:
                raise RetraceError(
                    f"{self._count} unexpected recompile(s) of "
                    f"`{self.label}` while armed — steady-state calls "
                    "should replay their graphs (check shapes, dtypes and "
                    "a chunk width that changed)")


def transfer_guard_applies(device) -> bool:
    """Whether ``guards(transfer=...)`` arms anything on ``device``."""
    import torch
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def guards(*, transfer: str = "log", device="cuda",
           sentinel: Optional[RecompileSentinel] = None
           ) -> Iterator[Optional[RecompileSentinel]]:
    """Scope the runtime guards over a block: the transfer guard
    (``torch.cuda.set_sync_debug_mode`` at ``TRANSFER_LEVELS[transfer]``,
    restored on exit; nothing on the CPU) and ``sentinel``, armed."""
    import torch
    if transfer not in TRANSFER_LEVELS:
        raise ValueError(f"transfer guard {transfer!r}: pick one of "
                         f"{sorted(TRANSFER_LEVELS)}")
    with contextlib.ExitStack() as stack:
        if transfer_guard_applies(device):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(TRANSFER_LEVELS[transfer])
            stack.callback(torch.cuda.set_sync_debug_mode, prev)
        if sentinel is not None:
            stack.enter_context(sentinel.armed())
        yield sentinel


def first_nonfinite(state: dict, prefix: str = "") -> Optional[str]:
    """The path (``a/b``) of the first floating tensor of ``state`` (keys
    sorted, nested dicts walked) holding a NaN or an infinity, or None.
    One host read per tensor: a synchronising check, outside the
    transfer guard."""
    import torch
    for key in sorted(state):
        value = state[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            hit = first_nonfinite(value, prefix=f"{path}/")
            if hit is not None:
                return hit
        elif (isinstance(value, torch.Tensor)
              and value.is_floating_point()
              and not bool(torch.isfinite(value).all())):
            return path
    return None
