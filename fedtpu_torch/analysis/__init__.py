"""fedtpu_torch.analysis: the runtime probe (``fedtpu.analysis``'s
``guards`` and ``check``, in torch terms).

* ``guards`` — ``RecompileSentinel`` (the port's compile events — CUDA
  graph captures and nvcc builds — counted over an armed window),
  ``guards()`` (the transfer guard as ``torch.cuda.set_sync_debug_mode``)
  and ``first_nonfinite`` (the ``--debug-nans`` check).
* ``check`` — ``run_check``: the ``check`` command's probe that the
  steady-state round step is capture-free.

The static side (``lint``, ``audit``), ``lockdep`` and the collective
census are ROADMAP A11d.
"""

from fedtpu_torch.analysis.guards import (RecompileSentinel, RetraceError,
                                          first_nonfinite, guards)

__all__ = ["RecompileSentinel", "RetraceError", "first_nonfinite", "guards"]
