"""Supervised execution: the exit-code contract, the heartbeat, and the
auto-restart of one child (``fedtpu.resilience.supervisor``).

The contract between the round loop, the CLI and the supervisor:

* ``EXIT_OK`` (0) — the run completed (or stopped early).
* ``EXIT_DIVERGED`` (3) — the divergence policy halted the run (the
  poisoned state quarantined under ``<checkpoint_dir>/diverged``). A
  restart would re-diverge deterministically, so it is never restarted.
* ``EXIT_PREEMPTED`` (75, BSD EX_TEMPFAIL) — the loop caught SIGTERM,
  drained to a checkpoint and exited; the supervisor restarts at once with
  ``--resume`` (no backoff: the exit was graceful).
* ``EXIT_RESHARDED`` (76) — a gang member's clean departure through an
  elastic reshard (ROADMAP A10): never a failure, never restarted.
* anything else — a crash (SIGKILL shows as a negative returncode): a
  restart with ``--resume`` under bounded exponential backoff, whose
  exponent follows the crash streak; a child that stayed up past
  ``healthy_window`` seconds resets the streak.

SIGTERM/SIGINT to the supervisor drain the child and return its code;
SIGUSR1/SIGUSR2 are forwarded to it (a preemption notice). ``--heartbeat``
is rewritten atomically by the child; ``--hang-timeout`` turns a stale one
into SIGKILL and a restart without backoff.

A restarted child gets ``FEDTPU_RESTARTS=<n>`` (the fault injector disarms
the once-per-run kinds when > 0, ``fedtpu_torch.resilience.faults``) and
``FEDTPU_SUPERVISED=1``. Resume restores the state bit for bit and the
round is deterministic, so a run killed mid-round finishes with the
uninterrupted run's history exactly.

This module imports neither torch nor numpy: the supervising parent only
starts children, so a restart never holds a second CUDA context on the
card. The gang supervisor (``supervise --num-processes N``) is ROADMAP
A10."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

EXIT_OK = 0
EXIT_DIVERGED = 3
EXIT_PREEMPTED = 75          # EX_TEMPFAIL: drained to checkpoint, resumable
# A gang member's completed elastic-reshard departure (ROADMAP A10).
EXIT_RESHARDED = 76


class Preempted(Exception):
    """Raised by the round loop (and the server) after a SIGTERM drain:
    the state is checkpointed; the process should exit ``EXIT_PREEMPTED``
    so the supervisor restarts it with ``--resume``."""

    def __init__(self, round_: int):
        super().__init__(f"preempted at round {round_} (checkpoint drained)")
        self.round = round_


def restart_backoff(rc: int, hung: bool, crash_streak: int,
                    backoff_base: float, backoff_max: float) -> float:
    """The crash-restart delay, a pure function of the exit disposition
    and the crash streak (no wall clock, no jitter): a preemption (exit
    75) or a heartbeat-detected hang restarts at once; a crash backs off
    exponentially from ``backoff_base``, capped at ``backoff_max``."""
    if rc == EXIT_PREEMPTED or hung:
        return 0.0
    return min(float(backoff_max),
               float(backoff_base) * (2.0 ** int(crash_streak)))


def write_heartbeat(path: str, **payload) -> None:
    """Atomic heartbeat write (tmp + rename): the supervisor's liveness
    probe never sees a half-written file."""
    payload.setdefault("pid", os.getpid())
    payload["time"] = time.time()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


def read_heartbeat(path: str) -> Optional[dict]:
    """Last heartbeat payload, or None (missing/mid-crash garbage)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _drain_child(child: subprocess.Popen, grace: float) -> int:
    """Graceful handoff: SIGTERM, wait ``grace`` for the checkpoint
    drain, then SIGKILL. Returns the child's returncode."""
    child.terminate()
    try:
        return child.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        child.kill()
        return child.wait()


def _wait(child: subprocess.Popen, signaled: dict, heartbeat: Optional[str],
          hang_timeout: Optional[float], grace: float,
          started: float) -> Tuple[int, bool]:
    """Poll the child to completion. Returns (returncode, hung). Forwards
    an external stop signal as a graceful drain; a heartbeat stale past
    ``hang_timeout`` is killed and reported as hung."""
    while True:
        try:
            return child.wait(timeout=0.2), False
        except subprocess.TimeoutExpired:
            pass
        usr = signaled.pop("usr", None)
        if usr is not None:
            # A preemption notice, not a stop: forward and keep supervising.
            try:
                child.send_signal(usr)
            except OSError:
                pass
        if signaled["sig"] is not None:
            return _drain_child(child, grace), False
        if hang_timeout and heartbeat:
            try:
                last = os.path.getmtime(heartbeat)
            except OSError:
                last = started          # not written yet: age from launch
            if time.time() - max(last, started) > hang_timeout:
                child.kill()
                return child.wait(), True


def _register_handlers(signaled: dict) -> List[Tuple[int, object]]:
    """SIGTERM/SIGINT -> external stop (drain); SIGUSR1/SIGUSR2 ->
    preemption notice to forward. Main thread only (the signal module's
    rule); returns (signum, previous_handler) pairs to restore."""
    restore: List[Tuple[int, object]] = []
    if threading.current_thread() is not threading.main_thread():
        return restore

    def _on_sig(signum, frame):
        signaled["sig"] = signum

    for s in (signal.SIGTERM, signal.SIGINT):
        restore.append((s, signal.signal(s, _on_sig)))

    def _on_usr(signum, frame):
        signaled["usr"] = signum

    for name in ("SIGUSR1", "SIGUSR2"):
        s = getattr(signal, name, None)
        if s is not None:
            restore.append((s, signal.signal(s, _on_usr)))
    return restore


def _cleanup_run_artifacts(child_argv: Sequence[str],
                           heartbeat: Optional[str]) -> None:
    """A run that ended ``EXIT_OK`` leaves no liveness or agreement residue
    behind: a later launch in the same directory must not take a dead
    child's heartbeat, or its ``.agreement``/``.reshard`` records under the
    child's ``--checkpoint-dir``, for a live or resumable one."""
    import shutil
    if heartbeat:
        try:
            os.unlink(heartbeat)
        except OSError:
            pass
    argv = list(child_argv)
    try:
        idx = argv.index("--checkpoint-dir")
    except ValueError:
        return
    if idx + 1 < len(argv):
        ckpt = os.path.abspath(argv[idx + 1])
        for sub in (".agreement", ".reshard"):
            shutil.rmtree(os.path.join(ckpt, sub), ignore_errors=True)


def supervise(child_argv: Sequence[str], max_restarts: int = 2,
              backoff_base: float = 1.0, backoff_max: float = 30.0,
              grace: float = 15.0, hang_timeout: Optional[float] = None,
              heartbeat: Optional[str] = None, events: Optional[str] = None,
              extra_env: Optional[dict] = None,
              healthy_window: float = 300.0,
              _cmd_prefix: Optional[List[str]] = None,
              verbose: bool = True) -> int:
    """Run ``python -m fedtpu_torch.cli <child_argv>`` as a child process
    and keep it alive by the exit-code contract above. Returns the final
    exit code (the child's last code when the budget is spent).

    ``heartbeat`` is passed to ``run``/``serve``/``gateway`` children as
    ``--heartbeat`` and watched when ``hang_timeout`` is set. ``events``
    appends the supervisor's events (supervisor_start, child_start,
    child_exit, restart, supervisor_exit) to the sink the child's tracer
    appends to: one merged timeline. ``_cmd_prefix`` replaces the default
    child command (tests script their children with it)."""
    from fedtpu_torch.telemetry.trace import make_tracer
    tracer = make_tracer(events, role="supervisor")
    prefix = (list(_cmd_prefix) if _cmd_prefix is not None
              else [sys.executable, "-m", "fedtpu_torch.cli"])
    base = list(child_argv)
    # serve/gateway children keep the run's SIGTERM -> drain -> 75
    # contract, so they get the same --resume/--heartbeat wiring.
    is_run = bool(base) and base[0] in ("run", "serve", "gateway")
    if heartbeat and is_run and "--heartbeat" not in base:
        base += ["--heartbeat", heartbeat]

    # SIGTERM/SIGINT to the supervisor drain the child and return ITS code
    # (an external stop of the whole tree is not answered by a restart);
    # handlers exist on the main thread only.
    signaled = {"sig": None}
    restore = _register_handlers(signaled)

    restarts = 0
    crash_streak = 0
    tracer.event("supervisor_start", max_restarts=max_restarts,
                 cmd=prefix + base)
    try:
        while True:
            argv = list(base)
            if restarts > 0 and is_run and "--resume" not in argv:
                argv.append("--resume")
            env = dict(os.environ, FEDTPU_RESTARTS=str(restarts),
                       FEDTPU_SUPERVISED="1")
            if extra_env:
                env.update(extra_env)
            started = time.time()
            child = subprocess.Popen(prefix + argv, env=env)
            tracer.event("child_start", pid=child.pid, restarts=restarts)
            rc, hung = _wait(child, signaled, heartbeat, hang_timeout,
                             grace, started)
            tracer.event("child_exit", rc=rc, restarts=restarts, hung=hung,
                         dur_s=time.time() - started)
            if signaled["sig"] is not None:
                tracer.event("supervisor_exit", rc=rc, reason="signaled",
                             restarts=restarts)
                tracer.flush_crash(reason=f"signaled:rc={rc}")
                return rc
            if rc in (EXIT_OK, EXIT_DIVERGED):
                # 3 is a policy halt: a restart would re-diverge.
                tracer.event("supervisor_exit", rc=rc,
                             reason="done" if rc == EXIT_OK else "diverged",
                             restarts=restarts)
                tracer.flush_crash(reason=f"exit:rc={rc}")
                if rc == EXIT_OK:
                    _cleanup_run_artifacts(base, heartbeat)
                return rc
            if restarts >= max_restarts:
                tracer.event("supervisor_exit", rc=rc,
                             reason="budget_exhausted", restarts=restarts)
                tracer.flush_crash(reason=f"budget_exhausted:rc={rc}")
                if verbose:
                    print(f"[supervise] rc={rc} with restart budget "
                          f"exhausted ({max_restarts}); giving up")
                return rc
            # A child that stayed up past healthy_window earned base
            # backoff back: its crash is a new incident.
            if healthy_window and time.time() - started >= healthy_window:
                crash_streak = 0
            delay = restart_backoff(rc, hung, crash_streak,
                                    backoff_base, backoff_max)
            if delay:
                crash_streak += 1
            restarts += 1
            tracer.event("restart", restarts=restarts, rc=rc, hung=hung,
                         backoff_s=delay, resume=is_run,
                         crash_streak=crash_streak)
            if verbose:
                why = "hung" if hung else (
                    "preempted" if rc == EXIT_PREEMPTED else f"rc={rc}")
                print(f"[supervise] child {why}; restart "
                      f"{restarts}/{max_restarts}"
                      + (f" after {delay:.1f}s backoff" if delay else ""))
            if delay:
                time.sleep(delay)
    finally:
        for s, h in restore:
            signal.signal(s, h)
        tracer.close()
