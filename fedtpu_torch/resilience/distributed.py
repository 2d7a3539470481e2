"""The training gang's resilience pieces (``fedtpu.resilience.distributed``):
the collective watchdog, per-process heartbeats and the checkpoint
agreement.

A gang of processes has a failure mode one process cannot have: a peer
dies or wedges and every survivor blocks in a cross-process collective,
making no progress. These make a gang restartable as a unit:

* **CollectiveWatchdog** — a daemon thread each member runs over its own
  collectives: the round loop arms it around every blocking window (a
  chunk's rounds with their exchanges, the chunk's gathered metrics, a
  collective checkpoint save, the resume agreement) and disarms it after.
  A window open past ``collective_timeout`` seconds becomes a
  ``collective_hang`` event (appended straight to the events JSONL), a
  heartbeat stamp and ``os._exit(75)``: a restartable crash under the
  exit-code contract, never a silent deadlock.
* **Per-process heartbeat files** — ``heartbeat_path_for(base, i)``:
  process 0 keeps the base path, peers get ``<base>.p<i>``.
* **Checkpoint agreement** — on resume every member publishes the newest
  complete step it sees under ``<checkpoint_dir>/.agreement``, tagged with
  the launch-unique generation, waits for every peer and restores the
  minimum; any member seeing none makes the whole gang start fresh.

* **Reshard records** — the live elastic reshard's protocol
  (``fedtpu_torch.resilience.reshard``): notice candidates, the two-phase
  acks and the grow announcement, one file a record under
  ``<checkpoint_dir>/.reshard``, tagged with the same generation as the
  agreement.

Torch-free on purpose: the gang supervisor's parent imports this module.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from fedtpu_torch.resilience.supervisor import EXIT_PREEMPTED, write_heartbeat
from fedtpu_torch.telemetry.trace import EVENT_SCHEMA_VERSION

# Gang-launch environment contract, set per member by ``supervise_gang``
# and read by ``fedtpu_torch.parallel.multihost.initialize_from_env``
# before anything touches the device: the rendezvous address (host:port,
# fresh per relaunch), the gang's size and this member's index (a gateway
# without --gateway-index takes it as its index).
ENV_COORDINATOR = "FEDTPU_COORDINATOR"
ENV_NUM_PROCESSES = "FEDTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "FEDTPU_PROCESS_ID"
# Launch-unique nonce, identical across the gang, fresh per relaunch
# (supervise_gang generates it; a manual launch takes process 0's,
# broadcast by the round loop). The checkpoint agreement's generation is
# (launch_id, restart_count): FEDTPU_RESTARTS alone resets to 0 on every
# new launch, so without the nonce a manual re-launch could read a peer's
# leftover generation-0 record from a previous life. A gateway's failover
# generation too.
ENV_LAUNCH_ID = "FEDTPU_LAUNCH_ID"

# Subdirectory of the checkpoint dir holding the agreement records;
# invisible to resume and retention (only round_* names are rounds).
AGREEMENT_DIR = ".agreement"

# Sentinel step meaning "this process sees no complete checkpoint".
NO_CHECKPOINT = -1

# Subdirectory of the checkpoint dir holding the elastic reshard's records
# and its grow spool; invisible to resume and retention, like the
# agreement's.
RESHARD_DIR = ".reshard"


def heartbeat_path_for(base: str, process_index: int) -> str:
    """Per-process liveness file: process 0 keeps the configured base path,
    peers get ``<base>.p<i>``."""
    return base if process_index == 0 else f"{base}.p{process_index}"


class CollectiveWatchdog:
    """Turns a hung cross-process collective into a restartable crash.

    Usage (the round loop)::

        wd = CollectiveWatchdog(timeout=cfg.run.collective_timeout, ...)
        wd.start()
        with wd.guard("chunk_fetch", round_):
            metrics = fetch(...)          # the call that can block forever
        ...
        wd.stop()

    The timeout clock starts at guard entry, so it bounds the WHOLE
    blocking window — device execution plus the cross-process collective
    — and must be set above EVERY guarded phase's worst-case healthy
    duration: the chunk walltime AND the collective checkpoint save,
    whose duration scales with model/state size independently of chunk
    walltime (the kernels are built before the first guarded window).

    On expiry the watchdog thread appends a ``collective_hang`` event to
    the events JSONL (direct, schema-v1 — the process's tracer may belong
    to another thread or another process entirely), stamps the heartbeat
    file with ``status="collective_hang"`` so the supervisor's view
    agrees, and aborts with ``os._exit(EXIT_PREEMPTED)``. ``os._exit``
    (not ``sys.exit``): the main thread is wedged inside a C++ collective
    and will never unwind a Python exception; the checkpointed state on
    disk is the recovery path, not this process.

    ``_abort`` is injectable for tests (the default really exits).
    """

    def __init__(self, timeout: float, events_path: Optional[str] = None,
                 process_index: int = 0, heartbeat: Optional[str] = None,
                 restart_count: int = 0, poll: Optional[float] = None,
                 _abort=None):
        if timeout <= 0:
            raise ValueError(f"collective_timeout must be > 0, got "
                             f"{timeout}")
        self.timeout = float(timeout)
        self.events_path = events_path
        self.process_index = int(process_index)
        self.heartbeat = heartbeat
        self.restart_count = int(restart_count)
        self._poll = float(poll) if poll else min(1.0, self.timeout / 4.0)
        self._abort = _abort if _abort is not None else self._os_abort
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._phase: Optional[str] = None
        self._round: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    @staticmethod
    def _os_abort(code: int) -> None:
        os._exit(code)  # the hung main thread cannot unwind an exception

    def start(self) -> "CollectiveWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch,
                                            name="fedtpu-collective-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll)
            self._thread = None

    def arm(self, phase: str, round_: Optional[int] = None) -> None:
        with self._lock:
            self._armed_at = time.monotonic()
            self._phase = phase
            self._round = round_

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None
            self._phase = None
            self._round = None

    @contextmanager
    def guard(self, phase: str, round_: Optional[int] = None):
        """Arm for the duration of one blocking collective window."""
        self.arm(phase, round_)
        try:
            yield
        finally:
            self.disarm()

    def _watch(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                armed_at, phase, rnd = (self._armed_at, self._phase,
                                        self._round)
            if armed_at is None:
                continue
            waited = time.monotonic() - armed_at
            if waited > self.timeout:
                self._fire(phase, rnd, waited)
                return

    def _fire(self, phase: Optional[str], round_: Optional[int],
              waited: float) -> None:
        self.fired = True
        payload = {"process": self.process_index, "phase": phase,
                   "timeout_s": self.timeout, "waited_s": round(waited, 3),
                   "restarts": self.restart_count, "pid": os.getpid()}
        if self.events_path:
            # Direct append, flushed: the ENTIRE point is post-mortem
            # attribution, and this thread is about to kill the process.
            try:
                with open(self.events_path, "a") as fh:
                    fh.write(json.dumps({
                        "v": EVENT_SCHEMA_VERSION, "kind": "collective_hang",
                        "round": round_, "dur_s": round(waited, 3),
                        "payload": payload}) + "\n")
                    fh.flush()
            except OSError:
                pass                    # dying loudly beats dying silently
        if self.heartbeat:
            try:
                write_heartbeat(self.heartbeat, status="collective_hang",
                                round=round_ or 0,
                                restarts=self.restart_count)
            except OSError:
                pass
        self._abort(EXIT_PREEMPTED)


def _agreement_file(checkpoint_dir: str, process_index: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), AGREEMENT_DIR,
                        f"p{process_index}.json")


def publish_local_step(checkpoint_dir: str, process_index: int,
                       step: Optional[int], restart_count: int = 0,
                       launch_id: Optional[str] = None) -> str:
    """Atomically publish this process's newest locally-visible COMPLETE
    checkpoint step (``None`` -> ``NO_CHECKPOINT``) for the current
    generation (``launch_id``, ``restart_count``). Returns the protocol
    file path."""
    path = _agreement_file(checkpoint_dir, process_index)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"step": NO_CHECKPOINT if step is None else int(step),
                   "restarts": int(restart_count), "launch": launch_id,
                   "pid": os.getpid(), "time": time.time()}, fh)
    os.replace(tmp, path)
    return path


def _read_peer_step(checkpoint_dir: str, process_index: int,
                    restart_count: int,
                    launch_id: Optional[str] = None) -> Optional[int]:
    """A peer's published step for THIS generation, or None (not yet
    published / stale generation or launch / mid-write garbage)."""
    try:
        with open(_agreement_file(checkpoint_dir, process_index)) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return None
    if rec.get("restarts") != restart_count:
        return None                     # leftover from an earlier restart
    if rec.get("launch") != launch_id:
        return None                     # leftover from a previous launch
    step = rec.get("step")
    return int(step) if isinstance(step, int) else None


def _clear_stale_records(checkpoint_dir: str,
                         launch_id: Optional[str]) -> None:
    """Process 0's pre-publish hygiene: unlink protocol files whose launch
    tag differs from the current one. Current-launch peers are never
    touched (their tag matches); what goes is the previous life's
    leftovers — including files from a LARGER previous gang that no
    current process index would ever overwrite."""
    agreement = os.path.join(os.path.abspath(checkpoint_dir), AGREEMENT_DIR)
    try:
        names = os.listdir(agreement)
    except OSError:
        return
    for name in names:
        if not (name.startswith("p") and name.endswith(".json")):
            continue
        path = os.path.join(agreement, name)
        try:
            with open(path) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            rec = {}                    # unreadable == stale
        if rec.get("launch") != launch_id:
            try:
                os.unlink(path)
            except OSError:
                pass


def agree_resume_step(checkpoint_dir: str, process_index: int,
                      process_count: int, local_step: Optional[int],
                      restart_count: int = 0, timeout: float = 120.0,
                      poll: float = 0.1,
                      launch_id: Optional[str] = None) -> int:
    """Publish ``local_step`` and block until every gang member has
    published for this generation; returns the MINIMUM common step
    (``NO_CHECKPOINT`` when any process sees none — the gang then
    consensually starts fresh rather than split-brain restoring).

    The generation tag is the PAIR (``launch_id``, ``restart_count``):
    ``restart_count`` (identical across the gang via ``FEDTPU_RESTARTS``)
    distinguishes restarts within one supervised launch, and
    ``launch_id`` (identical across the gang via ``FEDTPU_LAUNCH_ID`` or
    a process-0 broadcast) distinguishes LAUNCHES — ``restart_count``
    alone resets to 0 on every new launch, so a manual re-launch over
    the same checkpoint dir would otherwise accept a peer's leftover
    generation-0 file from a previous life and split-brain the restore.
    Readers simply ignore records from any other generation until the
    peer overwrites its file; process 0 additionally unlinks stale
    records before publishing, so they cannot accumulate across
    launches (or linger from a previously larger gang).

    Raises TimeoutError when a peer never publishes: restoring different
    rounds on different hosts would silently corrupt the federation, so
    no-agreement must be fatal (the gang supervisor turns the crash into
    a clean gang restart)."""
    if process_index == 0:
        _clear_stale_records(checkpoint_dir, launch_id)
    publish_local_step(checkpoint_dir, process_index, local_step,
                       restart_count, launch_id=launch_id)
    deadline = time.monotonic() + timeout
    missing = set(range(process_count))
    steps = {}
    while missing:
        for i in sorted(missing):
            s = _read_peer_step(checkpoint_dir, i, restart_count,
                                launch_id=launch_id)
            if s is not None:
                steps[i] = s
                missing.discard(i)
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint agreement timed out after {timeout:.0f}s: "
                f"process(es) {sorted(missing)} never published a resume "
                f"step under {checkpoint_dir}/{AGREEMENT_DIR} "
                f"(generation {restart_count}, launch {launch_id}); "
                "restoring without agreement could desync the gang")
        time.sleep(poll)
    return min(steps.values())


# --------------------------------------------------- reshard protocol

def reshard_dir(checkpoint_dir: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), RESHARD_DIR)


def _reshard_file(checkpoint_dir: str, name: str, process_index: int) -> str:
    return os.path.join(reshard_dir(checkpoint_dir),
                        f"{name}.p{process_index}.json")


def publish_reshard_record(checkpoint_dir: str, name: str,
                           process_index: int, payload: dict,
                           restart_count: int = 0,
                           launch_id: Optional[str] = None) -> str:
    """Atomically publish one elastic-reshard record (a notice candidate,
    a commit ack, a grow announcement) for the current generation, with
    ``publish_local_step``'s tmp-then-rename discipline. The generation tag
    (``launch_id``, ``restart_count``) keeps a relaunched gang from acting
    on a previous life's records."""
    path = _reshard_file(checkpoint_dir, name, process_index)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(dict(payload, restarts=int(restart_count),
                       launch=launch_id, pid=os.getpid(),
                       time=time.time()), fh)
    os.replace(tmp, path)
    return path


def read_reshard_record(checkpoint_dir: str, name: str, process_index: int,
                        restart_count: int = 0,
                        launch_id: Optional[str] = None) -> Optional[dict]:
    """A peer's published reshard record for THIS generation, or None
    (absent, mid-write, or of another generation or launch)."""
    try:
        with open(_reshard_file(checkpoint_dir, name, process_index)) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return None
    if rec.get("restarts") != restart_count:
        return None
    if rec.get("launch") != launch_id:
        return None
    return rec


def await_reshard_records(checkpoint_dir: str, name: str, processes,
                          restart_count: int = 0,
                          launch_id: Optional[str] = None,
                          timeout: float = 60.0,
                          poll: float = 0.05) -> dict:
    """Block until every process in ``processes`` has published ``name``
    for this generation; ``{process_index: record}``. A missing peer is a
    ``TimeoutError``: the reshard's commit barrier, where a peer that dies
    mid-reshard surfaces as a loud failure the caller turns into the
    gang-restart path, never a half-resharded gang."""
    deadline = time.monotonic() + timeout
    missing = set(processes)
    records = {}
    while missing:
        for i in sorted(missing):
            rec = read_reshard_record(checkpoint_dir, name, i,
                                      restart_count, launch_id=launch_id)
            if rec is not None:
                records[i] = rec
                missing.discard(i)
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"reshard record '{name}' missing from process(es) "
                f"{sorted(missing)} after {timeout:.0f}s under "
                f"{checkpoint_dir}/{RESHARD_DIR} (generation "
                f"{restart_count}, launch {launch_id})")
        time.sleep(poll)
    return records


def clear_reshard_records(checkpoint_dir: str) -> None:
    """Remove the reshard directory (the spool included): process 0's
    hygiene at a run's start, so a later launch in the same directory never
    sees a dead gang's notices."""
    import shutil
    try:
        shutil.rmtree(reshard_dir(checkpoint_dir))
    except OSError:
        pass
