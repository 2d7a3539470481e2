"""The long-running ``serve`` process (the port's copy of
``fedtpu.serving.server``).

A single-threaded selectors loop over one localhost listening socket:
clients (the loadgen, a sidecar) stream update notifications in the
newline-JSON protocol (``fedtpu_torch.serving.protocol``), each one passes
admission, and admitted ones become driven engine ticks
(``fedtpu_torch.serving.engine``). Single-threaded is a feature: the
engine's determinism contract (same trace => same history, bitwise) needs
a total order over arrivals, and one thread is the cheapest total order.

Lifecycle honors ``fedtpu``'s supervisor contract:

    SIGTERM/SIGINT -> finish the in-flight frame -> drain (incorporate
    everything pending) -> checkpoint (engine + serving host state +
    tick history) -> raise Preempted -> the CLI exits EXIT_PREEMPTED (75)

so a restart with ``--resume`` finds the buffer state RECOVERABLE rather
than dropped.

``events`` is the telemetry sink (``fedtpu_torch.telemetry``): the
process's tracer, role ``serve`` (a gateway's ``gateway-<i>``), receives
the server's and the engine's events; the crash barrier flushes its flight
recorder to ``events.crash.<role>.jsonl``. Not ported yet: the heartbeat
file (``heartbeat``), ROADMAP A11b; it raises when given. torch is only
touched through the engine; this module stays importable backend-free.
"""

from __future__ import annotations

import os
import selectors
import signal
import socket
import threading
from typing import Optional

from fedtpu_torch.config import _not_ported
from fedtpu_torch.serving import protocol
from fedtpu_torch.serving.engine import ServingEngine
from fedtpu_torch.telemetry.log import TelemetryLogger
from fedtpu_torch.telemetry.metrics import default_registry
from fedtpu_torch.telemetry.trace import make_tracer

# fedtpu's supervisor exit code (fedtpu/resilience/supervisor.py:59):
# EX_TEMPFAIL, drained to a checkpoint, resumable.
EXIT_PREEMPTED = 75

# Seconds between selector wakeups when idle — bounds signal/heartbeat
# latency, not throughput (a busy socket wakes the loop immediately).
_POLL_S = 0.2

# Per-socket timeout on client connections. send_msg blocks in sendall
# on the single-threaded loop, so a peer that stops reading while we
# hold a response would wedge ingestion for every connection; the
# timeout turns it into a dropped connection instead (socket.timeout is
# an OSError, handled by the per-connection except below).
_CONN_TIMEOUT_S = 30.0


class Preempted(Exception):
    """Raised by ``run_server`` after a SIGTERM drain: the state is
    checkpointed; the process should exit ``EXIT_PREEMPTED`` so a
    supervisor restarts it with ``--resume`` (``fedtpu``'s
    ``resilience.supervisor.Preempted``)."""

    def __init__(self, round_: int):
        super().__init__(f"preempted at round {round_} (checkpoint drained)")
        self.round = round_


class _Conn:
    """Per-connection recv buffer. A LineBuffer, not a plain bytearray:
    an oversized line is refused at the cap with an error frame and the
    connection survives (the error-frame contract), instead of the legacy
    drop — see protocol.recv_lines."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = protocol.LineBuffer()


def _frame_trace(msg: dict):
    """The frame's causal trace id: the client-stamped ``trace`` field
    when present, else derived server-side from the idempotency stamp
    (same pure function — protocol.trace_id — so old clients' frames
    still chain, and a retry still maps to the SAME id)."""
    trace = msg.get("trace")
    if trace:
        return str(trace)
    nonce, seq = msg.get("nonce"), msg.get("seq")
    if nonce is not None and seq is not None:
        try:
            return protocol.trace_id(nonce, seq)
        except (TypeError, ValueError):
            return None
    return None


def _handle(engine: ServingEngine, msg: dict) -> dict:
    """One request -> one response. Unknown/malformed ops answer with an
    ``error`` frame instead of dropping the connection — a loadgen
    mid-replay must not lose its socket to one bad frame."""
    op = msg.get("op")
    if op == "hello":
        v = msg.get("v")
        if v != protocol.PROTOCOL_VERSION:
            return protocol.error_msg(
                f"protocol v={v} unsupported (server speaks "
                f"v={protocol.PROTOCOL_VERSION})")
        trace = msg.get("trace")
        if trace:
            engine._trace("client_stamp", trace, op="hello",
                          nonce=(str(msg["nonce"]) if msg.get("nonce")
                                 else None), seq=0)
        return {"op": "welcome", "v": protocol.PROTOCOL_VERSION,
                "cohort": engine.C, "version": engine.version}
    if op == "update":
        nonce, seq = msg.get("nonce"), msg.get("seq")
        trace = _frame_trace(msg)
        # Ingress record FIRST: even a frame the dedup gate drops shows
        # its arrival in the causal chain.
        engine._trace("client_stamp", trace, op=op,
                      nonce=(None if nonce is None else str(nonce)),
                      seq=(None if seq is None else int(seq)), events=1)
        cached = engine.session_check(nonce, seq, 1, trace=trace)
        if cached is not None:
            verdict = ("duplicate" if "duplicate" in cached
                       else next(iter(cached)))
            return {"op": "ack", "verdict": verdict,
                    "version": engine.version, "duplicate": True}
        try:
            row = [int(msg["user"]), float(msg["t"]),
                   float(msg.get("lat", 0.0))]
            if msg.get("version") is not None:
                row.append(int(msg["version"]))
            if float(msg.get("poison", 0.0)) > 0.0:
                # Poison rides index 4 (the WAL/replay layout); pad the
                # version slot so the row stays positional.
                if len(row) == 3:
                    row.append(None)
                row.append(float(msg["poison"]))
        except (KeyError, TypeError, ValueError) as e:
            return protocol.error_msg(f"bad update frame: {e}")
        engine.wal_append(nonce, seq, [row], trace=trace)
        verdict = engine.offer(row[1], row[0], row[2],
                               version=(row[3] if len(row) > 3 else None),
                               poison=(float(row[4]) if len(row) > 4 else 0.0),
                               trace=trace)
        engine.session_commit(nonce, seq, {verdict: 1})
        return {"op": "ack", "verdict": verdict, "version": engine.version}
    if op == "updates":
        events = msg.get("events")
        if not isinstance(events, list):
            return protocol.error_msg("updates frame needs an events list")
        if len(events) > protocol.MAX_BATCH_EVENTS:
            return protocol.error_msg(
                f"batch of {len(events)} exceeds "
                f"MAX_BATCH_EVENTS={protocol.MAX_BATCH_EVENTS}")
        nonce, seq = msg.get("nonce"), msg.get("seq")
        trace = _frame_trace(msg)
        engine._trace("client_stamp", trace, op=op,
                      nonce=(None if nonce is None else str(nonce)),
                      seq=(None if seq is None else int(seq)),
                      events=len(events))
        cached = engine.session_check(nonce, seq, len(events), trace=trace)
        if cached is not None:
            return {"op": "acks", "n": len(events), "counts": cached,
                    "version": engine.version, "tick": engine.tick_count,
                    "duplicate": True}
        engine.wal_append(nonce, seq, events, trace=trace)
        try:
            counts = engine.offer_many(events, trace=trace)
        except (TypeError, ValueError, IndexError) as e:
            return protocol.error_msg(f"bad events row: {e}")
        engine.session_commit(nonce, seq, counts)
        return {"op": "acks", "n": len(events), "counts": counts,
                "version": engine.version, "tick": engine.tick_count}
    if op == "stats":
        return {"op": "stats", **engine.summary()}
    if op == "configure":
        try:
            applied = engine.configure(
                tick_interval_s=msg.get("tick_interval_s"),
                flush_every=msg.get("flush_every"))
        except (TypeError, ValueError) as e:
            return protocol.error_msg(f"bad configure frame: {e}")
        return {"op": "configured", **applied}
    if op == "pre_drain":
        try:
            spooled, path = engine.pre_drain(msg.get("path"))
        except (TypeError, ValueError, OSError) as e:
            return protocol.error_msg(f"pre_drain failed: {e}")
        return {"op": "pre_drained", "spooled": spooled, "path": path}
    if op == "drain":
        n = engine.drain()
        return {"op": "drained", "tick": engine.tick_count,
                "incorporated": engine.incorporated, "drained": n}
    return protocol.error_msg(f"unknown op {op!r}")


def _safe_handle(engine: ServingEngine, msg: Optional[dict], tracer,
                 registry, handler=_handle) -> dict:
    """``handler`` behind a crash barrier: an unexpected exception
    becomes an ``error`` frame (counted as ``serve_handler_errors`` and
    traced) instead of escaping the single-threaded loop and killing the
    whole server for every connection. ``Preempted``/KeyboardInterrupt
    are BaseException and pass through untouched."""
    try:
        return (handler(engine, msg) if msg is not None
                else protocol.error_msg("malformed frame"))
    except Exception as e:
        op = msg.get("op") if isinstance(msg, dict) else None
        registry.counter("serve_handler_errors").inc()
        tracer.event("serve_handler_error", op=op,
                     error=f"{type(e).__name__}: {e}")
        # Crash barrier == flight-recorder flush point.
        tracer.flush_crash(reason=f"handler:{op!r}:{type(e).__name__}")
        return protocol.error_msg(
            f"internal error handling {op!r}: {type(e).__name__}: {e}")


def run_server(cfg, *, events: Optional[str] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every_ticks: int = 0,
               port_file: Optional[str] = None,
               history_path: Optional[str] = None,
               heartbeat: Optional[str] = None,
               once: bool = False, resume: bool = False,
               verbose: bool = True, handle=None, on_engine=None,
               start_extra: Optional[dict] = None,
               net_fault_plan=None, net_gateway_index: int = 0,
               net_num_gateways: int = 1,
               role: Optional[str] = None, device="cuda") -> dict:
    """Serve until SIGTERM (raises ``Preempted`` after the drain) or,
    with ``once=True``, until the first accepted connection closes
    (clean drain, returns the summary). ``cfg`` is a ServingConfig.

    ``port_file``: the bound port is written here once listening —
    ephemeral-port discovery for loadgen/tests. ``checkpoint_every_ticks``
    adds periodic checkpoints on top of the drain-time one. ``device`` is
    the engine's (the card by default).

    The gateway (``fedtpu_torch.serving.gateway``) reuses this loop
    wholesale: ``handle`` replaces the per-request dispatcher (same
    ``(engine, msg) -> response`` shape as :func:`_handle`), ``on_engine``
    runs once after engine construction but before resume (store attach,
    WAL wiring), and ``start_extra`` merges extra identity fields into the
    ``serve_start`` event. ``role`` names the process in the events sink
    (``serve`` by default; a gateway's ``gateway-<i>``).

    ``net_fault_plan`` (a NetFaultPlan spec: path / inline JSON / dict)
    puts a deterministic wire-fault proxy (``serving.netproxy``) in front
    of this server: the proxy's port file (``<port_file>.net``) is written
    BEFORE the real one, so any client that can discover the server's
    port file atomically routes through the proxy. Requires
    ``port_file``. ``net_gateway_index`` selects which gateway's entries
    of the fleet-wide plan this proxy enforces.

    ``events``: the telemetry sink's path (None: a ``NullTracer``).
    ``heartbeat`` is not ported yet and raises."""
    if heartbeat is not None:
        _not_ported("serve --heartbeat (the supervisor heartbeat)", "A11")
    registry = default_registry()
    registry.reset()
    tracer = make_tracer(events, role=role or "serve")
    log = TelemetryLogger(verbose=verbose, tracer=tracer)
    engine = ServingEngine(cfg, registry=registry, tracer=tracer,
                           device=device)
    if checkpoint_dir:
        engine.spool_dir = checkpoint_dir
    if on_engine is not None:
        on_engine(engine)
    if resume and checkpoint_dir:
        from fedtpu_torch.orchestration.checkpoint import latest_step
        if latest_step(checkpoint_dir) is not None:
            step = engine.restore(checkpoint_dir)
            if verbose:
                log.info(f"resumed serving state at tick {step} "
                         f"(version {engine.version}, "
                         f"{len(engine.pending)} pending)")
        # WAL tail: acked frames the kill beat the checkpoint to. Runs
        # even with no checkpoint yet (a first-checkpoint-window kill).
        replayed = engine.replay_wal()
        if replayed and verbose:
            log.info(f"replayed {replayed} acked update(s) from the "
                     "write-ahead log")

    # SIGTERM -> drain flag, main thread only (signal.signal's rule);
    # elsewhere (tests driving run_server from a worker thread) external
    # stop is simply not intercepted, like the round loop.
    preempt = {"sig": None}
    restore_sig = []
    if threading.current_thread() is threading.main_thread():
        def _on_sig(signum, frame):
            preempt["sig"] = signum
        for s in (signal.SIGTERM, signal.SIGINT):
            restore_sig.append((s, signal.signal(s, _on_sig)))

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((cfg.host, cfg.port))
    lsock.listen(16)
    lsock.setblocking(False)
    port = lsock.getsockname()[1]
    proxy = None
    if net_fault_plan is not None:
        if not port_file:
            raise ValueError("--net-fault-plan requires --port-file (the "
                             "proxy is discovered via <port_file>.net)")
        from fedtpu_torch.serving.netproxy import start_proxy
        # Started BEFORE the real port file exists: a client that can
        # read our port file is guaranteed to also see the proxy's.
        proxy = start_proxy(net_fault_plan, net_gateway_index,
                            net_num_gateways, port, port_file,
                            host=cfg.host)
        if verbose:
            log.info(f"net fault proxy on {cfg.host}:{proxy.port} "
                     f"(gateway {net_gateway_index}, "
                     f"schedule {proxy.plan.digest}, "
                     f"{len(proxy.plan.for_gateway(net_gateway_index))} "
                     "fault(s))")
    if port_file:
        tmp = f"{port_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(str(port))
        os.replace(tmp, port_file)
    if verbose:
        log.info(f"serving on {cfg.host}:{port} (cohort={cfg.cohort}, "
                 f"buffer_size={cfg.buffer_size}, once={once})")
    tracer.event("serve_start", port=port, cohort=cfg.cohort,
                 buffer_size=cfg.buffer_size, resume=bool(resume),
                 **(start_extra or {}))

    sel = selectors.DefaultSelector()
    sel.register(lsock, selectors.EVENT_READ, None)
    ever_connected = False
    last_ckpt_tick = engine.tick_count

    def _shutdown(reason: str) -> dict:
        engine.drain()
        summary = engine.emit_summary()
        if history_path:
            engine.write_history(history_path)
        if checkpoint_dir:
            engine.checkpoint(checkpoint_dir)
        if proxy is not None:
            # Main thread hands the proxy's buffered fault records to
            # the tracer and writes the bitwise-compared decision log
            # (*.netlog).
            proxy.finish(tracer)
        tracer.event("serve_stop", round=engine.tick_count, reason=reason)
        if reason == "preempted":
            tracer.event("preempted", round=engine.tick_count)
            registry.counter("preemptions").inc()
        tracer.counters(registry.snapshot())
        tracer.close()
        return summary

    try:
        while True:
            if preempt["sig"] is not None:
                if verbose:
                    log.warning(f"signal {preempt['sig']}: draining "
                                f"{len(engine.pending)} pending update(s) "
                                "to checkpoint; exiting for resume "
                                "(preempted).")
                _shutdown("preempted")
                raise Preempted(engine.tick_count)
            for key, _ in sel.select(timeout=_POLL_S):
                if key.data is None:
                    try:
                        csock, addr = lsock.accept()
                    except OSError:
                        continue
                    # Timeout mode, not plain blocking: see _CONN_TIMEOUT_S.
                    # recv never waits on it — the selector already said
                    # readable — so only a stalled send can trip it.
                    csock.settimeout(_CONN_TIMEOUT_S)
                    sel.register(csock, selectors.EVENT_READ, _Conn(csock))
                    ever_connected = True
                    tracer.event("serve_accept", peer=str(addr))
                    continue
                conn = key.data
                try:
                    for line in protocol.recv_lines(conn.sock, conn.buf):
                        if line is None:
                            # Oversized line refused at the cap; the
                            # rest of it streams into the void and the
                            # connection lives on.
                            registry.counter("serve_oversized_lines").inc()
                            protocol.send_msg(conn.sock, protocol.error_msg(
                                "line exceeds MAX_LINE_BYTES="
                                f"{protocol.MAX_LINE_BYTES}"))
                            continue
                        msg = protocol.parse_msg(line)
                        resp = _safe_handle(engine, msg, tracer, registry,
                                            handle or _handle)
                        protocol.send_msg(conn.sock, resp)
                except (ConnectionError, OSError):
                    sel.unregister(conn.sock)
                    conn.sock.close()
                    if once and ever_connected:
                        return _shutdown("once")
            if (checkpoint_dir and checkpoint_every_ticks
                    and engine.tick_count - last_ckpt_tick
                    >= checkpoint_every_ticks):
                engine.checkpoint(checkpoint_dir)
                last_ckpt_tick = engine.tick_count
    finally:
        if proxy is not None:
            proxy.stop()
        for s, h in restore_sig:
            signal.signal(s, h)
        sel.close()
        lsock.close()
