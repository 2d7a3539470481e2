"""Deterministic in-path TCP proxy enforcing a NetFaultPlan (the port's
copy of ``fedtpu.serving.netproxy``).

One proxy fronts one gateway. It binds its own localhost port, writes it
to ``protocol.net_proxy_port_file(<gateway port file>)`` (``*.g<i>.net``),
and relays newline-framed JSON between clients and the real server —
except where the plan says otherwise. Every decision is keyed on
DETERMINISTIC COUNTERS (the ordinal of the accepted connection, the
ordinal of the complete frame received from clients, the byte offset
inside a frame), never on wall time, so the same plan against the same
trace tears the same byte on every run.

The proxy is a passive wire: it never parses JSON, never re-frames, and
never invents traffic beyond the one sanctioned pathology (replaying the
last committed frame for ``net_dup_frame``, whose extra ack it swallows
so the client's request/response cadence is untouched). The protocol's
one-response-per-request contract is what lets a byte relay enforce
ack-boundary faults: "after the ack" is simply "after exactly one
response line came back from the server".

Lifecycle: the server (``fedtpu_torch.serving.server.run_server``)
starts the proxy AFTER binding its own socket but BEFORE writing its real
port file, so a client that can see the gateway's port file is guaranteed
to also see the proxy's — no window where chaos traffic sneaks around the
proxy. At drain the server calls ``finish()``: the proxy writes its
decision log (``*.g<i>.netlog``, the bitwise-compared verdict artifact)
and hands its buffered fault records to the tracer from the main
thread.

Stdlib only: loadgen and the tests import it from processes that never
touch the card.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import List, Optional

from fedtpu_torch.resilience.netfaults import NetFault, NetFaultPlan
from fedtpu_torch.serving import protocol

_POLL_S = 0.2
_CONN_TIMEOUT_S = 30.0


def _rst(sock: socket.socket) -> None:
    """Close with a pending RST (SO_LINGER 0) — the abortive close the
    ``net_reset``/``net_torn_frame`` kinds exist to inject."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _close(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.close()
    except OSError:
        pass


class NetFaultProxy:
    """Schedule-driven byte relay between clients and one gateway."""

    def __init__(self, plan: NetFaultPlan, gateway_index: int,
                 backend_port: int, port_file: str,
                 host: str = "127.0.0.1"):
        self.plan = plan
        self.gateway = int(gateway_index)
        self.backend = (host, int(backend_port))
        self.port_file = port_file
        self.host = host
        self.port = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lsock: Optional[socket.socket] = None
        self._finished = False
        # Deterministic ordinals + the firing record (under _lock).
        self.connections = 0
        self.frames = 0               # complete client frames seen
        self.relayed_frames = 0       # frames that reached the server
        self.frame_bytes = 0          # bytes of complete frames (det.)
        self.bytes_in = 0             # raw client->proxy bytes
        self.bytes_out = 0            # raw server->client relayed bytes
        self.records: List[dict] = []

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "NetFaultProxy":
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.host, 0))
        lsock.listen(64)
        lsock.settimeout(_POLL_S)
        self._lsock = lsock
        self.port = lsock.getsockname()[1]
        tmp = f"{self.port_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(str(self.port))
        os.replace(tmp, self.port_file)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"netproxy-g{self.gateway}")
        t.start()
        with self._lock:
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        _close(self._lsock)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    def stats(self) -> dict:
        with self._lock:
            fired: dict = {}
            for rec in self.records:
                fired[rec["fault"]] = fired.get(rec["fault"], 0) + 1
            return {"gateway": self.gateway, "digest": self.plan.digest,
                    "connections": self.connections, "frames": self.frames,
                    "relayed_frames": self.relayed_frames,
                    "frame_bytes": self.frame_bytes,
                    "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                    "fired": fired}

    def finish(self, tracer=None) -> dict:
        """Stop relaying, write the decision log, emit tracer events.

        The decision log (``<port_file>log`` — ``*.g<i>.netlog``) is the
        byte-identical-across-runs artifact: schedule header, one line
        per fired fault in firing order, then a summary restricted to
        deterministic counters (complete-frame bytes, never raw relay
        bytes, whose float formatting in server responses may vary).
        """
        self.stop()
        stats = self.stats()
        if self._finished:
            return stats
        self._finished = True
        with self._lock:
            records = list(self.records)
        lines = [json.dumps(
            {"gateway": self.gateway, "seed": self.plan.seed,
             "digest": self.plan.digest},
            sort_keys=True, separators=(",", ":"))]
        lines += [json.dumps(rec, sort_keys=True, separators=(",", ":"))
                  for rec in records]
        lines.append(json.dumps(
            {"summary": {"connections": stats["connections"],
                         "frames": stats["frames"],
                         "relayed_frames": stats["relayed_frames"],
                         "frame_bytes": stats["frame_bytes"],
                         "fired": stats["fired"]}},
            sort_keys=True, separators=(",", ":")))
        log_path = f"{self.port_file}log"
        tmp = f"{log_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            for line in lines:
                fh.write(line + "\n")
        os.replace(tmp, log_path)
        if tracer is not None:
            for rec in records:
                tracer.event("net_fault", **rec)
            tracer.event("netproxy_summary", **stats)
        return stats

    # --------------------------------------------------------- wire loops

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                csock, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self.connections += 1
                conn = self.connections
            fault = self.plan.at_accept(self.gateway, conn)
            if fault is not None:
                self._record(fault, conn=conn, frame=0, nbytes=0)
                _rst(csock)
                continue
            t = threading.Thread(target=self._serve, args=(csock, conn),
                                 daemon=True,
                                 name=f"netproxy-g{self.gateway}-c{conn}")
            t.start()
            with self._lock:
                self._threads.append(t)

    def _serve(self, csock: socket.socket, conn: int) -> None:
        csock.settimeout(_CONN_TIMEOUT_S)
        bsock: Optional[socket.socket] = None
        bbuf = bytearray()
        buf = bytearray()
        try:
            while not self._stop.is_set():
                try:
                    chunk = csock.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                with self._lock:
                    self.bytes_in += len(chunk)
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = bytes(buf[:nl + 1])     # frame incl. newline
                    del buf[:nl + 1]
                    if len(line) == 1:             # bare newline keepalive
                        continue
                    try:
                        bsock, done = self._handle_frame(csock, bsock, bbuf,
                                                         conn, line)
                    except OSError:
                        return
                    if done:
                        return
        finally:
            _close(bsock)
            _close(csock)

    def _handle_frame(self, csock, bsock, bbuf, conn: int, line: bytes):
        """Apply the schedule to one complete client frame. Returns
        ``(backend_sock, done)`` — ``done`` means the connection was
        consumed by a fault and the serve loop must exit."""
        with self._lock:
            self.frames += 1
            self.frame_bytes += len(line)
            frame = self.frames
        fault = self.plan.at_frame(self.gateway, frame)
        if fault is None:
            bsock = self._relay(csock, bsock, bbuf, line)
            return bsock, False
        self._record(fault, conn=conn, frame=frame, nbytes=len(line))
        kind = fault.kind
        if kind == "net_partition":
            # Blackhole: the frame never reaches the server, the carrier
            # dies. Nothing was acked, so nothing can be lost.
            _close(csock)
            return bsock, True
        if kind == "net_reset":
            _rst(csock)
            return bsock, True
        if kind == "net_slow_link":
            bsock = self._relay(csock, bsock, bbuf, line,
                                chunk=fault.chunk_bytes,
                                delay_s=fault.delay_s)
            return bsock, False
        if kind == "net_torn_frame" and fault.boundary == "pre_ack":
            # Cut BEFORE the WAL-append/ack boundary: the server sees a
            # torn line and drops the connection having processed
            # nothing; the client's retry is a first delivery.
            bsock = self._backend(bsock)
            if bsock is not None:
                try:
                    bsock.sendall(line[:fault.cut_bytes])
                except OSError:
                    pass
                _rst(bsock)
            _close(csock)
            return None, True
        if kind == "net_torn_frame":
            # post_ack: the server WAL-appends, processes, and acks —
            # then the ack dies on the wire. The retry must dedup.
            bsock = self._backend(bsock)
            if bsock is not None:
                try:
                    bsock.sendall(line)
                    self._read_response(bsock, bbuf)   # ack, swallowed
                except OSError:
                    pass
                _close(bsock)
            _rst(csock)
            return None, True
        if kind == "net_dup_frame":
            # Replay the last committed frame: relay + ack as normal,
            # then re-send the identical bytes and swallow the server's
            # duplicate verdict. The client never notices; the server's
            # duplicate-drop counter must.
            bsock = self._relay(csock, bsock, bbuf, line)
            if bsock is not None:
                try:
                    bsock.sendall(line)
                    self._read_response(bsock, bbuf)   # dup ack, swallowed
                except OSError:
                    pass
            return bsock, False
        bsock = self._relay(csock, bsock, bbuf, line)
        return bsock, False

    def _relay(self, csock, bsock, bbuf, line: bytes,
               chunk: int = 0, delay_s: float = 0.0):
        """Forward one frame to the server (optionally paced) and its one
        response line back to the client."""
        bsock = self._backend(bsock)
        if bsock is None:
            _close(csock)
            raise OSError("backend unreachable")
        try:
            if chunk > 0:
                for off in range(0, len(line), chunk):
                    bsock.sendall(line[off:off + chunk])
                    if delay_s > 0 and off + chunk < len(line):
                        time.sleep(delay_s)
            else:
                bsock.sendall(line)
            resp = self._read_response(bsock, bbuf)
            csock.sendall(resp)
        except OSError:
            _close(bsock)
            _close(csock)
            raise
        with self._lock:
            self.relayed_frames += 1
            self.bytes_out += len(resp)
        return bsock

    def _backend(self, bsock):
        if bsock is not None:
            return bsock
        try:
            return socket.create_connection(self.backend,
                                            timeout=_CONN_TIMEOUT_S)
        except OSError:
            return None

    @staticmethod
    def _read_response(bsock, bbuf: bytearray) -> bytes:
        """One complete response line from the server (the protocol is
        strict request/response, so exactly one line answers a frame)."""
        while True:
            nl = bbuf.find(b"\n")
            if nl >= 0:
                resp = bytes(bbuf[:nl + 1])
                del bbuf[:nl + 1]
                return resp
            chunk = bsock.recv(1 << 16)
            if not chunk:
                raise OSError("backend closed mid-response")
            bbuf += chunk

    def _record(self, fault: NetFault, conn: int, frame: int,
                nbytes: int) -> None:
        rec = fault.payload()
        rec["at_conn"] = conn
        rec["at_frame"] = frame
        rec["frame_len"] = nbytes
        with self._lock:
            self.records.append(rec)


def start_proxy(plan_spec, gateway_index: int, num_gateways: int,
                backend_port: int, port_file: str,
                host: str = "127.0.0.1") -> NetFaultProxy:
    """Load a plan spec (path / inline JSON / dict) and start the proxy
    for one gateway. The plan is fleet-wide; the proxy enforces only its
    own gateway's entries."""
    plan = NetFaultPlan.load(plan_spec, num_gateways=max(1, int(num_gateways)))
    proxy = NetFaultProxy(plan, gateway_index, backend_port,
                          protocol.net_proxy_port_file(port_file), host=host)
    return proxy.start()


__all__ = ["NetFaultProxy", "start_proxy"]
