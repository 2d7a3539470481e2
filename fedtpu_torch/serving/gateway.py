"""``gateway`` — the fault-tolerant multi-host ingestion tier (the port's
copy of ``fedtpu.serving.gateway``).

N gateway processes front the newline-JSON serving protocol, each
owning the id-shard of clients matching its store shard (``user % N ==
index``) and reusing :func:`fedtpu_torch.serving.server.run_server`'s
single-threaded loop wholesale — the gateway is a routing + failover
skin over the same engine, not a second server. Each member's tick is
the engine's captured driven tick on the card. A member's death is
repaired by a relaunch with ``--resume`` (``supervise`` for one member;
``fedtpu``'s ``supervise --gang``, for the whole gang, is ROADMAP A10): the
engine's write-ahead log + idempotent sessions make the restart lossless
for every *acked* update.

Routing: a frame for a user another gateway owns is refused whole (for
batch frames: nothing in the batch is processed, the session seq is not
committed) with an ``error`` frame carrying a ``redirect`` object
naming the owner, which the retrying :class:`GatewayClient` follows.
Clients pre-partition by owner, so redirects are the stale-topology
exception, not the steady state.

Failover: two gateway-only ops wire the store-shard handoff —

    {"op": "flush"[, "path": spool]}
        -> {"op": "flushed", "tick", "slots", "spooled", "spool",
            "checkpoint", "generation"}
        writeback every bound slot into the store, spool the pending
        queue, checkpoint (store rows ride the same checkpoint,
        digest-stamped and generation-fenced) — the export a survivor
        adopts.
    {"op": "adopt", "shard": s, "checkpoint_dir": d[, "spool": p,
     "generation": g]}
        -> {"op": "adopted", "shard", "rows", "replayed", "owned"}
        absorb the dead shard's exported rows (digest-verified,
        generation-fenced against ``g``), take over its id range, and
        replay its spooled pending updates.

Health: :func:`probe_fleet` (``fedtpu check --gateway-probe``'s; the
port's ``check`` is ROADMAP A11b, second part) hellos every member and
reports per-gateway liveness.

torch is only touched through the engine; importable backend-free.
"""

from __future__ import annotations

import json
import os
import signal
import uuid
from typing import Dict, Optional, Set

from fedtpu_torch.serving import protocol
from fedtpu_torch.serving.server import _handle, run_server

# Self-kill fault injection, the fleet's lost-ack drill:
# "<index>:<frames>" SIGKILLs gateway <index> after acking <frames>
# update/updates frames — after processing, BEFORE the ack is sent, so
# the client sees a lost ack and must retry through the dedup path.
# Honored only on the first life (FEDTPU_RESTARTS == 0).
ENV_KILL_AFTER = "FEDTPU_GATEWAY_KILL_AFTER"


def owner_of(user: int, num_gateways: int) -> int:
    """The gateway owning ``user`` — the store's modular contract,
    shared verbatim with ClientStateStore and GatewayClient."""
    return int(user) % max(1, int(num_gateways))


def redirect_msg(user: int, owner: int, num_gateways: int,
                 port_file_base: Optional[str]) -> dict:
    """The routing refusal: an error frame whose ``redirect`` object
    names the owning gateway (and how to find it)."""
    msg = protocol.error_msg(
        f"user {int(user)} belongs to gateway {int(owner)}")
    msg["redirect"] = {"gateway": int(owner),
                       "num_gateways": int(num_gateways)}
    if port_file_base:
        msg["redirect"]["port_file"] = protocol.gateway_port_file(
            port_file_base, owner)
    return msg


class _Gateway:
    """Per-process fleet identity threaded through the handler."""

    def __init__(self, index: int, num_gateways: int,
                 port_file_base: Optional[str], generation: str,
                 checkpoint_dir: Optional[str]):
        self.index = int(index)
        self.num_gateways = int(num_gateways)
        self.port_file_base = port_file_base
        self.generation = generation
        self.checkpoint_dir = checkpoint_dir
        # Shards this process answers for: its own, plus any it adopted
        # from a dead peer. The store's owns() mask moves in lockstep.
        self.owned: Set[int] = {self.index}
        self.redirects = 0

    def owns_user(self, user: int) -> bool:
        return owner_of(user, self.num_gateways) in self.owned


def _gateway_handle(gw: _Gateway, engine, msg: dict) -> dict:
    """The gateway's request dispatcher: ownership routing + the two
    failover ops, everything else delegated to the base server
    :func:`_handle` (which already runs the idempotent-session and WAL
    paths)."""
    op = msg.get("op")
    if op == "hello":
        resp = _handle(engine, msg)
        if resp.get("op") == "welcome":
            resp.update(gateway=gw.index, num_gateways=gw.num_gateways,
                        owned=sorted(gw.owned),
                        generation=gw.generation)
        return resp
    if op == "update":
        try:
            user = int(msg["user"])
        except (KeyError, TypeError, ValueError) as e:
            return protocol.error_msg(f"bad update frame: {e}")
        if not gw.owns_user(user):
            gw.redirects += 1
            engine.registry.counter("gateway_redirects").inc()
            return redirect_msg(user, owner_of(user, gw.num_gateways),
                                gw.num_gateways, gw.port_file_base)
        return _handle(engine, msg)
    if op == "updates":
        events = msg.get("events")
        if isinstance(events, list):
            foreign: Dict[int, int] = {}
            for row in events:
                try:
                    user = int(row[0])
                except (TypeError, ValueError, IndexError):
                    continue  # the base handler owns malformed-row errors
                if not gw.owns_user(user):
                    o = owner_of(user, gw.num_gateways)
                    foreign[o] = foreign.get(o, 0) + 1
            if foreign:
                # Redirect-atomic: ANY foreign event refuses the WHOLE
                # batch — nothing processed, seq not committed — so the
                # client can re-partition and resend without a partial
                # incorporation to reason about.
                gw.redirects += 1
                engine.registry.counter("gateway_redirects").inc()
                first = min(foreign)
                resp = redirect_msg(-1, first, gw.num_gateways,
                                    gw.port_file_base)
                resp["reason"] = (f"batch holds {sum(foreign.values())} "
                                  f"event(s) owned by other gateways")
                resp["redirect"]["owners"] = {
                    str(o): n for o, n in sorted(foreign.items())}
                return resp
        return _handle(engine, msg)
    if op == "flush":
        if not gw.checkpoint_dir:
            return protocol.error_msg("flush needs a checkpoint dir")
        try:
            slots = engine.writeback_slots()
            spooled, spool = engine.pre_drain(msg.get("path"))
            ckpt = engine.checkpoint(gw.checkpoint_dir)
        except (ValueError, OSError) as e:
            return protocol.error_msg(f"flush failed: {e}")
        engine.tracer.event("gateway_flush", round=engine.tick_count,
                            slots=slots, spooled=spooled,
                            generation=gw.generation)
        return {"op": "flushed", "tick": engine.tick_count,
                "slots": slots, "spooled": spooled, "spool": spool,
                "checkpoint": ckpt, "generation": gw.generation}
    if op == "adopt":
        if engine.store is None:
            return protocol.error_msg("adopt needs an attached store "
                                      "(run the gateway with --total-users)")
        try:
            shard = int(msg["shard"])
            ckpt_dir = msg["checkpoint_dir"]
        except (KeyError, TypeError, ValueError) as e:
            return protocol.error_msg(f"bad adopt frame: {e}")
        try:
            from fedtpu_torch.orchestration.checkpoint import load_meta
            meta = load_meta(ckpt_dir)
            rows = engine.store.absorb_shard(
                meta, expected_generation=msg.get("generation"))
        except (FileNotFoundError, ValueError, OSError) as e:
            return protocol.error_msg(f"adopt refused: {e}")
        gw.owned.add(shard)
        # Replay the dead peer's spooled pending queue: admitted-but-
        # uninitiated work survives the shard death as fresh offers on
        # the survivor's virtual clock.
        replayed = 0
        spool = msg.get("spool")
        if spool and os.path.exists(spool):
            with open(spool, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    entry = json.loads(line)
                    engine.offer(float(entry["t"]), int(entry["user"]),
                                 0.0,
                                 poison=float(entry.get("poison", 0.0)))
                    replayed += 1
        engine.registry.counter("gateway_adoptions").inc()
        engine.tracer.event("gateway_adopt", round=engine.tick_count,
                            shard=shard, rows=rows, replayed=replayed,
                            owned=sorted(gw.owned))
        return {"op": "adopted", "shard": shard, "rows": rows,
                "replayed": replayed, "owned": sorted(gw.owned)}
    return _handle(engine, msg)


def run_gateway(cfg, *, gateway_index: Optional[int] = None,
                num_gateways: int = 1,
                port_file: Optional[str] = None,
                events: Optional[str] = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every_ticks: int = 0,
                history_path: Optional[str] = None,
                heartbeat: Optional[str] = None,
                total_users: int = 0, store_backend: str = "memory",
                store_path: Optional[str] = None,
                once: bool = False, resume: bool = False,
                verbose: bool = True, net_fault_plan=None,
                device="cuda") -> dict:
    """Run ONE member of an N-gateway fleet (launch N of these).
    ``gateway_index`` defaults to the
    gang's FEDTPU_PROCESS_ID; all shared paths (``port_file``,
    ``events``, ``history_path``, ``store_path``, ``heartbeat``,
    ``checkpoint_dir``) are BASE paths every member derives its own
    file/subdir from, so the whole fleet shares one command line.

    ``net_fault_plan`` (fleet-wide NetFaultPlan spec; same value on
    every member's command line) fronts this member with a wire-fault
    proxy on ``<port_file>.g<i>.net`` enforcing only the plan entries
    whose ``gateway`` matches ``i`` — see ``serving.netproxy``.
    ``device`` is the engine's (the card by default); ``heartbeat`` is
    this member's ``heartbeat_path_for(heartbeat, i)``, rewritten at every
    loop wakeup (``run_server``)."""
    from fedtpu_torch.resilience.distributed import (ENV_LAUNCH_ID,
                                                     ENV_PROCESS_ID,
                                                     heartbeat_path_for)

    i = (int(gateway_index) if gateway_index is not None
         else int(os.environ.get(ENV_PROCESS_ID, "0")))
    n = max(1, int(num_gateways))
    if not 0 <= i < n:
        raise ValueError(f"gateway index {i} outside fleet of {n}")
    # The failover generation: identical across a gang launch, fresh per
    # relaunch — a flush ack advertises it, adopt fences on it, so a
    # survivor can never absorb a previous life's stale export.
    generation = os.environ.get(ENV_LAUNCH_ID) or uuid.uuid4().hex[:12]

    def _per(base: Optional[str]) -> Optional[str]:
        if base is None or n == 1:
            return base
        return f"{base}.g{i}"

    ckpt_i = (os.path.join(checkpoint_dir, f"g{i}")
              if checkpoint_dir else None)
    gw = _Gateway(i, n, port_file if n > 1 else None, generation, ckpt_i)

    kill_state = {"after": 0, "acked": 0}
    spec = os.environ.get(ENV_KILL_AFTER, "")
    if spec and int(os.environ.get("FEDTPU_RESTARTS", "0")) == 0:
        idx, _, frames = spec.partition(":")
        if int(idx) == i:
            kill_state["after"] = max(1, int(frames))

    def _on_engine(engine) -> None:
        if ckpt_i:
            # Ack durability: every session-stamped frame hits this WAL
            # before processing; checkpoint truncates it; resume replays
            # the tail. SIGKILL between ack-compute and ack-send loses
            # nothing.
            engine.wal_path = os.path.join(ckpt_i, "wal.jsonl")
        if total_users:
            store = engine.attach_store(
                int(total_users), backend=store_backend,
                path=_per(store_path), shard_index=i, num_shards=n)
            store.generation = generation

    def _handle_frame(engine, msg: dict) -> dict:
        resp = _gateway_handle(gw, engine, msg)
        if (kill_state["after"]
                and msg.get("op") in ("update", "updates")
                and resp.get("op") in ("ack", "acks")):
            kill_state["acked"] += 1
            if kill_state["acked"] >= kill_state["after"]:
                # The drill's lost-ack window: the frame is fully
                # processed (WAL'd, offered, session-committed) but the
                # client never hears back.
                os.kill(os.getpid(), signal.SIGKILL)
        return resp

    return run_server(
        cfg, events=_per(events), checkpoint_dir=ckpt_i,
        checkpoint_every_ticks=checkpoint_every_ticks,
        port_file=(protocol.gateway_port_file(port_file, i)
                   if port_file and n > 1 else port_file),
        history_path=_per(history_path),
        heartbeat=(heartbeat_path_for(heartbeat, i)
                   if heartbeat else None),
        once=once, resume=resume, verbose=verbose,
        handle=_handle_frame, on_engine=_on_engine,
        start_extra={"gateway": i, "num_gateways": n,
                     "generation": generation},
        net_fault_plan=net_fault_plan, net_gateway_index=i,
        net_num_gateways=n, role=f"gateway-{i}", device=device)


def probe_fleet(port_file: str, num_gateways: int,
                host: str = "127.0.0.1",
                timeout: float = 5.0) -> list:
    """Health-probe every fleet member (``fedtpu check
    --gateway-probe``'s probe): hello each gateway's advertised port and
    report liveness + identity per member. Never raises — a dead member
    is a row with ``ok: False``."""
    from fedtpu_torch.serving.loadgen import read_port_file

    n = max(1, int(num_gateways))
    out = []
    for g in range(n):
        path = (protocol.gateway_port_file(port_file, g) if n > 1
                else port_file)
        row = {"gateway": g, "ok": False, "port_file": path}
        try:
            port = read_port_file(path, timeout=timeout)
            with protocol.Connection(host, port,
                                     timeout=timeout) as conn:
                welcome = conn.hello()
                stats = conn.request({"op": "stats"})
            row.update(ok=True, port=port,
                       version=welcome.get("version"),
                       gateway_reported=welcome.get("gateway"),
                       backlog=(stats.get("signals") or {}).get(
                           "backlog"))
        except (TimeoutError, ConnectionError, OSError, ValueError) as e:
            row["error"] = f"{type(e).__name__}: {e}"
        out.append(row)
    return out
