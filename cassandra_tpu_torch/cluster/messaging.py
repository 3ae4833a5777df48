"""Internode messaging: verb-dispatched request/response with timeouts and
test-controllable fault injection.

Reference counterpart: net/MessagingService.java:208 (send/sendWithCallback),
net/Verb.java:127 (verb registry with handlers + timeouts), and the in-JVM
dtest MessageFilters (test/distributed/impl/AbstractCluster.java:796) that
drop/intercept messages between in-process nodes.

Transport is pluggable: LocalTransport routes in-process (the jvm-dtest
model — our multi-node tests run N nodes in one process); a socket
transport slots in behind the same send() seam for real deployments.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from dataclasses import dataclass, field

from ..service import tracing
from ..service.metrics import GLOBAL as METRICS
from ..utils import pipeline_ledger
from .ring import Endpoint


def auto_dispatch_workers() -> int:
    """0 = auto resolution for internode_dispatch_threads: replica-side
    verb handlers are GIL-bound python plus engine calls that release it
    (storage reads, commitlog appends with fsync), so a small multiple
    of cores pays for itself by keeping acks flowing while one handler
    blocks on fsync — but every in-process node spawns its own pool, so
    the cap stays low (the 3-node dtest cluster runs 3 pools on one
    box)."""
    return max(1, min(os.cpu_count() or 2, 4))


# metric-name cache for the per-verb received counters (one entry per
# verb string, built lazily)
_VERB_RECEIVED: dict = {}

# replica-shipped trace events per response are CAPPED: a chatty
# handler (or a pathological loop inside one) must not bloat every RSP
# payload on the wire. The chronological HEAD is kept — the re-base
# math on the coordinator (tracing.merge_remote) anchors on the last
# shipped offset, so a truncated tail just shortens the merged
# timeline. Drops count under `verb.<rsp-verb>.trace_dropped`.
TRACE_EVENTS_CAP = 64
_VERB_TRACE_DROPPED: dict = {}


class Verb:
    MUTATION_REQ = "MUTATION_REQ"
    MUTATION_RSP = "MUTATION_RSP"
    COUNTER_REQ = "COUNTER_REQ"
    COUNTER_RSP = "COUNTER_RSP"
    READ_REQ = "READ_REQ"
    READ_RSP = "READ_RSP"
    RANGE_REQ = "RANGE_REQ"
    RANGE_RSP = "RANGE_RSP"
    HINT_REQ = "HINT_REQ"
    ECHO_REQ = "ECHO_REQ"
    ECHO_RSP = "ECHO_RSP"
    GOSSIP_SYN = "GOSSIP_SYN"
    GOSSIP_ACK = "GOSSIP_ACK"
    SCHEMA_PUSH = "SCHEMA_PUSH"
    SCHEMA_PULL = "SCHEMA_PULL"
    SCHEMA_FORWARD = "SCHEMA_FORWARD"
    STREAM_REQ = "STREAM_REQ"
    STREAM_DATA = "STREAM_DATA"
    # sessioned streaming (cluster/stream_session.py): manifest-planned
    # chunked transfer with acks, retransmit and resume
    STREAM_SESSION_REQ = "STREAM_SESSION_REQ"
    STREAM_MANIFEST = "STREAM_MANIFEST"
    STREAM_CHUNK = "STREAM_CHUNK"
    STREAM_ACK = "STREAM_ACK"
    STREAM_SESSION_DONE = "STREAM_SESSION_DONE"
    STREAM_PULL_REQ = "STREAM_PULL_REQ"
    STREAM_PULL_RSP = "STREAM_PULL_RSP"
    REPAIR_VALIDATION_REQ = "REPAIR_VALIDATION_REQ"
    REPAIR_VALIDATION_RSP = "REPAIR_VALIDATION_RSP"
    REPAIR_SYNC_REQ = "REPAIR_SYNC_REQ"
    REPAIR_ANTICOMPACT_REQ = "REPAIR_ANTICOMPACT_REQ"
    REPAIR_ANTICOMPACT_RSP = "REPAIR_ANTICOMPACT_RSP"
    BOOTSTRAP_PULL_REQ = "BOOTSTRAP_PULL_REQ"
    FAILURE_RSP = "FAILURE_RSP"
    TRUNCATE_REQ = "TRUNCATE_REQ"
    TRUNCATE_RSP = "TRUNCATE_RSP"
    INDEX_REQ = "INDEX_REQ"
    INDEX_RSP = "INDEX_RSP"
    # cluster-wide telemetry pull (the observatory): any node asks a
    # peer for its engine-scoped metric/tpstats/SLO snapshot
    METRICS_SNAPSHOT_REQ = "METRICS_SNAPSHOT_REQ"
    METRICS_SNAPSHOT_RSP = "METRICS_SNAPSHOT_RSP"


@dataclass
class Message:
    verb: str
    payload: object
    sender: Endpoint
    to: Endpoint
    id: int = 0
    reply_to: int = 0
    # distributed tracing headers (tracing/Tracing.java message params):
    # requests carry the coordinator's session id; responses echo it back
    # along with the replica-side (elapsed_us, source, activity) events
    trace_session: str | None = None
    trace_events: list | None = None


class MessageFilters:
    """Test hook: drop or intercept messages (jvm-dtest MessageFilters)."""

    def __init__(self):
        self._drop_rules: list = []
        self._intercepts: list = []
        self._lock = threading.Lock()

    def drop(self, verb: str | None = None, frm: Endpoint | None = None,
             to: Endpoint | None = None, count: int | None = None):
        rule = {"verb": verb, "from": frm, "to": to,
                "remaining": count if count is not None else float("inf")}
        with self._lock:
            self._drop_rules.append(rule)
        return rule

    def clear(self):
        with self._lock:
            self._drop_rules.clear()
            self._intercepts.clear()

    def intercept(self, fn):
        with self._lock:
            self._intercepts.append(fn)

    def should_drop(self, msg: Message) -> bool:
        with self._lock:
            for fn in self._intercepts:
                fn(msg)
            for r in self._drop_rules:
                if ((r["verb"] is None or r["verb"] == msg.verb)
                        and (r["from"] is None or r["from"] == msg.sender)
                        and (r["to"] is None or r["to"] == msg.to)
                        and r["remaining"] > 0):
                    r["remaining"] -= 1
                    return True
        return False


class LocalTransport:
    """In-process message routing between registered nodes; each node gets
    a delivery thread (the reference's per-connection Netty event loop)."""

    def __init__(self):
        self.filters = MessageFilters()
        self._nodes: dict[Endpoint, "MessagingService"] = {}
        self._lock = threading.Lock()

    def register(self, ep: Endpoint, svc: "MessagingService") -> None:
        with self._lock:
            self._nodes[ep] = svc

    def unregister(self, ep: Endpoint) -> None:
        with self._lock:
            self._nodes.pop(ep, None)

    def deliver(self, msg: Message) -> None:
        if self.filters.should_drop(msg):
            return
        with self._lock:
            target = self._nodes.get(msg.to)
        if target is not None and not target.closed:
            target.inbound(msg)


class MessagingService:
    """Per-node messaging endpoint: verb handlers + response callbacks with
    timeouts (net/RequestCallbacks)."""

    # how long a surplus/shut-down dispatch worker can linger blocked on
    # an empty queue before noticing it should exit (CompressorPool's
    # POLL_SECONDS role)
    POLL_SECONDS = 0.2

    def __init__(self, ep: Endpoint, transport: LocalTransport,
                 dispatch_workers: int = 0):
        self.ep = ep
        self.transport = transport
        self.handlers: dict[str, callable] = {}
        self._callbacks: dict[int, tuple] = {}
        self._ids = itertools.count(1)
        self._cb_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self.closed = False
        self.metrics = {"sent": 0, "received": 0, "dropped_timeout": 0,
                        "process_failures": 0, "dispatch_worker_deaths": 0}
        # verb-dispatch pool (the reference's per-Verb handler stages,
        # net/: inbound requests execute on Stage executors, not the
        # deserialization thread): the distributor thread routes
        # response callbacks inline — per-callback-id ordering is the
        # single-thread total order — and hands verb-handler messages
        # to `_pool_target` workers over `_dispatch_q`, so replica-side
        # verbs scale with cores instead of serializing behind one
        # fsync-bound handler. 0 = auto; hot-resized by the
        # internode_dispatch_threads knob via set_dispatch_workers().
        self._dispatch_q: queue.Queue = queue.Queue()
        self._pool_lock = threading.Lock()
        self._pool: list[threading.Thread] = []
        self._pool_target = int(dispatch_workers) if dispatch_workers > 0 \
            else auto_dispatch_workers()
        # ledger stage (utils/pipeline_ledger.py): busy = handler
        # execution, idle = workers parked on an empty dispatch queue,
        # queue_hwm = verb backlog high-water behind the distributor
        self._stage = pipeline_ledger.ledger("messaging").stage("dispatch")
        self._verb_stages: dict[str, object] = {}
        # deterministic-simulation mode: a SimTransport (sim/scheduler.py)
        # carries a scheduler; deliveries and callback timeouts become
        # virtual-time events processed inline on the pumping thread, so
        # NO worker/reaper/pool threads exist and every interleaving
        # replays from the scheduler's seed
        self._sim = getattr(transport, "scheduler", None)
        transport.register(ep, self)
        if self._sim is None:
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name=f"msg-{ep.name}")
            self._worker.start()
            self._reaper = threading.Thread(target=self._reap, daemon=True)
            self._reaper.start()

    # ------------------------------------------------------ dispatch pool

    @property
    def dispatch_workers(self) -> int:
        return self._pool_target

    def set_dispatch_workers(self, n: int) -> None:
        """Hot-resize (internode_dispatch_threads; 0 = auto). Growing
        spawns immediately when the pool is live; shrinking retires
        surplus workers after their current message."""
        n = int(n)
        n = n if n > 0 else auto_dispatch_workers()
        with self._pool_lock:
            self._pool_target = n
            if self._pool and not self.closed:
                self._spawn_locked()

    def _spawn_locked(self) -> None:
        while len(self._pool) < self._pool_target:
            w = threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name=f"msg-dispatch-{self.ep.name}")
            self._pool.append(w)
            w.start()

    def pool_width(self) -> int:
        """Live worker count (test/telemetry surface — the worker-death
        blast-radius pin asserts this never shrinks silently)."""
        with self._pool_lock:
            return len(self._pool)

    # ------------------------------------------------------------- sending

    def register_handler(self, verb: str, fn) -> None:
        """fn(message) -> response payload | None (one-way)."""
        self.handlers[verb] = fn

    def send_one_way(self, verb: str, payload, to: Endpoint) -> None:
        msg = Message(verb, payload, self.ep, to, next(self._ids))
        st = tracing.active()
        if st is not None:
            msg.trace_session = st.session_id
            st.add(f"Sending {verb} to {to.name}")
        self.metrics["sent"] += 1
        self.transport.deliver(msg)

    def send_with_callback(self, verb: str, payload, to: Endpoint,
                           on_response, on_failure=None,
                           timeout: float = 5.0) -> int:
        msg = Message(verb, payload, self.ep, to, next(self._ids))
        st = tracing.active()
        if st is not None:
            # tracing header: the session id rides the message; the
            # failure wrapper records by id because expirations fire on
            # the reaper thread, outside this contextvar
            msg.trace_session = st.session_id
            st.add(f"Sending {verb} to {to.name}")
            sid, orig_fail = st.session_id, on_failure

            def on_failure(arg, _of=orig_fail, _sid=sid, _to=to, _v=verb):
                tracing.record(
                    _sid, f"Failure/timeout waiting for {_v} "
                          f"response from {_to.name}",
                    source=self.ep.name)
                if _of is not None:
                    _of(arg)
        with self._cb_lock:
            self._callbacks[msg.id] = (on_response, on_failure,
                                       time.monotonic() + timeout)
        self.metrics["sent"] += 1
        if self._sim is not None:
            self._sim.after(timeout, lambda: self._expire_one(msg.id),
                            f"timeout {self.ep.name}#{msg.id}")
        self.transport.deliver(msg)
        return msg.id

    def respond(self, original: Message, verb: str, payload,
                trace_events: list | None = None) -> None:
        if trace_events is not None \
                and len(trace_events) > TRACE_EVENTS_CAP:
            dropped = len(trace_events) - TRACE_EVENTS_CAP
            trace_events = trace_events[:TRACE_EVENTS_CAP]
            name = _VERB_TRACE_DROPPED.get(verb)
            if name is None:
                name = _VERB_TRACE_DROPPED[verb] = \
                    f"verb.{verb}.trace_dropped"
            METRICS.incr(name, dropped)
        msg = Message(verb, payload, self.ep, original.sender,
                      next(self._ids), reply_to=original.id,
                      trace_session=original.trace_session,
                      trace_events=trace_events)
        self.transport.deliver(msg)

    def respond_failure(self, original: Message, exc: Exception,
                        trace_events: list | None = None) -> None:
        """The one definition of the FAILURE_RSP wire shape; classify
        remote errors with failure_kind(), never by parsing repr text."""
        self.respond(original, Verb.FAILURE_RSP,
                     {"kind": type(exc).__name__, "error": repr(exc)},
                     trace_events=trace_events)

    @staticmethod
    def failure_kind(payload) -> str | None:
        """Exception class name from a FAILURE_RSP payload (None for
        reap-timeout bare ids or legacy shapes)."""
        return payload.get("kind") if isinstance(payload, dict) else None

    # ------------------------------------------------------------ receiving

    def inbound(self, msg: Message) -> None:
        self._queue.put(msg)

    def _run(self) -> None:
        """Distributor: pulls the inbound queue, routes response
        callbacks INLINE (this thread is the per-callback-id total
        order — acks for one request can never reorder), and hands
        verb-handler messages to the dispatch pool."""
        while not self.closed:
            try:
                msg = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._account(msg)
                if msg.reply_to:
                    self._process_response(msg)
                else:
                    self._dispatch_q.put(msg)
                    self._stage.note_queue(self._dispatch_q.qsize())
                    with self._pool_lock:
                        self._spawn_locked()
            except Exception:
                # a raising response callback must cost that MESSAGE,
                # never this node's single distributor thread — a dead
                # distributor leaves the node deaf with no trace (the
                # silent-daemon-death class, ctpulint worker-loops)
                self.metrics["process_failures"] += 1

    def _dispatch_loop(self) -> None:
        """Pool worker: verb handlers only. A raising handler costs
        that MESSAGE (process_failures) and nothing else; a handler
        that escalates past Exception kills this thread, but the death
        is counted and the worker replaced (_respawn) — the pool never
        shrinks silently."""
        me = threading.current_thread()
        try:
            while True:
                with self._pool_lock:
                    if self.closed or len(self._pool) > self._pool_target:
                        if me in self._pool:
                            self._pool.remove(me)
                        return
                t_idle = time.monotonic()
                try:
                    msg = self._dispatch_q.get(timeout=self.POLL_SECONDS)
                except queue.Empty:
                    continue
                t0 = time.monotonic()
                self._stage.add_idle(t0 - t_idle)
                done = False
                try:
                    self._process_handler(msg)
                    done = True
                except Exception:
                    self.metrics["process_failures"] += 1
                    done = True
                finally:
                    # BaseException escaping a handler (the kill seam):
                    # still cost the message before the thread dies
                    if not done:
                        self.metrics["process_failures"] += 1
                    self._stage.add_busy(time.monotonic() - t0)
                    self._stage.add_items(1)
        finally:
            self._respawn(me)

    def _respawn(self, me: threading.Thread) -> None:
        """Replace a worker that died mid-message. Normal retirement
        (shutdown / surplus under a shrink) already removed `me` from
        the pool; a thread still listed here died abnormally, and the
        pool width must not degrade behind the operator's back."""
        with self._pool_lock:
            if me not in self._pool:
                return
            self._pool.remove(me)
            if self.closed:
                return
            self.metrics["dispatch_worker_deaths"] += 1
            self._spawn_locked()

    def _account(self, msg: Message) -> None:
        self.metrics["received"] += 1
        # per-verb group (InternodeInboundTable / per-verb Dropwizard
        # meters): verb.<verb>.received counters in the global registry;
        # names cached per verb so the hot path skips the f-string build
        name = _VERB_RECEIVED.get(msg.verb)
        if name is None:
            name = _VERB_RECEIVED[msg.verb] = \
                f"verb.{msg.verb.lower()}.received"
        METRICS.incr(name)

    def _process(self, msg: Message) -> None:
        """Handle one inbound message inline: response-callback dispatch
        or verb-handler execution (the deterministic simulator calls
        this directly as a scheduled event, so sim runs keep the exact
        pre-pool single-threaded interleaving)."""
        self._account(msg)
        if msg.reply_to:
            self._process_response(msg)
        else:
            self._process_handler(msg)

    def _process_response(self, msg: Message) -> None:
        """Response-callback dispatch: distributor-thread (or sim) only,
        so callbacks for one request id observe a total order."""
        if msg.trace_session and msg.trace_events:
            # replica events merge BEFORE the callback acks — the
            # waiting coordinator may finish (and persist) the
            # session the instant the callback fires
            tracing.record_remote(msg.trace_session, msg.trace_events,
                                  source=msg.sender.name)
        with self._cb_lock:
            cb = self._callbacks.pop(msg.reply_to, None)
        if cb is not None:
            on_response, on_failure, _ = cb
            # a FAILURE_RSP (remote handler raised) is a failure,
            # never an ack (write/hint acks must mean applied)
            fn = on_failure if msg.verb == Verb.FAILURE_RSP \
                else on_response
            if fn is not None:
                try:
                    # both callbacks receive the Message, so a
                    # failure handler can inspect the remote
                    # error payload (callbacks reaped on timeout
                    # get the bare id instead — see _reap)
                    fn(msg)
                except Exception:
                    pass

    def _process_handler(self, msg: Message) -> None:
        """Verb-handler execution (pool workers; inline in sim mode).
        Bills the per-verb ledger stage so the where-did-the-wall-go
        table can attribute replica-side time by verb."""
        handler = self.handlers.get(msg.verb)
        if handler is None:
            return
        # per-verb ledger stage (pipeline.messaging.<verb>.*), created
        # lazily for verbs this node actually handles
        vstage = self._verb_stages.get(msg.verb)
        if vstage is None:
            vstage = self._verb_stages[msg.verb] = \
                pipeline_ledger.ledger("messaging").stage(msg.verb.lower())
        rst = token = None
        if msg.trace_session:
            # replica-side session: record handler events under the
            # propagated id; they ship back on the response and merge
            # into the coordinator's timeline
            rst = tracing.TraceState(session_id=msg.trace_session,
                                     source=self.ep.name)
            rst.add(f"{msg.verb} received from {msg.sender.name}")
            token = tracing.activate(rst)
        t0 = time.monotonic()
        try:
            result = handler(msg)
        except Exception as e:
            if rst is not None:
                rst.add(f"{msg.verb} failed: {type(e).__name__}")
            self.respond_failure(msg, e,
                                 trace_events=rst.events if rst else None)
            return
        finally:
            vstage.add_busy(time.monotonic() - t0)
            vstage.add_items(1)
            if token is not None:
                tracing.deactivate(token)
        if result is not None:
            rsp_verb, payload = result
            if rst is not None:
                rst.add(f"Enqueuing {rsp_verb} to {msg.sender.name}")
            self.respond(msg, rsp_verb, payload,
                         trace_events=rst.events if rst else None)

    def _reap(self) -> None:
        """Expire callbacks whose responses never arrived."""
        while not self.closed:
            time.sleep(0.1)
            now = time.monotonic()
            expired = []
            with self._cb_lock:
                for mid, (ok, fail, deadline) in list(self._callbacks.items()):
                    if now > deadline:
                        expired.append((mid, fail))
                        del self._callbacks[mid]
            for mid, fail in expired:
                self.metrics["dropped_timeout"] += 1
                if fail is not None:
                    try:
                        fail(mid)
                    except Exception:
                        pass

    def _expire_one(self, mid: int) -> None:
        """Sim-mode callback expiry (the _reap role as a scheduled
        event): same contract — the failure callback gets the bare id."""
        with self._cb_lock:
            cb = self._callbacks.pop(mid, None)
        if cb is None:
            return
        _ok, fail, _deadline = cb
        self.metrics["dropped_timeout"] += 1
        if fail is not None:
            try:
                fail(mid)
            except Exception:
                pass

    def close(self) -> None:
        self.closed = True
        self.transport.unregister(self.ep)
