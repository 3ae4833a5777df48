"""Gossip liveness: heartbeat rounds + phi-accrual failure detection.

Reference counterpart: gms/Gossiper.java:132 (1 Hz rounds, SYN/ACK digest
exchange), gms/FailureDetector.java:71 (phi accrual over heartbeat
inter-arrival times, convict threshold 8).
"""
from __future__ import annotations

import math
import random
import threading
from ..utils import lockwitness
import time
from dataclasses import dataclass, field

from ..service import diagnostics
from .messaging import MessagingService, Verb
from .ring import Endpoint

PHI_CONVICT_THRESHOLD = 8.0


@dataclass
class EndpointState:
    generation: int
    version: int = 0
    alive: bool = True
    arrival_intervals: list = field(default_factory=list)
    last_heartbeat: float = 0.0
    app_states: dict = field(default_factory=dict)  # status, tokens, ...
    # operator-asserted death (force_convict): only a GENERATION advance
    # (the node actually restarting) may resurrect, never version churn
    # relayed through third-party digests
    forced_down: bool = False


class FailureDetector:
    """Phi accrual: phi = -log10(P(no heartbeat for `elapsed`)) under an
    exponential model of observed inter-arrival times. Until enough
    intervals are observed, `default_mean` stands in so a peer that dies
    right after startup is still convicted."""

    WINDOW = 100

    def __init__(self, default_mean: float = 1.0):
        self._states: dict[Endpoint, EndpointState] = {}
        self.default_mean = default_mean
        # live conviction threshold: Node binds this to the mutable
        # phi_convict_threshold knob (DatabaseDescriptor
        # .setPhiConvictThreshold role); the module constant is only
        # the default
        self.threshold = PHI_CONVICT_THRESHOLD

    def report(self, ep: Endpoint, state: EndpointState,
               now: float) -> None:
        if state.last_heartbeat > 0:
            state.arrival_intervals.append(now - state.last_heartbeat)
            if len(state.arrival_intervals) > self.WINDOW:
                state.arrival_intervals.pop(0)
        state.last_heartbeat = now

    def phi(self, state: EndpointState, now: float) -> float:
        if state.last_heartbeat == 0:
            return 0.0
        if state.arrival_intervals:
            mean = sum(state.arrival_intervals) / \
                len(state.arrival_intervals)
            mean = max(mean, 1e-3)
        else:
            mean = self.default_mean
        elapsed = now - state.last_heartbeat
        return (elapsed / mean) / math.log(10)

    def is_alive(self, state: EndpointState, now: float) -> bool:
        return self.phi(state, now) < self.threshold


class Gossiper:
    """Heartbeat exchange over the messaging service. interval configurable
    so tests can run accelerated rounds (the reference gossips at 1 Hz)."""

    def __init__(self, messaging: MessagingService, seeds: list[Endpoint],
                 interval: float = 1.0, clock=None):
        self.messaging = messaging
        self.ep = messaging.ep
        self.seeds = [s for s in seeds if s != self.ep]
        self.interval = interval
        # bound at CALL time through the module attribute, never as a
        # default argument: the simulator patches `time` on this module,
        # and a def-time `clock=time.monotonic` default would capture
        # the REAL clock before the patch (ctpulint clock-discipline)
        self.clock = clock if clock is not None else time.monotonic
        self.detector = FailureDetector(default_mean=max(interval * 3, 0.1))
        self.states: dict[Endpoint, EndpointState] = {
            self.ep: EndpointState(generation=int(time.time()))}
        self._lock = lockwitness.make_lock("gossip.state")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # per-instance RNG for peer selection: the deterministic
        # simulator seeds it per node; sharing the module RNG would let
        # any other thread's draws perturb a simulation's replay
        self.rng = random.Random()
        self.on_alive = None    # callbacks for hint replay etc.
        self.on_dead = None
        # called with (ep, app_states) when a peer's versioned state
        # advances — schema-epoch anti-entropy etc. Invoked OUTSIDE the
        # gossip lock; must not block (dispatch thread).
        self.on_app_state = None
        messaging.register_handler(Verb.GOSSIP_SYN, self._handle_syn)
        messaging.register_handler(Verb.GOSSIP_ACK, self._handle_ack_msg)

    # ----------------------------------------------------------- protocol

    def _digest(self) -> dict:
        with self._lock:
            me = self.states[self.ep]
            me.version += 1
            return {ep.name: (ep, st.generation, st.version,
                              dict(st.app_states))
                    for ep, st in self.states.items()}

    def _merge(self, digest: dict) -> None:
        now = self.clock()
        advanced = []
        with self._lock:
            for name, (ep, gen, ver, apps) in digest.items():
                if ep == self.ep:
                    continue
                st = self.states.get(ep)
                if st is None:
                    st = EndpointState(generation=gen, version=ver,
                                       app_states=apps)
                    self.states[ep] = st
                    self.detector.report(ep, st, now)
                    advanced.append((ep, dict(st.app_states)))
                elif (gen, ver) > (st.generation, st.version):
                    gen_advance = gen > st.generation
                    st.generation, st.version = gen, ver
                    st.app_states.update(apps)
                    self.detector.report(ep, st, now)
                    advanced.append((ep, dict(st.app_states)))
                    if not st.alive and (not st.forced_down or gen_advance):
                        st.alive = True
                        st.forced_down = False
                        diagnostics.publish("gossip.status",
                                            endpoint=ep.name,
                                            alive=True,
                                            source=self.ep.name)
                        if self.on_alive:
                            self.on_alive(ep)
        if self.on_app_state:
            for ep, apps in advanced:
                self.on_app_state(ep, apps)

    def _handle_syn(self, msg):
        self._merge(msg.payload)
        return Verb.GOSSIP_ACK, self._digest()

    def _handle_ack_msg(self, msg):
        self._merge(msg.payload)
        return None

    # ------------------------------------------------------------- rounds

    def round(self) -> None:
        """One gossip round: SYN a random live peer + maybe a seed, then
        re-evaluate liveness (GossipTask semantics)."""
        digest = self._digest()
        with self._lock:
            peers = [e for e in self.states if e != self.ep]
        targets = []
        if peers:
            targets.append(self.rng.choice(peers))
        if self.seeds and (not targets or self.rng.random() < 0.3):
            targets.append(self.rng.choice(self.seeds))
        for t in set(targets):
            self.messaging.send_with_callback(
                Verb.GOSSIP_SYN, digest, t,
                on_response=lambda m: self._merge(m.payload),
                timeout=self.interval * 2)
        self._check_liveness()

    def _check_liveness(self) -> None:
        now = self.clock()
        with self._lock:
            for ep, st in self.states.items():
                if ep == self.ep:
                    continue
                alive = self.detector.is_alive(st, now)
                if st.alive and not alive:
                    st.alive = False
                    diagnostics.publish("gossip.status",
                                        endpoint=ep.name, alive=False,
                                        source=self.ep.name)
                    if self.on_dead:
                        self.on_dead(ep)
                elif not st.alive and alive and not st.forced_down:
                    st.alive = True
                    diagnostics.publish("gossip.status",
                                        endpoint=ep.name, alive=True,
                                        source=self.ep.name)
                    if self.on_alive:
                        self.on_alive(ep)

    def live_endpoints(self) -> list[Endpoint]:
        with self._lock:
            return [ep for ep, st in self.states.items() if st.alive]

    def is_alive(self, ep: Endpoint) -> bool:
        with self._lock:
            st = self.states.get(ep)
            return bool(st and st.alive)

    def is_running(self) -> bool:
        return not self._stop.is_set() and self._thread is not None \
            and self._thread.is_alive()

    def force_convict(self, ep: Endpoint, generation: int | None = None,
                      version: int | None = None) -> None:
        """Operator-asserted death (nodetool assassinate / the replace
        flow's precondition). The state keeps its known (generation,
        version) so silent gossip digests can't resurrect it — only the
        node actually speaking again (a generation/version advance)
        does; last_heartbeat is pushed far past so phi stays convicted."""
        with self._lock:
            st = self.states.get(ep)
            if st is None:
                st = EndpointState(generation=generation or 0,
                                   version=version or 0)
                self.states[ep] = st
            st.alive = False
            st.forced_down = True
            st.arrival_intervals.clear()
            st.last_heartbeat = self.clock() - 1e9
        diagnostics.publish("gossip.status", endpoint=ep.name,
                            alive=False, forced=True,
                            source=self.ep.name)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        # restartable: nodetool enablegossip after disablegossip
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"gossip-{self.ep.name}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.round()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
