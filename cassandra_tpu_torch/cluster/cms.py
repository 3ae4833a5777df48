"""CMS — Paxos-backed commit of cluster-metadata epochs (TCM proper).

Reference counterpart: tcm/PaxosBackedProcessor.java:57 + tcm/Commit.java:
every metadata change (DDL and topology transformations alike) is decided
by single-decree Paxos over a small CMS replica group before any node
applies it. Properties this buys over the round-3 designated-coordinator
scheme (cluster/schema_sync.py history):

  - LINEARIZABLE epochs: slot N is decided once, by a quorum of the CMS
    replica set; two nodes can never durably hold different entries at
    the same epoch, so the adopt-winner/displace repair path is dead code
    for CMS-committed logs.
  - Minority partitions CANNOT commit: a coordinator that cannot reach a
    majority of the CMS set gets MetadataUnavailable, never a local
    fork (tests/test_cms_partition.py).
  - A losing proposer LEARNS the slot winner (from promise fast-path or
    the adopted in-flight value) and retries its own entry at the next
    slot — client-acked DDL is never silently displaced.

The replica-side promise/accept/commit state reuses the LWT machinery
(cluster/paxos.py PaxosState + crash-safe PaxosLog) with the epoch slot
as the partition key, in its own durable log directory (cms_paxos/) —
the system.paxos-for-TCM role of tcm/log/.

CMS membership: the min(3) lowest-named FULLY-JOINED endpoints of the
log-materialized ring (SchemaSync.cms_members) — deterministic at every
node that has applied the same log prefix, and captured ATOMICALLY with
the slot number for each proposal (SchemaSync.snapshot_for_commit), so
two proposers of the same slot always use the same member set and their
quorums intersect. Pending joiners are excluded until their finish_join
entry commits: membership moves only at a committed log entry, and the
OLD set decides the slot that admits the newcomer — mirroring how the
reference reconfigures the CMS explicitly through the log it guards
(tcm/membership/, tcm/ClusterMetadataService.java). Commit-then-apply:
nothing executes locally before the Paxos decision; the proposer applies
its own entry through the same COMMIT/learn path as every replica.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid

from .messaging import Message, Verb
from .paxos import Ballot, PaxosLog, PaxosState, ZERO

# pseudo-table id namespacing CMS slots inside the shared PaxosLog frame
# format (real LWT state never collides: this uuid belongs to no table)
CMS_TABLE_ID = uuid.uuid5(uuid.NAMESPACE_DNS, "ctpu.cms.metadata")
CMS_SIZE = 3


class MetadataUnavailable(Exception):
    """A metadata commit could not reach a quorum of the CMS replica
    set (minority partition / too many CMS members down)."""


def _slot_key(slot: int) -> bytes:
    return slot.to_bytes(8, "big")


class CMSService:
    """One node's CMS role: replica handlers (promise/accept/commit on
    epoch slots) + the coordinator-side commit loop."""

    PREPARE = "CMS_PREPARE"
    PROPOSE = "CMS_PROPOSE"
    COMMIT = "CMS_COMMIT"

    ROUND_TIMEOUT = 3.0
    MAX_BALLOT_ATTEMPTS = 10
    MAX_SLOT_ATTEMPTS = 64

    def __init__(self, node, sync, directory: str):
        self.node = node
        self.sync = sync    # SchemaSync: owns the applied epoch log
        self._states: dict[int, PaxosState] = {}
        self._lock = threading.Lock()
        self.log = PaxosLog(os.path.join(directory, "cms_paxos"))
        self._reload()
        ms = node.messaging
        ms.register_handler(self.PREPARE, self._handle_prepare)
        ms.register_handler(self.PROPOSE, self._handle_propose)
        ms.register_handler(self.COMMIT, self._handle_commit)

    # ----------------------------------------------------------- members --

    def members(self) -> list:
        """The CMS replica set as-of THIS node's applied log prefix —
        log-DERIVED, not live-ring-derived (SchemaSync.cms_members):
        pending joiners are not eligible until their finish_join entry
        commits, so the set moves only at a committed log entry and
        the OLD set decides the slot that admits a newcomer. Proposals
        capture (slot, members) atomically via
        SchemaSync.snapshot_for_commit so two proposers of one slot
        always share a member set (intersecting quorums)."""
        return self.sync.cms_members()

    def is_member(self) -> bool:
        return self.node.endpoint in self.members()

    # ----------------------------------------------------------- replicas --

    def _reload(self) -> None:
        for tid, pk, kind, ballot, value in self.log.replay():
            slot = int.from_bytes(pk, "big")
            st = self._state(slot)
            if kind == PaxosLog.K_PROMISE:
                st.promised = max(st.promised, ballot)
            elif kind == PaxosLog.K_ACCEPT:
                st.promised = max(st.promised, ballot)
                st.accepted_ballot = ballot
                st.accepted_value = value
            else:
                st.committed = max(st.committed, ballot)
                if st.accepted_ballot is not None \
                        and st.accepted_ballot <= ballot:
                    st.accepted_ballot = None
                    st.accepted_value = None

    def _state(self, slot: int) -> PaxosState:
        with self._lock:
            st = self._states.get(slot)
            if st is None:
                st = self._states[slot] = PaxosState()
            return st

    def _handle_prepare(self, msg):
        slot, ballot_t = msg.payload
        # fast path: the slot is already applied here — return the
        # committed entry so the proposer learns without a round trip
        ent = self.sync.entry_at(slot)
        if ent is not None:
            _e, query, keyspace, extra, coord = ent
            return "CMS_PROMISE", {
                "committed_entry": {"q": query, "k": keyspace,
                                    "x": extra or {}, "c": coord}}
        ballot = Ballot.unpack(ballot_t)
        st = self._state(slot)
        with st.lock:
            if ballot > st.promised:
                st.promised = ballot
                # durable BEFORE responding (quorum intersection)
                self.log.append(CMS_TABLE_ID, _slot_key(slot),
                                PaxosLog.K_PROMISE, ballot, None)
                rsp = {"promised": True,
                       "accepted_ballot": st.accepted_ballot.pack()
                       if st.accepted_ballot else None,
                       "accepted_value": st.accepted_value}
            else:
                rsp = {"promised": False}
        return "CMS_PROMISE", rsp

    def _handle_propose(self, msg):
        slot, ballot_t, value = msg.payload
        ballot = Ballot.unpack(ballot_t)
        st = self._state(slot)
        with st.lock:
            if ballot >= st.promised:
                st.promised = ballot
                st.accepted_ballot = ballot
                st.accepted_value = value
                self.log.append(CMS_TABLE_ID, _slot_key(slot),
                                PaxosLog.K_ACCEPT, ballot, value)
                rsp = {"accepted": True}
            else:
                rsp = {"accepted": False}
        return "CMS_ACCEPTED", rsp

    def _handle_commit(self, msg):
        slot, ballot_t, value = msg.payload
        ballot = Ballot.unpack(ballot_t)
        st = self._state(slot)
        with st.lock:
            if ballot > st.committed:
                st.committed = ballot
                if st.accepted_ballot is not None \
                        and st.accepted_ballot <= ballot:
                    st.accepted_ballot = None
                    st.accepted_value = None
                self.log.append(CMS_TABLE_ID, _slot_key(slot),
                                PaxosLog.K_COMMIT, ballot, None)
        # apply the decided entry if it is next in sequence (a gap is
        # healed by the SCHEMA_PUSH broadcast / pull catch-up)
        self.sync.learn(slot, json.loads(value))
        return "CMS_COMMITTED", {}

    # -------------------------------------------------------- coordinator --

    def _quorum_round(self, verb: str, payload, members, need: int):
        """One round to the CMS set; self-delivery inline. Returns the
        responses collected before timeout (may be < need — caller
        checks)."""
        node = self.node
        results: list = []
        lock = threading.Lock()
        ev = threading.Event()

        def collect(res):
            with lock:
                results.append(res)
                if len(results) >= need:
                    ev.set()

        handler = {self.PREPARE: self._handle_prepare,
                   self.PROPOSE: self._handle_propose,
                   self.COMMIT: self._handle_commit}[verb]
        for ep in members:
            if ep == node.endpoint:
                m = Message(verb, payload, ep, ep)
                collect(handler(m)[1])
            else:
                node.messaging.send_with_callback(
                    verb, payload, ep,
                    on_response=lambda m: collect(m.payload),
                    timeout=self.ROUND_TIMEOUT)
        ev.wait(self.ROUND_TIMEOUT)
        with lock:
            return list(results)

    _last_ballot_ts = 0
    _ballot_lock = threading.Lock()

    def _next_ballot(self) -> Ballot:
        with CMSService._ballot_lock:
            ts = max(time.time_ns(), CMSService._last_ballot_ts + 1)
            CMSService._last_ballot_ts = ts
        return Ballot(ts, self.node.endpoint.name)

    def _paxos_slot(self, slot: int, value: bytes,
                    members: list) -> bytes:
        """Decide slot among `members` (the set the caller captured
        atomically with the slot number — see snapshot_for_commit):
        returns the DECIDED value bytes (ours, or the winner we must
        apply instead). Raises MetadataUnavailable when a quorum
        cannot be reached."""
        need = len(members) // 2 + 1
        last_err = None
        for attempt in range(self.MAX_BALLOT_ATTEMPTS):
            ballot = self._next_ballot()
            promises = self._quorum_round(
                self.PREPARE, (slot, ballot.pack()), members, need)
            committed = [p for p in promises
                         if isinstance(p, dict) and "committed_entry" in p]
            if committed:
                # slot already decided and applied somewhere: learn it
                return json.dumps(committed[0]["committed_entry"],
                                  sort_keys=True).encode()
            granted = [p for p in promises
                       if isinstance(p, dict) and p.get("promised")]
            if len(promises) < need:
                last_err = MetadataUnavailable(
                    f"CMS prepare: {len(promises)}/{need} of "
                    f"{[m.name for m in members]} responded")
                time.sleep(0.02 * (attempt + 1))
                continue
            if len(granted) < need:
                # contention: back off and retry with a higher ballot
                time.sleep(0.02 * (attempt + 1))
                continue
            # adopt the highest in-flight accepted value, if any
            inflight = [(Ballot.unpack(p["accepted_ballot"]),
                         p["accepted_value"]) for p in granted
                        if p.get("accepted_ballot") is not None]
            proposal = value
            if inflight:
                _b, proposal = max(inflight, key=lambda x: x[0])
            accepts = self._quorum_round(
                self.PROPOSE, (slot, ballot.pack(), proposal),
                members, need)
            ok = [a for a in accepts
                  if isinstance(a, dict) and a.get("accepted")]
            if len(ok) < need:
                last_err = MetadataUnavailable(
                    f"CMS propose: {len(ok)}/{need} accepts")
                time.sleep(0.02 * (attempt + 1))
                continue
            # decided: commit is the learn broadcast (applies via
            # sync.learn on every CMS member; non-members learn from
            # the SCHEMA_PUSH the committer sends after)
            self._quorum_round(self.COMMIT,
                               (slot, ballot.pack(), proposal),
                               members, 1)
            return proposal
        raise last_err or MetadataUnavailable(
            f"CMS slot {slot}: ballot contention exhausted")

    def commit_entry(self, query: str, keyspace, extra: dict,
                     revalidate=None) -> int:
        """Commit (query, keyspace, extra) at the next free epoch.
        COMMIT-THEN-APPLY: the caller must NOT have executed the
        statement — the decided entry applies via the COMMIT
        self-delivery (sync.learn), the same path every replica takes.
        Losing a slot to a concurrent commit applies the winner and
        retries at the next slot (with a re-snapshotted member set —
        the lost slot may have changed CMS membership). `revalidate`
        (no-arg callable raising on semantic error) re-checks the
        statement against the just-applied winner before each retry:
        without it, losing CREATE TABLE t to a concurrent CREATE
        TABLE t would commit a permanently-doomed duplicate entry that
        every node (and every future replay) fails to apply. Returns
        the epoch ours landed at."""
        # normalize through JSON so equality with a decided value is
        # type-faithful (tuples become lists etc.)
        value_dict = json.loads(json.dumps(
            {"q": query, "k": keyspace, "x": extra or {},
             "c": self.node.endpoint.name}, sort_keys=True))
        value = json.dumps(value_dict, sort_keys=True).encode()
        for _ in range(self.MAX_SLOT_ATTEMPTS):
            slot, members = self.sync.snapshot_for_commit()
            decided = self._paxos_slot(slot, value, members)
            ddict = json.loads(decided)
            self.sync.learn(slot, ddict)
            self._push_entry(slot, ddict)
            if ddict == value_dict:
                return slot
            # lost the slot: the winner is applied; ours retries next —
            # unless the winner invalidated it (raises to the client)
            if revalidate is not None:
                revalidate()
        raise MetadataUnavailable(
            f"lost {self.MAX_SLOT_ATTEMPTS} consecutive metadata slots")

    def _push_entry(self, slot: int, ddict: dict) -> None:
        """Broadcast the committed entry to every peer — including
        PENDING joiners and replacements (a mid-join node must track
        the log it is about to become part of; reference
        tcm/log/LocalLog replication reaches registered-but-not-joined
        nodes). Non-CMS nodes learn from this push; stragglers pull."""
        ring = self.node.ring
        targets = set(ring.endpoints) | set(ring.pending) \
            | set(ring.replacing)
        for ep in targets:
            if ep != self.node.endpoint:
                self.node.messaging.send_one_way(
                    Verb.SCHEMA_PUSH,
                    (slot, ddict["q"], ddict["k"], ddict["x"]), ep)
