"""Anti-entropy repair: merkle validation + range sync between replicas.

Reference counterpart: repair/RepairCoordinator.java:98 (session per
replica set, job per table), repair/Validator.java:61 (merkle build over
partition hashes via the compaction scanner), repair/SyncTask + the
streaming plan that moves mismatched ranges.

Flow: coordinator requests a VALIDATION from every replica (each hashes
its local partitions into a MerkleTree), diffs the trees pairwise, and for
every mismatched range pulls both sides' cells and pushes the merged truth
to whoever is missing data. Range data moves as columnar CellBatches — the
same wire shape streaming uses.
"""
from __future__ import annotations

import hashlib
import threading
import time

import numpy as np

from ..storage import cellbatch as cb
from ..utils.merkle import MerkleTree
from .coordinator import batch_to_mutation, cb_deserialize, cb_serialize
from .messaging import Verb
from .replication import ReplicationStrategy

_BIAS = 1 << 63


batch_tokens = cb.batch_tokens


def iter_partitions(batch: cb.CellBatch):
    """Yield (start, end, token) for every partition run of a sorted
    batch — the shared partition-boundary idiom."""
    n = len(batch)
    if n == 0:
        return
    toks = batch_tokens(batch)
    lane4 = batch.lanes[:, :4]
    part_new = np.ones(n, dtype=bool)
    part_new[1:] = (lane4[1:] != lane4[:-1]).any(axis=1)
    starts = np.flatnonzero(part_new)
    ends = np.append(starts[1:], n)
    for s, e in zip(starts, ends):
        yield int(s), int(e), int(toks[s])


filter_token_range = cb.filter_token_range


def build_validation_tree(table, batch: cb.CellBatch,
                          depth: int = 10) -> MerkleTree:
    """Validator role: hash every partition's reconciled cells into the
    tree (partition digest = md5 over lanes/ts/flags/payload of its
    cells)."""
    tree = MerkleTree(depth)
    n = len(batch)
    if n == 0:
        tree.seal()
        return tree
    for s, e, tok in iter_partitions(batch):
        h = hashlib.md5()
        h.update(batch.lanes[s:e].astype("<u4").tobytes())
        h.update(batch.ts[s:e].astype("<i8").tobytes())
        h.update(batch.flags[s:e].tobytes())
        h.update(batch.payload[batch.off[s]:batch.off[e]].tobytes())
        tree.add(tok, h.digest())
    tree.seal()
    return tree


class RepairSessionStore:
    """Durable repair-session records (repair/consistent/
    LocalSessions.java role): every coordinated session is journaled to
    repair_sessions.jsonl BEFORE it runs and finalized after, so a
    coordinator restart can report in-flight sessions (state
    IN_PROGRESS with no FINALIZED record) instead of forgetting them —
    the operator sees exactly which sessions died mid-flight
    (`nodetool repair_admin`)."""

    def __init__(self, directory: str):
        import os
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "repair_sessions.jsonl")
        self._lock = threading.Lock()

    def _append(self, rec: dict) -> None:
        import json
        import os
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def begin(self, session_id: str, **info) -> None:
        self._append({"id": session_id, "state": "IN_PROGRESS", **info})

    def finish(self, session_id: str, state: str, **info) -> None:
        self._append({"id": session_id, "state": state, **info})

    def sessions(self) -> list[dict]:
        """Latest state per session id, oldest first — survives
        restarts (read back from the journal)."""
        import json
        import os
        out: dict[str, dict] = {}
        if not os.path.exists(self.path):
            return []
        with self._lock:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue   # torn tail after a crash
                    out[rec["id"]] = {**out.get(rec["id"], {}), **rec}
        return list(out.values())

    def in_flight(self) -> list[dict]:
        return [s for s in self.sessions()
                if s.get("state") == "IN_PROGRESS"]


class RepairService:
    """Per-node repair endpoint + coordinator entry point."""

    def __init__(self, node):
        self.node = node
        # completed session records (system_views.repairs / nodetool
        # repair history; repair/RepairRunnable session state role) —
        # bounded: old sessions age out at constant memory
        from collections import deque
        self.history: "deque[dict]" = deque(maxlen=256)
        self.sessions = RepairSessionStore(node.engine.data_dir)
        node.messaging.register_handler(Verb.REPAIR_VALIDATION_REQ,
                                        self._handle_validation)
        node.messaging.register_handler(Verb.REPAIR_SYNC_REQ,
                                        self._handle_sync)
        node.messaging.register_handler(Verb.REPAIR_ANTICOMPACT_REQ,
                                        self._handle_anticompact)

    # ------------------------------------------------------------ handlers

    def _local_batch(self, keyspace, table_name):
        return self.node.engine.store(keyspace, table_name).scan_all()

    def _validate_local(self, keyspace, table_name, depth, incremental):
        """Build the local validation tree. For an incremental session,
        FLUSH first and capture the unrepaired sstable generations that
        existed at validation time — only exactly those may be stamped
        repaired later (an sstable flushed mid-repair was never
        validated). Validation itself always covers the FULL data:
        comparing unrepaired-only views diverges once repaired status
        differs across replicas for the same cells; full trees converge
        and the anticompaction step still delivers the compaction-split
        benefit (the pre-consistent-repair reference model)."""
        table = self.node.schema.get_table(keyspace, table_name)
        gens = []
        if incremental:
            cfs = self.node.engine.store(keyspace, table_name)
            cfs.flush()
            gens = [s.desc.generation for s in cfs.live_sstables()
                    if not s.is_repaired]
        tree = build_validation_tree(
            table, self._local_batch(keyspace, table_name), depth)
        return tree, gens

    def _handle_validation(self, msg):
        keyspace, table_name, depth, *rest = msg.payload
        incremental = bool(rest[0]) if rest else False
        tree, gens = self._validate_local(keyspace, table_name, depth,
                                          incremental)
        if incremental:
            return Verb.REPAIR_VALIDATION_RSP, (tree.serialize(), gens)
        return Verb.REPAIR_VALIDATION_RSP, tree.serialize()

    def _handle_sync(self, msg):
        keyspace, table_name, lo, hi, *rest = msg.payload
        batch = filter_token_range(self._local_batch(keyspace, table_name),
                                   lo, hi)
        return Verb.RANGE_RSP, cb_serialize(batch)

    def _handle_anticompact(self, msg):
        keyspace, table_name, ranges, repaired_at, *rest = msg.payload
        gens = set(rest[0]) if rest and rest[0] is not None else None
        n = self.anticompact_local(keyspace, table_name,
                                   [tuple(r) for r in ranges],
                                   int(repaired_at), gens)
        return Verb.REPAIR_ANTICOMPACT_RSP, n

    # ------------------------------------------------------ anticompaction

    def anticompact_local(self, keyspace, table_name, ranges,
                          repaired_at: int, gens=None) -> int:
        """Split every UNREPAIRED sstable at the repaired-range boundary:
        in-range cells land in a new sstable stamped repaired_at,
        out-of-range cells in a new unrepaired one
        (db/compaction/CompactionManager.java:838 doAntiCompaction).
        Returns the number of sstables rewritten."""
        import numpy as np

        from ..storage.rewrite import rewrite_sstable

        cfs = self.node.engine.store(keyspace, table_name)
        MIN = -(1 << 63)
        done = 0
        with self.node.engine.compactions.cfs_lock(cfs):
            for sst in list(cfs.live_sstables()):
                if sst.is_repaired:
                    continue
                if gens is not None \
                        and sst.desc.generation not in gens:
                    continue  # flushed after validation: not validated
                segs = list(sst.scanner())
                if not segs:
                    continue
                cat = cb.CellBatch.concat(segs)
                cat.sorted = True
                in_mask = cb.token_range_mask(batch_tokens(cat), ranges)

                def fill_for(mask, cat=cat):
                    def fill(w):
                        idx = np.flatnonzero(mask)
                        if len(idx):
                            part = cat.apply_permutation(idx)
                            part.sorted = True
                            w.append(part)
                    return fill

                rewrite_sstable(
                    cfs, sst,
                    [(repaired_at, sst.level, fill_for(in_mask)),
                     (0, sst.level, fill_for(~in_mask))])
                done += 1
        return done

    # --------------------------------------------------------- coordinator

    def repair_table(self, keyspace: str, table_name: str,
                     depth: int = 10, timeout: float = 10.0,
                     incremental: bool = False,
                     preview: bool = False) -> dict:
        """Full-range repair of one table across its replica set
        (RepairJob). incremental=True validates/syncs only data that was
        never repaired, then ANTICOMPACTS on every replica: synced
        ranges split out of unrepaired sstables and are stamped
        repairedAt, so future repairs skip them and compaction never
        mixes across the boundary (repair/consistent/).

        preview=True runs VALIDATION ONLY (repair --preview,
        PreviewKind role): merkle trees are built and diffed but
        nothing streams and nothing is stamped — the stats report how
        much WOULD sync. Sessions journal durably through
        RepairSessionStore either way. Returns stats."""
        import uuid as _uuid
        session_id = str(_uuid.uuid4())
        self.sessions.begin(session_id, keyspace=keyspace,
                            table=table_name, incremental=incremental,
                            preview=preview,
                            coordinator=self.node.endpoint.name)
        try:
            stats = self._repair_table(keyspace, table_name, depth,
                                       timeout, incremental, preview)
        except Exception as e:
            self.sessions.finish(session_id, "FAILED", error=repr(e))
            raise
        self.sessions.finish(session_id, "COMPLETED", **{
            k: v for k, v in stats.items() if isinstance(v, (int, bool))})
        return stats

    def _repair_table(self, keyspace, table_name, depth, timeout,
                      incremental, preview) -> dict:
        node = self.node
        ks = node.schema.keyspaces[keyspace]
        strat = ReplicationStrategy.create(ks.params.replication)
        replicas = set()
        for ep in node.ring.endpoints:
            for tok in node.ring.endpoints[ep]:
                for r in strat.replicas(node.ring, tok):
                    replicas.add(r)
        replicas = sorted(replicas, key=lambda e: e.name)
        live = [r for r in replicas if node.is_alive(r)]
        if incremental and len(live) < len(replicas):
            # stamping data repaired while a replica is down would hide
            # its missing writes from future sessions (the reference
            # refuses incremental repair with dead endpoints)
            raise RuntimeError(
                f"incremental repair requires all replicas up "
                f"({len(live)}/{len(replicas)} live); run full repair")

        trees = {}
        val_gens: dict = {}
        table = node.schema.get_table(keyspace, table_name)
        ev = threading.Event()
        lock = threading.Lock()

        def want_all():
            return len(trees) >= len(live)

        for ep in live:
            if ep == node.endpoint:
                with lock:
                    tree, gens = self._validate_local(
                        keyspace, table_name, depth, incremental)
                    trees[ep] = tree
                    val_gens[ep] = gens
                    if want_all():
                        ev.set()
            else:
                def on_rsp(m, e=ep):
                    with lock:
                        if incremental:
                            tree_b, gens = m.payload
                            trees[e] = MerkleTree.deserialize(tree_b)
                            val_gens[e] = list(gens)
                        else:
                            trees[e] = MerkleTree.deserialize(m.payload)
                        if want_all():
                            ev.set()
                node.messaging.send_with_callback(
                    Verb.REPAIR_VALIDATION_REQ,
                    (keyspace, table_name, depth, incremental), ep,
                    on_response=on_rsp, timeout=timeout)
        ev.wait(timeout)
        if len(trees) < len(live):
            raise TimeoutError(
                f"validation responses {len(trees)}/{len(live)}")

        stats = {"replicas": len(live), "ranges_synced": 0,
                 "cells_streamed": 0}
        if preview:
            stats["preview"] = True
            stats["ranges_mismatched"] = 0
        # diff LEAF-WISE among that leaf range's replica set only — with
        # RF < cluster size, comparing full trees across non-replicas
        # would stream data to nodes that don't own it (placement
        # violation). A leaf crossing a vnode boundary uses the union of
        # the replica sets at its ends (conservative).
        sample = next(iter(trees.values()))
        eps = list(trees)
        n_leaves = sample.n_leaves
        synced: set[tuple] = set()
        for leaf in range(n_leaves):
            lo, hi = sample.leaf_range(leaf)
            owners = set(strat.replicas(node.ring, lo + 1)) | \
                set(strat.replicas(node.ring, hi))
            present = [e for e in eps if e in owners]
            for i in range(len(present)):
                for j in range(i + 1, len(present)):
                    a, b = present[i], present[j]
                    la = trees[a].leaves[leaf]
                    lb = trees[b].leaves[leaf]
                    if (la != lb).any():
                        key = (a, b, lo, hi)
                        if key in synced:
                            continue
                        synced.add(key)
                        if preview:
                            # validate-only: report, never stream
                            stats["ranges_mismatched"] += 1
                            continue
                        n = self._sync_range(keyspace, table_name, a, b,
                                             lo, hi, timeout)
                        stats["ranges_synced"] += 1
                        stats["cells_streamed"] += n

        if incremental and not preview:
            # the whole token space is now consistent across the replica
            # set: anticompact everywhere so repaired data crosses the
            # boundary and future incremental repairs skip it
            # module-level `time`: the simulator patches this module's
            # attribute, so repaired_at follows the virtual clock under
            # simulation (an aliased function-level import escaped the
            # patch — ctpulint clock-discipline)
            repaired_at = int(time.time() * 1000)
            ranges = [(-(1 << 63), (1 << 63) - 1)]
            done = {}
            aev = threading.Event()

            def want_all_ac():
                return len(done) >= len(live)

            for ep in live:
                if ep == node.endpoint:
                    with lock:
                        done[ep] = self.anticompact_local(
                            keyspace, table_name, ranges, repaired_at,
                            set(val_gens.get(ep, [])))
                        if want_all_ac():
                            aev.set()
                else:
                    def on_ac(m, e=ep):
                        with lock:
                            done[e] = m.payload
                            if want_all_ac():
                                aev.set()
                    node.messaging.send_with_callback(
                        Verb.REPAIR_ANTICOMPACT_REQ,
                        (keyspace, table_name, ranges, repaired_at,
                         val_gens.get(ep, [])), ep,
                        on_response=on_ac, timeout=timeout)
            if not aev.wait(timeout):
                raise TimeoutError(
                    f"anticompaction acks {len(done)}/{len(live)}")
            stats["anticompacted"] = sum(done.values())
            stats["repaired_at"] = repaired_at
        self.history.append({"keyspace": keyspace, "table": table_name,
                             "incremental": incremental,
                             "replicas": len(live), **stats})
        return stats

    def _fetch_range(self, ep, keyspace, table_name, lo, hi, timeout):
        node = self.node
        if ep == node.endpoint:
            return filter_token_range(
                self._local_batch(keyspace, table_name), lo, hi)
        # sessioned fetch (chunked + CRC + retransmit): a sync over a
        # flaky wire retries and converges instead of timing out whole
        batch = node.streams.fetch_batch(ep, keyspace, table_name,
                                         lo, hi, timeout)
        # deserialized batches lose the ck composite translator; range
        # tombstone reconciliation needs it back
        t = node.schema.get_table(keyspace, table_name)
        batch.ck_comp = t.clustering_comp
        return batch

    def _apply_batch(self, ep, table, merged: cb.CellBatch):
        """Push the merged truth for a range to a replica, one partition
        per mutation (SyncTask -> streaming role)."""
        node = self.node
        if len(merged) == 0:
            return
        for s, e, _tok in iter_partitions(merged):
            part = merged.slice_range(s, e)
            m = batch_to_mutation(table, part)
            if m is None:
                continue
            if ep == node.endpoint:
                node.engine.apply(m)
            else:
                node.messaging.send_one_way(Verb.MUTATION_REQ,
                                            m.serialize(), ep)

    def apply_batch_to_owners(self, keyspace: str, table,
                              batch: cb.CellBatch,
                              timeout: float = 10.0, ring=None) -> None:
        """Push every partition of a batch to that partition's replica
        set, acked (decommission / rebalance streaming must be durable
        before the sender departs). `ring` overrides the node's current
        ring — a token move pushes surrendered data to its POST-move
        owners before committing the flip."""
        node = self.node
        ks = node.schema.keyspaces[keyspace]
        strat = ReplicationStrategy.create(ks.params.replication)
        route_ring = ring if ring is not None else node.ring
        pending = threading.Semaphore(0)
        failures = []
        sent = 0
        for s, e, tok in iter_partitions(batch):
            part = batch.slice_range(s, e)
            m = batch_to_mutation(table, part)
            if m is None:
                continue
            for ep in strat.replicas(route_ring, tok):
                if ep == node.endpoint:
                    node.engine.apply(m)
                else:
                    sent += 1

                    def fail(_i, e=ep):
                        failures.append(e)
                        pending.release()

                    node.messaging.send_with_callback(
                        Verb.MUTATION_REQ, m.serialize(), ep,
                        on_response=lambda _m: pending.release(),
                        on_failure=fail, timeout=timeout)
        for _ in range(sent):
            if not pending.acquire(timeout=timeout):
                raise TimeoutError("stream push not acknowledged")
        if failures:
            raise RuntimeError(
                f"stream push failed to {len(failures)} replica(s): "
                f"{set(failures)} — aborting handoff")

    def _sync_range(self, keyspace, table_name, a, b, lo, hi,
                    timeout) -> int:
        table = self.node.schema.get_table(keyspace, table_name)
        batch_a = self._fetch_range(a, keyspace, table_name, lo, hi,
                                    timeout)
        batch_b = self._fetch_range(b, keyspace, table_name, lo, hi,
                                    timeout)
        merged = cb.merge_sorted([batch_a, batch_b])
        digest_a = _digest(batch_a)
        digest_b = _digest(batch_b)
        md = _digest(merged)
        if digest_a != md:
            self._apply_batch(a, table, merged)
        if digest_b != md:
            self._apply_batch(b, table, merged)
        return len(merged)


_digest = cb.content_digest
