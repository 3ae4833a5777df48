"""Counter writes: the leader path.

Reference counterpart: service/StorageProxy.java applyCounterMutation +
db/CounterMutation.java (striped locks, read-modify-write into per-node
shards, the counter write stage). A counter increment is NOT
idempotent, so it cannot fan out like a normal write — a retried or
hinted delta would double-count. Instead:

  1. the coordinator routes the increment to a LEADER: a live replica
     of the key (itself when it is one);
  2. the leader serializes increments per partition (striped locks),
     reads its OWN current shard for each touched counter column, and
     folds the delta into a CUMULATIVE per-leader shard cell:
     path = leader name, value = running total, timestamp strictly
     monotonic per shard;
  3. the shard cell replicates through the NORMAL write path at the
     requested consistency level. Shards are plain last-write-wins
     cells (no FLAG_COUNTER — cumulative totals must never be summed
     across versions), so retries, hints, read repair and all three
     merge engines handle them with zero special cases.

A counter column's read value is the SUM of its live shards — one per
leader that ever coordinated an increment for it — summed during row
assembly (storage/rows.py). The non-cluster engine path keeps plain
delta cells (path=b"", FLAG_COUNTER, merge sums them); shard identity
only matters once increments replicate.
"""
from __future__ import annotations

import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

from ..storage.cellbatch import FLAG_COUNTER, FLAG_TOMBSTONE
from ..storage.mutation import Mutation
from ..utils import timeutil
from .messaging import Verb


class CounterService:
    STRIPES = 64
    CACHE_MAX = 65536   # own-shard entries (counter cache role)

    def __init__(self, node):
        self.node = node
        self._locks = [threading.Lock() for _ in range(self.STRIPES)]
        # counter cache (cache/CounterCacheKey role): this node's OWN
        # shard per touched counter cell. Coherent because only
        # apply_as_leader writes our shard, serialized by the stripe
        # locks — without it every increment pays a full partition read.
        self._cache: dict[tuple, tuple[int, int]] = {}
        self._cache_lock = threading.Lock()
        self._cache_epoch = 0   # bumped by invalidate_table (truncate)
        # the counter write stage: leader-side work blocks on the
        # replication CL, so it must NEVER run on the messaging
        # dispatch thread (the acks it waits for arrive there)
        self._stage = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"counter-{node.endpoint.name}")
        node.messaging.register_handler(Verb.COUNTER_REQ, self._handle)

    def close(self) -> None:
        self._stage.shutdown(wait=False)

    def _lock_for(self, pk: bytes) -> threading.Lock:
        return self._locks[zlib.crc32(pk) % self.STRIPES]

    def invalidate_table(self, table_id) -> None:
        """TRUNCATE/DROP: cached shard totals for the table must not
        survive (they would resurrect pre-truncate counts). The epoch
        bump makes an in-flight apply_as_leader discard its pending
        cache insert — its shard was computed against pre-truncate
        state."""
        with self._cache_lock:
            self._cache_epoch += 1
            for k in [k for k in self._cache if k[0] == table_id]:
                del self._cache[k]

    def invalidate_cache(self) -> None:
        """nodetool invalidatecountercache: drop every cached shard."""
        with self._cache_lock:
            self._cache_epoch += 1
            self._cache.clear()

    # ------------------------------------------------------------ leader --

    def apply_as_leader(self, keyspace: str, mutation: Mutation,
                        cl: str) -> None:
        """Fold delta ops into this node's cumulative shards, then
        replicate the shard mutation at `cl`. Runs on a client thread
        or the counter stage — never the dispatch thread."""
        t = self.node.schema.table_by_id(mutation.table_id)
        cfs = self.node.engine.store(t.keyspace, t.name)
        shard_path = self.node.endpoint.name.encode()
        with self._lock_for(mutation.pk):
            current = None        # partition read only on cache miss
            shard_m = Mutation(mutation.table_id, mutation.pk)
            now = timeutil.now_micros()
            deltas: dict[tuple, int] = {}
            for ck, column, path, value, ts, ldt, ttl, flags in \
                    mutation.ops:
                if flags & FLAG_COUNTER:
                    key = (ck, column)
                    deltas[key] = deltas.get(key, 0) + int.from_bytes(
                        value, "big", signed=True)
                else:
                    shard_m.add(ck, column, path, value, ts, ldt, ttl,
                                flags)
            new_cache = {}
            with self._cache_lock:
                epoch0 = self._cache_epoch
            for (ck, column), delta in deltas.items():
                ckey = (mutation.table_id, mutation.pk, ck, column)
                with self._cache_lock:
                    hit = self._cache.get(ckey)
                if hit is None:
                    if current is None:
                        current = cfs.read_partition(mutation.pk)
                    hit = self._own_shard(current, ck, column,
                                          shard_path)
                old_sum, old_ts = hit
                ts = max(now, old_ts + 1)
                shard_m.add(ck, column, shard_path,
                            (old_sum + delta).to_bytes(8, "big",
                                                       signed=True), ts)
                new_cache[ckey] = (old_sum + delta, ts)
            try:
                self.node.proxy.mutate(t.keyspace, shard_m, cl)
            except Exception:
                # the shard may have applied to SOME replicas (e.g. a
                # timeout after the local write): stale cache entries
                # would roll those shards backwards on the next
                # increment — evict so it re-reads local truth
                with self._cache_lock:
                    for ckey in new_cache:
                        self._cache.pop(ckey, None)
                raise
            with self._cache_lock:
                if self._cache_epoch != epoch0:
                    return   # truncated mid-flight: don't resurrect
                if len(self._cache) + len(new_cache) > self.CACHE_MAX:
                    self._cache.clear()
                self._cache.update(new_cache)

    @staticmethod
    def _own_shard(batch, ck: bytes, column: int,
                   shard_path: bytes) -> tuple[int, int]:
        """(current total, timestamp) of this leader's shard in the
        reconciled local partition view; (0, 0) if never written.
        Lane-array prefilter keeps this O(matching cells) in Python —
        the full-partition scan would hold the stripe lock for the
        whole partition's width on every increment."""
        import numpy as np
        C = batch.n_lanes - 9
        col_lane = batch.lanes[:, 6 + C]
        cand = np.flatnonzero(
            (col_lane == np.uint32(column))
            & ((batch.flags & FLAG_TOMBSTONE) == 0))
        total, ts = 0, 0
        for i in cand:
            bck, bpath, bval = batch.cell_payload(int(i))
            if bck != ck or bpath != shard_path:
                continue
            if int(batch.ts[i]) >= ts:
                total = int.from_bytes(bval, "big", signed=True)
                ts = int(batch.ts[i])
        return total, ts

    # ------------------------------------------------------- coordinator --

    def mutate(self, keyspace: str, mutation: Mutation, cl: str) -> None:
        """Coordinator side: pick the leader and hand it the deltas.
        The leader acks only after the shard replication reached `cl`."""
        replicas, _strat, _token = self.node.proxy._plan(keyspace,
                                                         mutation.pk)
        live = [r for r in replicas if self.node.is_alive(r)]
        if not live:
            from .coordinator import UnavailableException
            raise UnavailableException(
                "no live replica to lead the counter write")
        if self.node.endpoint in live:
            self.apply_as_leader(keyspace, mutation, cl)
            return
        leader = live[0]
        done = threading.Event()
        box: dict = {}

        def on_rsp(msg):
            box["ok"] = True
            done.set()

        def on_fail(msg):
            # FAILURE_RSP carries {"kind": exc class name, "error": repr};
            # a reap timeout passes the bare message id instead
            box["err"] = getattr(msg, "payload", None)
            done.set()

        # leader waits up to the counter-write timeout for its
        # replication CL, so the origin waits longer than one (the
        # counter_write_request_timeout knob, hot-reloadable through
        # the coordinator's listener; the blanket proxy.timeout setter
        # still covers it for tests)
        budget = self.node.proxy.counter_write_timeout * 2
        self.node.messaging.send_with_callback(
            Verb.COUNTER_REQ, (mutation.serialize(), cl), leader,
            on_response=on_rsp, on_failure=on_fail, timeout=budget)
        from .coordinator import TimeoutException, UnavailableException
        if not done.wait(budget):
            raise TimeoutException(
                f"counter leader {leader.name} did not ack")
        if "ok" not in box:
            err = box.get("err")
            kind = self.node.messaging.failure_kind(err)
            text = err.get("error") if isinstance(err, dict) else err
            if kind == "UnavailableException":
                # surface the leader's CL failure as what it is — the
                # caller must not treat 'not enough replicas' as a
                # maybe-applied timeout
                raise UnavailableException(
                    f"counter leader {leader.name}: {text}")
            raise TimeoutException(
                f"counter leader {leader.name} failed: {text!r}")

    def _handle(self, msg):
        """Leader's COUNTER_REQ handler: punt to the counter stage —
        apply_as_leader blocks on replication acks that can only be
        processed by this dispatch thread."""
        data, cl = msg.payload
        m = Mutation.deserialize(data)
        t = self.node.schema.table_by_id(m.table_id)

        def run():
            try:
                self.apply_as_leader(t.keyspace, m, cl)
                self.node.messaging.respond(msg, Verb.COUNTER_RSP, True)
            except Exception as e:
                self.node.messaging.respond_failure(msg, e)

        self._stage.submit(run)
        return None
