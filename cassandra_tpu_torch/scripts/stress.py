"""cassandra-stress-style multi-connection WIRE driver.

Reference counterpart: tools/stress/ (Stress.java) driving the native
protocol over real sockets — unlike tools/stress.py (which calls a
Session in-process), every operation here crosses the event-loop server
(cassandra_tpu_torch/transport/): prepared statements, admission control,
per-client rate limiting and the v5 segment framing are all on the path.

Workloads: write / read / mixed (--write-ratio) over a fixed integer
key space, keys drawn uniform / zipf (hot-partition skew) / sequential
(disjoint per-connection ranges — deterministic, the smoke mode's
correctness base). One OS thread per connection issues synchronous
requests, so `--connections` IS the offered concurrency; latencies land
in a shared service/metrics.LatencyHistogram (the same decaying
histogram the server exports) plus exact numpy percentiles.

Errors are classified by wire code: OVERLOADED (0x1001) shed by the
permit gate / overload signals vs rate-limited (same code, rate-limit
message) vs UNPREPARED (0x2500) vs other. The caller decides whether
they are failures: the bench's overload run REQUIRES them.

`--smoke` is the tier-2 drill (exit 1 on violation, seconds-long,
deterministic; CI runs it alongside chaos_storage.py): in-process
server, then (1) concurrent writes land and read back exactly,
(2) serving 64 connections creates no new server threads (the
event-loop contract), (3) with the permit cap pinched the server sheds
with OVERLOADED while in-flight never exceeds the cap and the server
stays responsive, (4) the per-client rate limiter sheds and hot-reloads
off again.

The in-process engines run on --device (`cuda` by default, which
raises without a card; `cpu` runs the kernels' plain PyTorch versions).

Usage:
  python -m cassandra_tpu_torch.scripts.stress --profile mixed \
      --connections 64 --ops 8192
  python -m cassandra_tpu_torch.scripts.stress --host 10.0.0.5 \
      --port 9042 --profile read
  python -m cassandra_tpu_torch.scripts.stress --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


KEYSPACE = "stress"
TABLE = "frontdoor"
DDL = (f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE} WITH replication = "
       "{'class': 'SimpleStrategy', 'replication_factor': 1}",
       f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.{TABLE} "
       "(key int PRIMARY KEY, v blob)")
INSERT = f"INSERT INTO {KEYSPACE}.{TABLE} (key, v) VALUES (?, ?)"
SELECT = f"SELECT v FROM {KEYSPACE}.{TABLE} WHERE key = ?"


def _client_table():
    """Client-side mirror of the stress table for wire serialization
    (the driver serializes bind values against CQL types itself)."""
    from cassandra_tpu_torch.schema import make_table
    return make_table(KEYSPACE, TABLE, pk=["key"],
                      cols={"key": "int", "v": "blob"})


def _classify(msg: str) -> str:
    if "0x1001" in msg:
        return "rate_limited" if "rate limit" in msg.lower() \
            else "overloaded"
    if "0x2500" in msg:
        return "unprepared"
    return "other"


def _keys(dist: str, n: int, key_space: int, rng, worker: int,
          workers: int) -> np.ndarray:
    """The per-worker key stream — a pure function of (dist, seed-derived
    rng, worker, workers), so --seed makes the whole run's key/op stream
    reproducible."""
    if dist == "sequential":
        # partition the KEY SPACE per connection: worker w walks its own
        # balanced slice [w*ks//workers, (w+1)*ks//workers) and wraps
        # within it (they used to walk [w*n, w*n+n), which ignored
        # key_space entirely). For workers <= key_space the slices are
        # disjoint and their union is [0, key_space) exactly — even
        # when key_space % workers != 0 — so with per-worker ops >= the
        # slice width the smoke read-back covers every key. With MORE
        # workers than keys, disjointness is impossible: zero-width
        # slices widen to one shared key.
        ks = max(key_space, 1)
        w = max(workers, 1)
        lo = worker * ks // w
        width = max((worker + 1) * ks // w - lo, 1)
        return (lo % ks) + (np.arange(n) % width)
    if dist == "zipf":
        # zipf-skewed hot partitions clipped into the key space
        return np.minimum(rng.zipf(1.3, n), key_space) - 1
    return rng.integers(0, key_space, n)


def _worker(idx: int, host: str, port: int, profile: str, n_ops: int,
            dist: str, key_space: int, value_bytes: int,
            write_ratio: float, seed: int, workers: int, hist,
            barrier, results: list) -> None:
    from cassandra_tpu_torch.client import Cluster, DriverError, \
        serialize_params
    rng = np.random.default_rng(seed * 100_000 + idx)
    table = _client_table()
    lats: list = []
    errs: dict = {}
    ok = 0
    # connect + prepare BEFORE the barrier so every worker reaches it
    # exactly once (a broken barrier strands the whole run); a failed
    # connection just records itself and sits the run out
    sess = None
    try:
        sess = Cluster(host, port).connect()
        wq = sess.prepare(INSERT)
        rq = sess.prepare(SELECT)
    except Exception as e:
        errs["connection"] = 1
        errs["connection_detail"] = f"{type(e).__name__}: {e}"
        if sess is not None:   # connected but a PREPARE failed: close,
            try:               # don't leak the socket into the server
                sess.close()
            except Exception:
                pass
        sess = None
    keys = _keys(dist, n_ops, key_space, rng, idx, workers)
    if profile == "mixed":
        is_write = rng.random(n_ops) < write_ratio
    else:
        is_write = np.full(n_ops, profile == "write")
    vals = rng.integers(0, 256, (n_ops, value_bytes), dtype=np.uint8)
    barrier.wait()
    if sess is not None:
        for i in range(n_ops):
            k = int(keys[i])
            t0 = time.perf_counter()
            try:
                if is_write[i]:
                    sess.execute_prepared(
                        wq, serialize_params(table, ["key", "v"],
                                             [k, vals[i].tobytes()]))
                else:
                    sess.execute_prepared(
                        rq, serialize_params(table, ["key"], [k]))
                ok += 1
            except DriverError as e:
                kind = _classify(str(e))
                errs[kind] = errs.get(kind, 0) + 1
                continue   # shed ops are near-instant round trips:
                # counting them into lats would inflate ops/s and
                # deflate tail latency exactly when the server sheds
            except Exception as e:   # dead socket mid-run
                errs["connection"] = errs.get("connection", 0) + 1
                errs.setdefault("connection_detail",
                                f"{type(e).__name__}: {e}")
                break
            us = (time.perf_counter() - t0) * 1e6
            lats.append(us)
            hist.update_us(us)
        try:
            sess.close()
        except Exception:
            pass
    results[idx] = (lats, errs, ok)


def _spawn_and_aggregate(connections: int, target, make_args):
    """The shared drive loop both wire drivers use: spawn one worker
    thread per connection, release them together through the barrier,
    time the joined run, and merge the per-worker (lats, errs, ok)
    triples (a worker that never reported counts as one connection
    error; connection_detail keeps the first). Returns
    (wall_s, lats, errors, ok)."""
    barrier = threading.Barrier(connections + 1)
    results: list = [None] * connections
    threads = [threading.Thread(
        target=target, daemon=True,
        args=make_args(i, barrier, results))
        for i in range(connections)]
    for t in threads:
        t.start()
    barrier.wait()               # all sessions connected and prepared
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lats: list = []
    errors: dict = {}
    ok = 0
    for r in results:
        if r is None:
            errors["connection"] = errors.get("connection", 0) + 1
            continue
        w_lats, w_errs, w_ok = r
        lats += w_lats
        ok += w_ok
        for k, v in w_errs.items():
            if k == "connection_detail":
                errors.setdefault(k, v)
            else:
                errors[k] = errors.get(k, 0) + v
    return wall, lats, errors, ok


def run_stress(host: str, port: int, *, profile: str = "mixed",
               connections: int = 16, ops: int = 4096,
               dist: str = "uniform", key_space: int = 4096,
               value_bytes: int = 64, write_ratio: float = 0.5,
               seed: int = 1, setup: bool = True) -> dict:
    """Drive `ops` total operations over `connections` concurrent wire
    connections; returns ops/s + exact p50/p99 + the decaying-histogram
    summary + error counts by class."""
    from cassandra_tpu_torch.client import Cluster
    from cassandra_tpu_torch.service.metrics import LatencyHistogram
    if setup:
        s = Cluster(host, port).connect()
        for ddl in DDL:
            s.execute(ddl)
        s.close()
    per_conn = max(1, ops // connections)
    hist = LatencyHistogram()
    wall, lats, errors, ok = _spawn_and_aggregate(
        connections, _worker,
        lambda i, barrier, results: (
            i, host, port, profile, per_conn, dist, key_space,
            value_bytes, write_ratio, seed, connections, hist,
            barrier, results))
    arr = np.array(lats) if lats else np.array([0.0])
    attempted = ok + sum(v for k, v in errors.items()
                         if isinstance(v, int))
    return {
        "profile": profile, "connections": connections,
        "dist": dist, "ops": attempted, "ok": ok,
        "errors": {k: v for k, v in errors.items() if v},
        "wall_s": round(wall, 3),
        # throughput and percentiles cover SERVED ops only: shed
        # requests are near-instant errors and counting them would
        # overstate capacity precisely when the server is shedding
        "ops_s": round(ok / wall, 1) if wall > 0 else 0.0,
        "p50_us": round(float(np.percentile(arr, 50)), 1),
        "p99_us": round(float(np.percentile(arr, 99)), 1),
        "hist": hist.summary(),
    }


# ------------------------------------------------------------- smoke -----

def _server_thread_count(port: int) -> int:
    from cassandra_tpu_torch.transport.server import server_thread_count
    return server_thread_count(port)


def smoke(device=None, base_dir: str | None = None) -> int:
    """Tier-2 drill: deterministic, seconds-long, exit 1 on violation.
    The server's engine runs on `device` (`cuda` by default), its data
    under `base_dir` (a directory of its own, removed after, when
    None)."""
    import shutil
    import tempfile

    from cassandra_tpu_torch.client import Cluster, serialize_params
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.transport import CQLServer

    failures: list[str] = []

    def check(cond: bool, what: str) -> None:
        print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    own = base_dir is None
    base = tempfile.mkdtemp(prefix="ctpu-stress-smoke-") if own \
        else base_dir
    try:
        engine = StorageEngine(os.path.join(base, "d"), Schema(),
                               commitlog_sync="periodic", device=device)
    except BaseException:
        if own:
            shutil.rmtree(base, ignore_errors=True)
        raise
    srv = CQLServer(engine)
    table = _client_table()
    try:
        fixed = _server_thread_count(srv.port)
        check(fixed == len(srv.event_loops) + len(srv.dispatcher.threads),
              f"server runs a fixed thread set ({fixed})")

        # 1. concurrent writes land: 8 connections, disjoint sequential
        # key ranges, then every key reads back over a fresh connection
        n_conns, per = 8, 40
        w = run_stress("127.0.0.1", srv.port, profile="write",
                       connections=n_conns, ops=n_conns * per,
                       dist="sequential", key_space=n_conns * per,
                       value_bytes=32, seed=7)
        check(w["ok"] == n_conns * per and not w["errors"],
              f"8-connection write run clean ({w['ok']} ops)")
        s = Cluster("127.0.0.1", srv.port).connect()
        rq = s.prepare(SELECT)
        missing = sum(
            1 for k in range(n_conns * per)
            if not s.execute_prepared(
                rq, serialize_params(table, ["key"], [k])).rows)
        check(missing == 0, "every written key reads back "
              f"({n_conns * per - missing}/{n_conns * per})")

        # 2. event-loop contract: 64 concurrent connections, no new
        # server threads
        r = run_stress("127.0.0.1", srv.port, profile="read",
                       connections=64, ops=256, dist="uniform",
                       key_space=n_conns * per, seed=8, setup=False)
        check(r["ok"] > 0 and not r["errors"],
              f"64-connection read run clean ({r['ok']} ops)")
        check(_server_thread_count(srv.port) == fixed,
              "thread count unchanged at 64 connections")

        # 3. overload: pinch the permit cap; the server must SHED with
        # OVERLOADED (not queue, not collapse) and stay responsive. The
        # window opens once the last run's permits are released: a
        # shrunk cap only bounds NEW admissions, so a permit still held
        # would read as a high water above the cap on a loaded host
        engine.settings.set("native_transport_max_concurrent_requests", 1)
        drained = time.monotonic() + 10.0
        while srv.permits.active and time.monotonic() < drained:
            time.sleep(0.005)
        check(srv.permits.active == 0,
              f"earlier requests released their permits "
              f"({srv.permits.active} held)")
        srv.permits.reset_high_water()
        o = run_stress("127.0.0.1", srv.port, profile="write",
                       connections=16, ops=400, dist="uniform",
                       key_space=512, value_bytes=32, seed=9,
                       setup=False)
        shed = o["errors"].get("overloaded", 0)
        check(shed > 0, f"permit exhaustion sheds OVERLOADED ({shed})")
        check(o["ok"] > 0, f"server keeps serving under overload "
              f"({o['ok']} ok)")
        check(srv.permits.high_water <= 1,
              f"in-flight never exceeded the cap "
              f"(hwm={srv.permits.high_water})")
        engine.settings.set("native_transport_max_concurrent_requests",
                            256)
        probe = s.execute_prepared(
            rq, serialize_params(table, ["key"], [1]))
        check(bool(probe.rows), "server responsive after overload run")

        # 4. per-client rate limiting, hot-reloaded on and off.
        # rate=2: a NEW connection's bucket starts with a 2-token burst
        # — exactly the worker's two PREPAREs — so every subsequent op
        # competes for a 2 ops/s refill and the shed assertion holds
        # unless a trivial SELECT takes 500 ms (vs ~1 ms measured), not
        # latency-tuned like a generous rate would be
        engine.settings.set("native_transport_rate_limit_ops", 2)
        rl = run_stress("127.0.0.1", srv.port, profile="read",
                        connections=1, ops=60,
                        dist="uniform", key_space=n_conns * per,
                        seed=10, setup=False)
        check(rl["errors"].get("rate_limited", 0) > 0,
              f"rate limiter sheds "
              f"({rl['errors'].get('rate_limited', 0)} of "
              f"{rl['ops']})")
        engine.settings.set("native_transport_rate_limit_ops", 0)
        rl2 = run_stress("127.0.0.1", srv.port, profile="read",
                         connections=1, ops=60, dist="uniform",
                         key_space=n_conns * per, seed=11, setup=False)
        check(not rl2["errors"],
              "rate limit hot-reloads off (clean run)")
        s.close()
    finally:
        srv.close()
        engine.close()
        if own:
            shutil.rmtree(base, ignore_errors=True)
    if failures:
        print(f"\nsmoke FAILED: {len(failures)} violation(s)")
        return 1
    print("\nsmoke OK")
    return 0


# ------------------------------------------------- saturation matrix -----
#
# ROADMAP item 5: the scenario matrix that certifies "millions of
# users" end to end instead of implying it. Key streams
# (zipf / sequential / uniform) crossed with the workload classes the
# engine supports but never benched under load — wide partitions,
# TTL-heavy time series on TWCS, counters, LWT, logged batches, mixed
# read-modify-write — every leg driven through the WIRE (prepared
# statements, admission control, v5 framing all on the path) against a
# 3-node RF=3 LocalCluster with hints and speculative retry live. The
# SLO layer (service/slo.py) polls during every leg: per-leg verdicts
# report p99 vs target and error-budget remaining, and the chaos leg
# (faultfs storage faults mid-run) must end with a breach-triggered
# flight-recorder bundle carrying the `slo.breach` event and the
# scenario id. bench.py's `saturation` section is run_matrix() output.

SAT_KEYSPACE = "sat"

SAT_DDL = [
    f"CREATE KEYSPACE IF NOT EXISTS {SAT_KEYSPACE} WITH replication = "
    "{'class': 'SimpleStrategy', 'replication_factor': 3}",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.kv "
    "(key int PRIMARY KEY, v blob)",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.wide "
    "(pk int, ck int, v blob, PRIMARY KEY (pk, ck))",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.ts "
    "(series int, at bigint, v blob, PRIMARY KEY (series, at)) "
    "WITH compaction = {'class': 'TimeWindowCompactionStrategy'}",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.cnt "
    "(key int PRIMARY KEY, hits counter)",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.lwt "
    "(key int PRIMARY KEY, v blob)",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.batched "
    "(key int PRIMARY KEY, v text)",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.rmw "
    "(key int PRIMARY KEY, v text)",
    f"CREATE TABLE IF NOT EXISTS {SAT_KEYSPACE}.facts "
    "(key int PRIMARY KEY, bucket int, score int)",
]


def _sat_tables():
    """Client-side schema mirrors for wire bind serialization."""
    from cassandra_tpu_torch.schema import make_table
    ks = SAT_KEYSPACE
    return {
        "kv": make_table(ks, "kv", pk=["key"],
                         cols={"key": "int", "v": "blob"}),
        "wide": make_table(ks, "wide", pk=["pk"], ck=["ck"],
                           cols={"pk": "int", "ck": "int", "v": "blob"}),
        "ts": make_table(ks, "ts", pk=["series"], ck=["at"],
                         cols={"series": "int", "at": "bigint",
                               "v": "blob"}),
        "cnt": make_table(ks, "cnt", pk=["key"],
                          cols={"key": "int", "hits": "counter"}),
        "lwt": make_table(ks, "lwt", pk=["key"],
                          cols={"key": "int", "v": "blob"}),
        "batch": make_table(ks, "batch", pk=["key"],
                            cols={"key": "int", "v": "text"}),
        "rmw": make_table(ks, "rmw", pk=["key"],
                          cols={"key": "int", "v": "text"}),
        "facts": make_table(ks, "facts", pk=["key"],
                            cols={"key": "int", "bucket": "int",
                                  "score": "int"}),
    }


def _scn_kv(sess, tables):
    from cassandra_tpu_torch.client import serialize_params
    t = tables["kv"]
    wq = sess.prepare(f"INSERT INTO {SAT_KEYSPACE}.kv (key, v) "
                      "VALUES (?, ?)")
    rq = sess.prepare(f"SELECT v FROM {SAT_KEYSPACE}.kv WHERE key = ?")

    def op(k, i, rng, is_write, worker, cl):
        if is_write:
            sess.execute_prepared(
                wq, serialize_params(t, ["key", "v"],
                                     [k, rng.bytes(32)]),
                consistency=cl)
        else:
            sess.execute_prepared(
                rq, serialize_params(t, ["key"], [k]), consistency=cl)
    return op


def _scn_wide(sess, tables):
    """Wide partitions: the key stream lands on FEW partitions (k % 32)
    with the key as clustering, so partitions grow to thousands of rows
    and reads fetch whole wide partitions."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["wide"]
    wq = sess.prepare(f"INSERT INTO {SAT_KEYSPACE}.wide (pk, ck, v) "
                      "VALUES (?, ?, ?)")
    rq = sess.prepare(f"SELECT ck FROM {SAT_KEYSPACE}.wide WHERE pk = ?")

    def op(k, i, rng, is_write, worker, cl):
        pk = k % 32
        if is_write:
            sess.execute_prepared(
                wq, serialize_params(t, ["pk", "ck", "v"],
                                     [pk, k, rng.bytes(24)]),
                consistency=cl)
        else:
            sess.execute_prepared(
                rq, serialize_params(t, ["pk"], [pk]), consistency=cl)
    return op


def _scn_timeseries(sess, tables):
    """TTL-heavy time series on TWCS: every cell written with a TTL,
    appended in time order per series; reads fetch a series."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["ts"]
    wq = sess.prepare(f"INSERT INTO {SAT_KEYSPACE}.ts (series, at, v) "
                      "VALUES (?, ?, ?) USING TTL 120")
    rq = sess.prepare(f"SELECT at FROM {SAT_KEYSPACE}.ts "
                      "WHERE series = ?")

    def op(k, i, rng, is_write, worker, cl):
        if is_write:
            # per-worker disjoint time points keep appends unique and
            # deterministic under --seed
            sess.execute_prepared(
                wq, serialize_params(
                    t, ["series", "at", "v"],
                    [int(k) % 16, worker * 1_000_000 + i,
                     rng.bytes(24)]),
                consistency=cl)
        else:
            sess.execute_prepared(
                rq, serialize_params(t, ["series"], [int(k) % 16]),
                consistency=cl)
    return op


def _scn_counter(sess, tables):
    """Counter increments route through the counter-leader path, not
    the plain write path — zipf hot keys contend on the leader lock."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["cnt"]
    wq = sess.prepare(f"UPDATE {SAT_KEYSPACE}.cnt SET hits = hits + 1 "
                      "WHERE key = ?")
    rq = sess.prepare(f"SELECT hits FROM {SAT_KEYSPACE}.cnt "
                      "WHERE key = ?")

    def op(k, i, rng, is_write, worker, cl):
        sess.execute_prepared(
            wq if is_write else rq,
            serialize_params(t, ["key"], [k]), consistency=cl)
    return op


def _scn_lwt(sess, tables):
    """LWT: IF NOT EXISTS through Paxos; under zipf most proposals lose
    the race and return applied=False — still a served op."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["lwt"]
    wq = sess.prepare(f"INSERT INTO {SAT_KEYSPACE}.lwt (key, v) "
                      "VALUES (?, ?) IF NOT EXISTS")
    rq = sess.prepare(f"SELECT v FROM {SAT_KEYSPACE}.lwt WHERE key = ?")

    def op(k, i, rng, is_write, worker, cl):
        if is_write:
            sess.execute_prepared(
                wq, serialize_params(t, ["key", "v"],
                                     [k, rng.bytes(16)]),
                consistency=cl)
        else:
            sess.execute_prepared(
                rq, serialize_params(t, ["key"], [k]), consistency=cl)
    return op


def _scn_batch(sess, tables):
    """Logged batches: 4 inserts per batch through the batchlog (the
    atomicity machinery, not just 4 writes)."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["batch"]
    rq = sess.prepare(f"SELECT v FROM {SAT_KEYSPACE}.batched "
                      "WHERE key = ?")

    def op(k, i, rng, is_write, worker, cl):
        if is_write:
            stmts = "; ".join(
                f"INSERT INTO {SAT_KEYSPACE}.batched (key, v) "
                f"VALUES ({int(k) + j}, 'w{worker}-{i}-{j}')"
                for j in range(4))
            sess.execute(f"BEGIN BATCH {stmts}; APPLY BATCH",
                         consistency=cl)
        else:
            sess.execute_prepared(
                rq, serialize_params(t, ["key"], [k]), consistency=cl)
    return op


def _scn_rmw(sess, tables):
    """Mixed read-modify-write: every op is a SELECT followed by an
    INSERT derived from what it read — one logical op, two round
    trips, the latency clients actually see for app-level RMW."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["rmw"]
    wq = sess.prepare(f"INSERT INTO {SAT_KEYSPACE}.rmw (key, v) "
                      "VALUES (?, ?)")
    rq = sess.prepare(f"SELECT v FROM {SAT_KEYSPACE}.rmw WHERE key = ?")

    def op(k, i, rng, is_write, worker, cl):
        rows = sess.execute_prepared(
            rq, serialize_params(t, ["key"], [k]), consistency=cl).rows
        n = 0
        if rows and rows[0][0]:
            try:
                n = int(str(rows[0][0]).rsplit("-", 1)[-1])
            except ValueError:
                n = 0
        sess.execute_prepared(
            wq, serialize_params(t, ["key", "v"],
                                 [k, f"w{worker}-{n + 1}"]),
            consistency=cl)
    return op


def _scn_analytical(sess, tables):
    """HTAP mix: OLTP point inserts into a fact table interleaved with
    selective ALLOW FILTERING scans and key-space aggregate folds —
    the analytical pushdown lane (zone maps + device kernels) under
    concurrent write pressure, where flushes keep minting fresh zone
    maps while scans consult them."""
    from cassandra_tpu_torch.client import serialize_params
    t = tables["facts"]
    wq = sess.prepare(
        f"INSERT INTO {SAT_KEYSPACE}.facts (key, bucket, score) "
        "VALUES (?, ?, ?)")

    def op(k, i, rng, is_write, worker, cl):
        if is_write:
            sess.execute_prepared(
                wq, serialize_params(
                    t, ["key", "bucket", "score"],
                    [k, int(k) % 64, int(rng.integers(0, 1000))]),
                consistency=cl)
        elif i % 3 == 0:
            # aggregate pushdown: folds on keys, zero rows host-side
            sess.execute(
                f"SELECT count(*) FROM {SAT_KEYSPACE}.facts "
                f"WHERE bucket = {int(k) % 64} ALLOW FILTERING",
                consistency=cl)
        else:
            # selective row pushdown (~1/64 of the table matches)
            sess.execute(
                f"SELECT key FROM {SAT_KEYSPACE}.facts "
                f"WHERE bucket = {int(k) % 64} ALLOW FILTERING",
                consistency=cl)
    return op


# scenario -> (setup factory, default write ratio). write_ratio None =
# the op is intrinsically mixed (rmw)
SCENARIOS = {
    "kv": (_scn_kv, 0.5),
    "wide": (_scn_wide, 0.5),
    "timeseries": (_scn_timeseries, 0.8),
    "counter": (_scn_counter, 0.7),
    "lwt": (_scn_lwt, 0.7),
    "batch": (_scn_batch, 0.5),
    "rmw": (_scn_rmw, None),
    "analytical": (_scn_analytical, 0.7),
}

# the default matrix: every workload class, with the kv baseline run
# under all three key streams (the full cross is available via
# --matrix-legs / run_matrix(legs=...))
DEFAULT_LEGS = [
    ("kv", "zipf"), ("kv", "uniform"), ("kv", "sequential"),
    ("wide", "uniform"), ("timeseries", "sequential"),
    ("counter", "zipf"), ("lwt", "zipf"), ("batch", "uniform"),
    ("rmw", "zipf"), ("analytical", "uniform"),
]


def _sat_worker(idx, ports, scenario, n_ops, dist, key_space,
                write_ratio, seed, workers, cl, barrier,
                results) -> None:
    from cassandra_tpu_torch.client import Cluster, DriverError
    rng = np.random.default_rng(seed * 100_000 + idx)
    lats: list = []
    errs: dict = {}
    ok = 0
    sess = None
    op = None
    try:
        # connections round-robin across the cluster's wire endpoints:
        # every node coordinates a share of the traffic
        sess = Cluster("127.0.0.1", ports[idx % len(ports)]).connect()
        op = SCENARIOS[scenario][0](sess, _sat_tables())
    except Exception as e:
        errs["connection"] = 1
        errs["connection_detail"] = f"{type(e).__name__}: {e}"
        if sess is not None:
            # a failed PREPARE must not leak the connected socket into
            # the server's client registry for the rest of the matrix
            try:
                sess.close()
            except Exception:
                pass
        sess = None
    keys = _keys(dist, n_ops, key_space, rng, idx, workers)
    ratio = SCENARIOS[scenario][1] if write_ratio is None else write_ratio
    if ratio is None:
        is_write = np.zeros(n_ops, dtype=bool)   # rmw: op is both
    else:
        is_write = rng.random(n_ops) < ratio
    barrier.wait()
    if sess is not None:
        for i in range(n_ops):
            t0 = time.perf_counter()
            try:
                op(int(keys[i]), i, rng, bool(is_write[i]), idx, cl)
                ok += 1
            except DriverError as e:
                kind = _classify(str(e))
                errs[kind] = errs.get(kind, 0) + 1
                continue
            except Exception as e:
                errs["connection"] = errs.get("connection", 0) + 1
                errs.setdefault("connection_detail",
                                f"{type(e).__name__}: {e}")
                break
            lats.append((time.perf_counter() - t0) * 1e6)
        try:
            sess.close()
        except Exception:
            pass
    results[idx] = (lats, errs, ok)


def run_scenario(ports, scenario, *, connections=6, ops=240,
                 dist="zipf", key_space=512, write_ratio=None,
                 cl="QUORUM", seed=1) -> dict:
    """One matrix leg: drive `ops` scenario operations over
    `connections` wire connections spread across `ports`. Client-side
    percentiles come from the exact latency list; the server-side view
    is the client_requests hists the SLO service watches."""
    if scenario not in SCENARIOS:
        # validate BEFORE spawning: a worker dying on the lookup after
        # the try block would strand the start barrier forever (the
        # same invariant _worker documents)
        raise ValueError(f"unknown scenario {scenario!r} "
                         f"(have: {', '.join(sorted(SCENARIOS))})")
    if dist not in ("zipf", "uniform", "sequential"):
        # _keys treats anything unrecognized as uniform — a typo'd leg
        # would silently run (and be labeled) with the wrong key stream
        raise ValueError(f"unknown key dist {dist!r} "
                         "(zipf, uniform, sequential)")
    per_conn = max(1, ops // connections)
    wall, lats, errors, ok = _spawn_and_aggregate(
        connections, _sat_worker,
        lambda i, barrier, results: (
            i, list(ports), scenario, per_conn, dist, key_space,
            write_ratio, seed, connections, cl, barrier, results))
    arr = np.array(lats) if lats else np.array([0.0])
    return {
        "scenario": scenario, "dist": dist, "cl": cl,
        "connections": connections, "ok": ok,
        "errors": {k: v for k, v in errors.items() if v},
        "wall_s": round(wall, 3),
        "ops_s": round(ok / wall, 1) if wall > 0 else 0.0,
        "p50_us": round(float(np.percentile(arr, 50)), 1),
        "p99_us": round(float(np.percentile(arr, 99)), 1),
    }


def run_matrix(base_dir: str, *, connections: int = 6,
               ops_per_leg: int = 240, key_space: int = 512,
               legs=None, chaos: bool = True, seed: int = 1,
               target_ms: float = 250.0,
               chaos_target_ms: float = 2.0,
               slo_poll_s: float = 0.05, device=None) -> dict:
    """The full saturation matrix against a 3-node RF=3 LocalCluster,
    every leg through the wire with hints and speculative retry live,
    the SLO service polling throughout. Returns the bench `saturation`
    section: per-leg throughput/latency + SLO verdicts, and the chaos
    leg's breach-triggered flight-recorder bundle. The nodes run on
    `device` (`cuda` by default)."""
    import json as json_mod

    from cassandra_tpu_torch.client import Cluster
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.service import diagnostics
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
    from cassandra_tpu_torch.transport import CQLServer
    from cassandra_tpu_torch.utils import faultfs

    legs = list(legs) if legs is not None else list(DEFAULT_LEGS)
    cluster = LocalCluster(3, base_dir, rf=3, device=device)
    servers = [CQLServer(n) for n in cluster.nodes]
    ports = [srv.port for srv in servers]
    n1 = cluster.node(1)
    # the coordinator node under observation: its engine carries the
    # SLO registry and the flight recorder the chaos bundle lands in
    settings = n1.engine.settings
    settings.set("diagnostic_events_enabled", True)
    svc = n1.engine.slo
    out: dict = {"cluster": {"nodes": 3, "rf": 3,
                             "hinted_handoff": True,
                             "speculative_retry": True},
                 "legs": {}}
    try:
        # coordinate at the CL the legs declare on the wire (QUORUM) —
        # digest reads, blocking read repair and speculative retry are
        # all on the path; write rounds keep the default 2 s budget
        # (node engines run batch commit + one inbound messaging worker,
        # so concurrent QUORUM acks genuinely queue on this box)
        from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
        for nn in cluster.nodes:
            nn.default_cl = ConsistencyLevel.QUORUM
        s = Cluster("127.0.0.1", ports[0]).connect()
        for ddl in SAT_DDL:
            s.execute(ddl)
        s.close()
        svc.start(slo_poll_s)
        read_objs = ("client_requests.read", "client_requests.read.quorum")
        write_objs = ("client_requests.write",
                      "client_requests.write.quorum")
        for scenario, dist in legs:
            leg_id = f"{scenario}:{dist}"
            # leg boundary, in poller-race-safe order: stamp the new
            # scenario FIRST, re-baseline every objective (compliant /
            # full budget — the shared decaying hists would otherwise
            # carry a previous leg's breaching state across), and only
            # THEN retarget through the hot-reload knob machinery (the
            # same path nodetool/settings vtable writes take). A poll
            # landing anywhere in this window either sees the old
            # generous targets or a fresh transition already carrying
            # this leg's id.
            svc.set_context(scenario=leg_id)
            svc.reset()
            settings.set("slo_targets",
                         {name: target_ms
                          for name in read_objs + write_objs})
            before = {v["objective"]: v["breaches"]
                      for v in svc.snapshot()}
            r = run_scenario(ports, scenario, connections=connections,
                             ops=ops_per_leg, dist=dist,
                             key_space=key_space, cl="QUORUM",
                             seed=seed)
            verdicts = {v["objective"]: v for v in svc.check()}
            slo = {}
            breached = False
            for name, v in verdicts.items():
                new = v["breaches"] - before.get(name, 0)
                if new or v["breaching"]:
                    breached = True
                slo[name] = {"p99_us": v["p99_us"],
                             "target_us": v["target_us"],
                             "breaches": new,
                             "budget_remaining_s":
                                 v["budget_remaining_s"]}
            r["slo"] = slo
            r["verdict"] = "breach" if breached else "ok"
            out["legs"][leg_id] = r
            svc.clear_context()

        # ---- hints live: a replica's storage goes dark mid-traffic;
        # QUORUM writes keep succeeding and the failed sends hint
        hints_before = dict(n1.hints.metrics)
        cluster.stop_node(3)
        hr = run_scenario(ports[:2], "kv", connections=connections,
                          ops=max(ops_per_leg // 2, 32), dist="uniform",
                          key_space=key_space, write_ratio=1.0,
                          cl="QUORUM", seed=seed + 7)
        # failed sends to the dark node expire on the reaper after the
        # write timeout — wait them out before counting hints
        time.sleep(float(n1.proxy.write_timeout) + 0.3)
        hinted = sum(nn.hints.has_hints(cluster.node(3).endpoint)
                     for nn in cluster.nodes[:2])
        cluster.restart_node(3)
        for nn in cluster.nodes[:2]:
            nn.hint_round()
        out["hints_leg"] = {
            "writes_ok": hr["ok"], "errors": hr["errors"],
            "nodes_holding_hints": int(hinted),
            "hints_written_delta":
                n1.hints.metrics.get("written", 0)
                - hints_before.get("written", 0),
            "replayed_total": n1.hints.metrics.get("replayed", 0),
        }

        # ---- elasticity leg: a 4th node bootstraps over the sessioned
        # streaming path while QUORUM write traffic stays live and the
        # SLO poller stays armed. The key stream is sequential with
        # key_space <= per-connection ops, so every key in
        # [0, elastic_space) is written at least once; zero write errors
        # plus a full QUORUM read-back of that range = zero lost writes.
        elastic_id = "elastic:kv:sequential"
        svc.set_context(scenario=elastic_id)
        svc.reset()
        settings.set("slo_targets",
                     {name: target_ms
                      for name in read_objs + write_objs})
        e_ops = max(ops_per_leg, 2 * connections)
        elastic_space = max(e_ops // 2, connections)
        eh: dict = {}

        def _elastic_traffic():
            eh["r"] = run_scenario(
                ports, "kv", connections=connections, ops=e_ops,
                dist="sequential", key_space=elastic_space,
                write_ratio=1.0, cl="QUORUM", seed=seed + 17)

        et = threading.Thread(target=_elastic_traffic, daemon=True)
        et.start()
        time.sleep(0.05)   # writes in flight before the join starts
        n4 = cluster.add_node()
        et.join()
        er = eh["r"]
        sessions_done = sum(
            1 for rec in n4.streams.sessions
            if rec.get("status") == "complete")
        rb = Cluster("127.0.0.1", ports[0]).connect()
        try:
            lost = [k for k in range(elastic_space)
                    if not rb.execute(
                        f"SELECT v FROM {SAT_KEYSPACE}.kv "
                        f"WHERE key = {k}",
                        consistency="QUORUM").rows]
        finally:
            rb.close()
        everdicts = {v["objective"]: v for v in svc.check()}
        out["elasticity_leg"] = {
            "joined_node": n4.endpoint.name,
            "writes_ok": er["ok"], "errors": er["errors"],
            "ops_s": er["ops_s"], "p99_us": er["p99_us"],
            "bootstrap_sessions_completed": sessions_done,
            "keys_checked": elastic_space, "keys_lost": len(lost),
            "slo": {name: {"p99_us": v["p99_us"],
                           "breaches": v["breaches"]}
                    for name, v in everdicts.items()},
            "verdict": "ok" if not er["errors"] and not lost
            else ("write_errors" if er["errors"] else "lost_writes"),
        }
        svc.clear_context()

        # ---- chaos leg: faultfs storage faults mid-run on node2's
        # sstables + a tightened read target — must end in a
        # breach-triggered bundle stamped with the scenario id
        if chaos:
            chaos_id = "chaos:kv:zipf"
            # preload + flush so reads cross the sstable.read
            # checkpoint on real files
            run_scenario(ports, "kv", connections=connections,
                         ops=ops_per_leg, dist="uniform",
                         key_space=key_space, write_ratio=1.0,
                         cl="QUORUM", seed=seed + 11)
            for nn in cluster.nodes:
                for cfs in list(nn.engine.stores.values()):
                    try:
                        cfs.flush()
                    except Exception:
                        pass
            from cassandra_tpu_torch.storage import chunk_cache
            chunk_cache.GLOBAL.clear()
            # node2 reacts to the injected EIO with disk_failure_policy
            # `stop`: its storage goes terminal on the first fault, so
            # for the rest of the leg it is a live-but-sick replica —
            # every read against it fails fast, the coordinator's
            # speculative retry fails over, and failed writes hint
            cluster.node(2).engine.settings.set(
                "disk_failure_policy", "stop")
            # same poller-race-safe order as the leg loop: context,
            # reset, THEN the tightened targets — a poll between the
            # tighten and the reset would otherwise publish an
            # unstamped breach whose dump dedup-suppresses the stamped
            # one this leg must end with
            svc.set_context(scenario=chaos_id)
            svc.reset()   # the chaos breach must be a fresh transition
            settings.set("slo_targets",
                         {"client_requests.read": chaos_target_ms,
                          "client_requests.read.quorum":
                              chaos_target_ms})
            spec0 = METRICS.counter("reads.speculative_retries")
            won0 = METRICS.counter("reads.speculative_retries_won")
            node2_dir = cluster.node(2).engine.data_dir
            faultfs.arm("sstable.read", "error", times=256,
                        path_substr=node2_dir)
            try:
                cr = run_scenario(ports, "kv", connections=connections,
                                  ops=ops_per_leg, dist="zipf",
                                  key_space=key_space, write_ratio=0.1,
                                  cl="QUORUM", seed=seed + 13)
            finally:
                faultfs.disarm("sstable.read")
            verdicts = {v["objective"]: v for v in svc.check()}
            breach_evs = [e for e in
                          diagnostics.GLOBAL.events("slo.breach")
                          if e.fields.get("scenario") == chaos_id]
            bundle = next((p for p in reversed(svc.recorder.dumps)
                           if "slo_breach" in p), None)
            bundle_has_event = scenario_in_bundle = False
            if bundle is not None:
                with open(bundle) as f:
                    b = json_mod.load(f)
                evs = [e for e in b.get("events", [])
                       if e.get("type") == "slo.breach"]
                bundle_has_event = bool(evs)
                scenario_in_bundle = any(
                    e.get("scenario") == chaos_id for e in evs)
            ro = verdicts.get("client_requests.read", {})
            out["chaos"] = {
                **cr, "scenario_id": chaos_id,
                "faults_injected":
                    "sstable.read EIO on node2 (times<=256)",
                "read_p99_us": ro.get("p99_us"),
                "read_target_us": ro.get("target_us"),
                "breach_events": len(breach_evs),
                "breached": bool(breach_evs),
                "budget_remaining_s": ro.get("budget_remaining_s"),
                "bundle": bundle,
                "bundle_has_breach_event": bundle_has_event,
                "scenario_id_in_bundle": scenario_in_bundle,
                "speculative_retries_fired":
                    METRICS.counter("reads.speculative_retries") - spec0,
                "speculative_retries_won":
                    METRICS.counter("reads.speculative_retries_won")
                    - won0,
            }
            svc.clear_context()
        out["slo_totals"] = {
            "checks": svc.checks,
            "breaches": METRICS.counter("slo.breaches"),
            "budget_exhausted": METRICS.counter("slo.budget_exhausted"),
            "recorder_dumps": METRICS.counter("slo.recorder_dumps"),
        }
        out["workload_classes"] = sorted(
            {scn for scn, _ in legs} | ({"kv"} if chaos else set()))
        return out
    finally:
        svc.stop()
        svc.clear_context()
        for srv in servers:
            try:
                srv.close()
            except Exception:
                pass
        cluster.shutdown()


# -------------------------------------------------------------- CLI ------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.stress")
    p.add_argument("--profile", choices=("write", "read", "mixed"),
                   default="mixed")
    p.add_argument("--connections", type=int, default=16)
    p.add_argument("--ops", type=int, default=4096)
    p.add_argument("--dist", choices=("uniform", "zipf", "sequential"),
                   default="uniform")
    p.add_argument("--key-space", type=int, default=4096)
    p.add_argument("--value-bytes", type=int, default=64)
    p.add_argument("--write-ratio", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--host", default=None,
                   help="drive an EXISTING server (with --port); "
                        "default spins one up in-process")
    p.add_argument("--port", type=int, default=9042)
    p.add_argument("--smoke", action="store_true",
                   help="tier-2 drill: deterministic seconds-long "
                        "correctness + overload + rate-limit checks")
    p.add_argument("--matrix", action="store_true",
                   help="saturation matrix: every workload class "
                        "through the wire against a 3-node RF=3 "
                        "cluster with SLO verdicts + chaos leg")
    p.add_argument("--matrix-legs", default=None,
                   help="comma-separated scenario:dist legs "
                        "(default: the DEFAULT_LEGS matrix; scenarios: "
                        + ",".join(SCENARIOS) + ")")
    p.add_argument("--no-chaos", action="store_true",
                   help="matrix: skip the fault-injection leg")
    p.add_argument("--device", default="cuda",
                   help="torch device of the in-process engines "
                        "(default cuda)")
    args = p.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    if args.matrix:
        import shutil
        import tempfile
        legs = None
        if args.matrix_legs:
            legs = [tuple(leg.split(":", 1))
                    for leg in args.matrix_legs.split(",")]
        base = tempfile.mkdtemp(prefix="ctpu-sat-")
        try:
            print(json.dumps(run_matrix(
                base, connections=args.connections,
                ops_per_leg=args.ops, key_space=args.key_space,
                legs=legs, chaos=not args.no_chaos, seed=args.seed,
                device=args.device)))
        finally:
            shutil.rmtree(base, ignore_errors=True)
        return 0

    srv = engine = None
    base = None
    if args.host is None:
        import shutil
        import tempfile

        from cassandra_tpu_torch.schema import Schema
        from cassandra_tpu_torch.storage.engine import StorageEngine
        from cassandra_tpu_torch.transport import CQLServer
        base = tempfile.mkdtemp(prefix="ctpu-stress-")
        engine = StorageEngine(os.path.join(base, "d"), Schema(),
                               commitlog_sync="periodic",
                               device=args.device)
        srv = CQLServer(engine)
        host, port = "127.0.0.1", srv.port
    else:
        host, port = args.host, args.port
    try:
        if args.profile == "read":     # preload the key space
            run_stress(host, port, profile="write",
                       connections=min(8, args.connections),
                       ops=args.key_space, dist="sequential",
                       key_space=args.key_space,
                       value_bytes=args.value_bytes, seed=args.seed)
        out = run_stress(host, port, profile=args.profile,
                         connections=args.connections, ops=args.ops,
                         dist=args.dist, key_space=args.key_space,
                         value_bytes=args.value_bytes,
                         write_ratio=args.write_ratio, seed=args.seed)
        print(json.dumps(out))
    finally:
        if srv is not None:
            srv.close()
            engine.close()
            import shutil
            shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
