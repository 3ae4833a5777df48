"""cassandra-stress analog: write/read/mixed workloads against a Session.

Reference counterpart: tools/stress/ (Stress.java; `write n=1000000`,
`read n=...`) and CompactionStress.java (offline write + compact — that
path is bench.py). Usable as a library (tests/benchmarks) or CLI:
`python -m cassandra_tpu_torch.tools.stress write -n 100000 [--device
cpu]` (the engine's kernels run on `cuda` unless `--device` says
otherwise).
"""
from __future__ import annotations

import argparse
import json
import random
import time


DDL = ("CREATE TABLE IF NOT EXISTS stress.standard1 "
       "(key int PRIMARY KEY, c0 blob, c1 blob, c2 blob, c3 blob)")


def setup(session):
    session.execute("CREATE KEYSPACE IF NOT EXISTS stress WITH replication "
                    "= {'class': 'SimpleStrategy', 'replication_factor': 1}")
    try:
        session.execute(DDL)
    except Exception:
        pass


def write(session, n: int, value_bytes: int = 34, seed: int = 1) -> dict:
    setup(session)
    rng = random.Random(seed)
    qid = session.prepare("INSERT INTO stress.standard1 "
                          "(key, c0, c1, c2, c3) VALUES (?, ?, ?, ?, ?)")
    t0 = time.time()
    for i in range(n):
        vals = [rng.randbytes(value_bytes) for _ in range(4)]
        session.execute_prepared(qid, (i, *vals))
    dt = time.time() - t0
    return {"op": "write", "n": n, "seconds": round(dt, 3),
            "ops_s": round(n / dt, 1)}


def read(session, n: int, keys: int | None = None, seed: int = 2) -> dict:
    rng = random.Random(seed)
    keys = keys or n
    qid = session.prepare("SELECT * FROM stress.standard1 WHERE key = ?")
    t0 = time.time()
    hits = 0
    for _ in range(n):
        rs = session.execute_prepared(qid, (rng.randrange(keys),))
        hits += bool(rs.rows)
    dt = time.time() - t0
    return {"op": "read", "n": n, "hits": hits, "seconds": round(dt, 3),
            "ops_s": round(n / dt, 1)}


def mixed(session, n: int, write_ratio: float = 0.5, seed: int = 3) -> dict:
    setup(session)
    rng = random.Random(seed)
    wq = session.prepare("INSERT INTO stress.standard1 "
                         "(key, c0, c1, c2, c3) VALUES (?, ?, ?, ?, ?)")
    rq = session.prepare("SELECT * FROM stress.standard1 WHERE key = ?")
    t0 = time.time()
    for i in range(n):
        if rng.random() < write_ratio:
            session.execute_prepared(
                wq, (rng.randrange(n),
                     *[rng.randbytes(34) for _ in range(4)]))
        else:
            session.execute_prepared(rq, (rng.randrange(n),))
    dt = time.time() - t0
    return {"op": "mixed", "n": n, "seconds": round(dt, 3),
            "ops_s": round(n / dt, 1)}


def main(argv=None):
    p = argparse.ArgumentParser(prog="stress")
    p.add_argument("op", choices=["write", "read", "mixed"])
    p.add_argument("-n", type=int, default=10000)
    p.add_argument("--data", default=None)
    p.add_argument("--device", help="the torch device of the engine's "
                   "kernels (default cuda)")
    args = p.parse_args(argv)

    import tempfile

    from ..cql import Session
    from ..schema import Schema
    from ..storage.engine import StorageEngine
    data = args.data or tempfile.mkdtemp(prefix="ctpu-stress-")
    engine = StorageEngine(data, Schema(), device=args.device)
    session = Session(engine)
    if args.op == "read":
        print(json.dumps(write(session, args.n)))  # preload
    print(json.dumps(globals()[args.op](session, args.n)))
    engine.close()


if __name__ == "__main__":
    main()
