"""CI check (tier-2, like chaos_storage.py): streaming chaos drill —
a deterministic seeded dataset moves between in-process nodes while
faultfs chokes the stream checkpoints, and every session must end in
the state the robustness contract mandates.

Drills, in order, each asserting the policy-mandated end state:

  1. latency on stream.net: the transfer completes anyway and the
     landed components are sha256-identical to a clean control run;
  2. disconnect on stream.net (chunks dropped on the floor): the
     sender's retransmit window recovers, the session completes, and
     the digests still match the control;
  3. EIO at the stream.land TOC write (the commit point): the session
     fails, ZERO new sstables become visible, and the restart sweep
     (lifecycle.replay_directory) removes the orphaned components;
  4. sender killed mid-session: the receiver's durable watermark
     survives, resume_incomplete() re-requests only the tail, and the
     result is byte-identical to the control;
  5. bootstrap under latency chaos: a 4th node joins while stream.net
     is degraded; the join completes and a CL=ALL read of every seeded
     row still succeeds afterwards.

Everything is disarmed at exit — a final clean transfer must again be
digest-identical to the control (zero divergence once disarmed).

The cluster's nodes run on `device` (`cuda` by default, which raises
without a card; `cpu` runs the kernels' plain PyTorch versions).

    python -m cassandra_tpu_torch.scripts.chaos_streaming [--device cpu]

Exit 0 = clean; exit 1 prints each violation.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import threading
import time


N_ROWS = 200
MIN_TOKEN = -(1 << 63)
MAX_TOKEN = (1 << 63) - 1


def _gen_hashes(cfs, gens):
    """{component: sha256} for the given generations — component
    contents never embed the generation, so two landings of the same
    source compare equal regardless of local gen numbers."""
    gens = set(int(g) for g in gens)
    out = {}
    for fn in sorted(os.listdir(cfs.directory)):
        parts = fn.split("-", 2)
        if len(parts) == 3 and parts[1].isdigit() \
                and int(parts[1]) in gens:
            with open(os.path.join(cfs.directory, fn), "rb") as f:
                out[parts[2]] = hashlib.sha256(f.read()).hexdigest()
    return out


def _acked_count(node):
    import json
    base = os.path.join(node.engine.data_dir, "streaming")
    n = 0
    if os.path.isdir(base):
        for sid in os.listdir(base):
            mpath = os.path.join(base, sid, "meta.json")
            apath = os.path.join(base, sid, "acked.log")
            if os.path.exists(mpath) and os.path.exists(apath):
                with open(mpath) as f:
                    if json.load(f).get("role") != "receiver":
                        continue
                with open(apath) as f:
                    n += sum(1 for _ in f)
    return n


# small chunks so every drill spans many STREAM_CHUNK round trips
DRILL_STREAMING = {"CHUNK_SIZE": 1024, "WINDOW": 4,
                   "RETRANSMIT_BASE": 0.05}


def run_drill(base_dir: str, device=None) -> list[str]:
    """Run every drill; returns human-readable violations (empty=pass).
    The streaming settings the drills shrink are put back, and every
    fault point disarmed, on the way out, however it ends."""
    from cassandra_tpu_torch.cluster.stream_session import StreamManager
    from cassandra_tpu_torch.utils import faultfs

    prev = {k: getattr(StreamManager, k) for k in DRILL_STREAMING}
    for k, v in DRILL_STREAMING.items():
        setattr(StreamManager, k, v)
    try:
        return _drills(base_dir, device)
    finally:
        faultfs.disarm()
        for k, v in prev.items():
            setattr(StreamManager, k, v)


def _drills(base_dir: str, device) -> list[str]:
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    from cassandra_tpu_torch.utils import faultfs

    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    c = LocalCluster(3, base_dir, rf=3, device=device)
    try:
        for nd in c.nodes:
            nd.proxy.timeout = 5.0
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        c.node(1).default_cl = ConsistencyLevel.ALL
        for i in range(N_ROWS):
            s.execute(f"INSERT INTO kv (k, v) "
                      f"VALUES ({i}, '{'x' * 64}{i}')")
        n1, n2, n3 = c.node(1), c.node(2), c.node(3)
        n1.engine.store("ks", "kv").flush()

        def full_stream(dst, timeout=60.0):
            return dst.streams.stream_range(
                n1.endpoint, "ks", "kv", MIN_TOKEN, MAX_TOKEN,
                timeout=timeout)

        # control: a clean transfer's component digests
        ctl = full_stream(n2)
        control = _gen_hashes(n2.engine.store("ks", "kv"), ctl["gens"])
        need(control and "TOC.txt" in control,
             "control transfer landed nothing")

        # ------------------------------------------ drill 1: latency
        faultfs.arm("stream.net", "latency", delay_s=0.01)
        res = full_stream(n3)
        fired = faultfs.GLOBAL.fires("stream.net")
        faultfs.disarm()
        need(fired > 0, "latency drill never crossed the fault point")
        got = _gen_hashes(n3.engine.store("ks", "kv"), res["gens"])
        need(got == control,
             "latency drill: landed digests diverge from control")

        # --------------------------------------- drill 2: disconnect
        faultfs.arm("stream.net", "disconnect", times=4)
        res = full_stream(n3)
        fired = faultfs.GLOBAL.fires("stream.net")
        faultfs.disarm()
        need(fired > 0, "disconnect drill never dropped a chunk")
        got = _gen_hashes(n3.engine.store("ks", "kv"), res["gens"])
        need(got == control,
             "disconnect drill: retransmitted digests diverge")

        # ------------------------------ drill 3: EIO at the TOC write
        cfs3 = n3.engine.store("ks", "kv")
        before = {t.desc.generation for t in cfs3.live_sstables()}
        faultfs.arm("stream.land", "error", path_substr="TOC.txt")
        try:
            full_stream(n3, timeout=15.0)
            need(False, "EIO-at-TOC transfer did not fail")
        except Exception:
            pass
        faultfs.disarm()
        cfs3.reload_sstables()
        need({t.desc.generation
              for t in cfs3.live_sstables()} == before,
             "failed landing leaked a visible sstable (TOC written?)")
        from cassandra_tpu_torch.storage.lifecycle import replay_directory
        replay_directory(cfs3.directory)
        orphans = [fn for fn in os.listdir(cfs3.directory)
                   if len(p := fn.split("-", 2)) == 3
                   and p[1].isdigit() and int(p[1]) not in before]
        need(orphans == [],
             f"restart sweep left orphan components: {orphans}")

        # --------------------------- drill 4: kill sender, then resume
        faultfs.arm("stream.net", "latency", delay_s=0.02)
        holder: dict = {}

        def bg():
            try:
                holder["res"] = full_stream(n3, timeout=3.0)
            except Exception as e:
                holder["err"] = e

        th = threading.Thread(target=bg, daemon=True)
        th.start()
        deadline = time.monotonic() + 10
        while _acked_count(n3) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        need(_acked_count(n3) >= 3, "no watermark before the kill")
        c.stop_node(1)
        faultfs.disarm()
        th.join(timeout=15)
        need("err" in holder, "session survived a dead sender?")
        c.restart_node(1)
        # drill 3's failed session stayed durable (by design), so the
        # sweep picks BOTH it and the killed-sender session up here
        resumed = n3.streams.resume_incomplete(timeout=60.0)
        need(resumed and all("error" not in r for r in resumed),
             f"resume after sender kill failed: {resumed}")
        for r in resumed:
            got = _gen_hashes(cfs3, r.get("gens", []))
            need(got == control,
                 "resumed transfer: digests diverge from control")

        # --------------------- drill 5: bootstrap under latency chaos
        faultfs.arm("stream.net", "latency", delay_s=0.005)
        c.add_node()
        faultfs.disarm()
        s1 = c.session(1)
        s1.keyspace = "ks"
        c.node(1).default_cl = ConsistencyLevel.ALL
        missing = [i for i in range(N_ROWS)
                   if not s1.execute(
                       f"SELECT v FROM kv WHERE k = {i}").rows]
        need(missing == [],
             f"rows unreadable at ALL after chaotic join: {missing[:5]}")

        # ------------------------- disarmed re-run: zero divergence
        res = full_stream(n3)
        got = _gen_hashes(cfs3, res["gens"])
        need(got == control,
             "disarmed re-run diverges from control")
        need(not faultfs.GLOBAL.active,
             "fault points left armed at drill end")
    finally:
        c.shutdown()
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.chaos_streaming")
    p.add_argument("--device", default="cuda",
                   help="torch device of the nodes (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ctpu-chaos-stream-") as d:
        errs = run_drill(d, device=args.device)
    for msg in errs:
        print(msg, file=sys.stderr)
    if errs:
        print(f"FAIL: {len(errs)} violation(s)", file=sys.stderr)
        return 1
    print("streaming chaos drill: all sessions held (latency + "
          "disconnect retransmit, TOC-gated atomic landing + orphan "
          "sweep, kill/resume byte identity, chaotic bootstrap)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
