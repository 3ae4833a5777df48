"""The port's counterpart of tests/test_streaming.py: the same assertions on
cassandra_tpu_torch, every engine on the CPU (device="cpu").

Sessioned streaming under fire: resume byte-identity after sender
and receiver death, atomic (TOC-last) landings, throttle + dispatch
liveness, repair sync over a flaky wire, and the legacy-path cap."""
import hashlib
import json
import os
import threading
import time

import pytest

from cassandra_tpu_torch.cluster.node import LocalCluster
from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
from cassandra_tpu_torch.cluster.stream_session import (MIN_TOKEN,
                                                        StreamManager,
                                                        batch_from_bytes,
                                                        batch_to_bytes)
from cassandra_tpu_torch.cluster.streaming import StreamPayloadTooLarge
from cassandra_tpu_torch.utils import faultfs
from torch_tmp import tmp_path  # noqa: F401

MAX_TOKEN = (1 << 63) - 1


# ------------------------------------------------------------- helpers --

def _mk_cluster(tmp_path, n=3, rf=3, rows=250):
    c = LocalCluster(n, str(tmp_path), rf=rf, device="cpu")
    for nd in c.nodes:
        nd.proxy.timeout = 2.0
    s = c.session(1)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              f"{{'class': 'SimpleStrategy', 'replication_factor': {rf}}}")
    s.execute("USE ks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
    c.node(1).default_cl = ConsistencyLevel.ALL
    for i in range(rows):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, '{'x' * 60}{i}')")
    c.node(1).engine.store("ks", "kv").flush()
    return c


def _receiver_dirs(node):
    base = os.path.join(node.engine.data_dir, "streaming")
    out = []
    if os.path.isdir(base):
        for sid in sorted(os.listdir(base)):
            mpath = os.path.join(base, sid, "meta.json")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    if json.load(f).get("role") == "receiver":
                        out.append(os.path.join(base, sid))
    return out


def _acked_count(node):
    n = 0
    for d in _receiver_dirs(node):
        p = os.path.join(d, "acked.log")
        if os.path.exists(p):
            with open(p) as f:
                n += sum(1 for _ in f)
    return n


def _gen_hashes(cfs, gens):
    """{component name: sha256 of contents} for the given generations.
    Contents never embed the generation, so two landings of the same
    source sstable hash identically regardless of local gen."""
    gens = set(gens)
    out = {}
    for fn in sorted(os.listdir(cfs.directory)):
        parts = fn.split("-", 2)
        if len(parts) == 3 and parts[1].isdigit() \
                and int(parts[1]) in gens:
            with open(os.path.join(cfs.directory, fn), "rb") as f:
                out[parts[2]] = hashlib.sha256(f.read()).hexdigest()
    return out


def _small_chunks(monkeypatch, chunk=512, window=4):
    monkeypatch.setattr(StreamManager, "CHUNK_SIZE", chunk)
    monkeypatch.setattr(StreamManager, "WINDOW", window)


def _stream_in_thread(node, owner, timeout):
    holder = {}

    def run():
        try:
            holder["res"] = node.streams.stream_range(
                owner, "ks", "kv", MIN_TOKEN, MAX_TOKEN, timeout=timeout)
        except Exception as e:
            holder["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, holder


# ------------------------------------------------- resume byte identity --

def test_resume_after_sender_kill_byte_identity(tmp_path, monkeypatch):
    """Kill the SENDER mid-session: the receiver's journaled watermark
    survives, resume re-requests only the tail, and the landed
    components are sha256-identical to an unkilled transfer."""
    _small_chunks(monkeypatch)
    c = _mk_cluster(tmp_path)
    try:
        n1, n2, n3 = c.node(1), c.node(2), c.node(3)
        control = n2.streams.stream_range(
            n1.endpoint, "ks", "kv", MIN_TOKEN, MAX_TOKEN, timeout=30.0)
        assert control["files"] > 0
        want = _gen_hashes(n2.engine.store("ks", "kv"), control["gens"])
        assert want and "TOC.txt" in want

        faultfs.arm("stream.net", "latency", delay_s=0.03)
        try:
            th, holder = _stream_in_thread(n3, n1.endpoint, timeout=2.5)
            deadline = time.monotonic() + 10
            while _acked_count(n3) < 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert _acked_count(n3) >= 3, "no chunks landed before kill"
            c.stop_node(1)   # sender dies mid-session
        finally:
            faultfs.disarm()
        th.join(timeout=15)
        assert "err" in holder, "session should fail with the sender dead"
        # durable state survived the failure: manifest + watermark
        assert _receiver_dirs(n3), "receiver session state must persist"
        watermark = _acked_count(n3)
        assert watermark >= 3

        c.restart_node(1)
        res = n3.streams.resume_incomplete(timeout=30.0)
        assert len(res) == 1 and "error" not in res[0], res
        got = _gen_hashes(n3.engine.store("ks", "kv"), res[0]["gens"])
        assert got == want
        assert _receiver_dirs(n3) == []   # completion sweeps the state
    finally:
        c.shutdown()


def test_resume_after_receiver_kill_byte_identity(tmp_path, monkeypatch):
    """Kill the RECEIVER mid-session, restart it, resume: only the
    missing tail is re-requested and the result is byte-identical."""
    _small_chunks(monkeypatch)
    c = _mk_cluster(tmp_path)
    try:
        n1, n2, n3 = c.node(1), c.node(2), c.node(3)
        control = n2.streams.stream_range(
            n1.endpoint, "ks", "kv", MIN_TOKEN, MAX_TOKEN, timeout=30.0)
        want = _gen_hashes(n2.engine.store("ks", "kv"), control["gens"])

        faultfs.arm("stream.net", "latency", delay_s=0.03)
        try:
            th, holder = _stream_in_thread(n3, n1.endpoint, timeout=20.0)
            deadline = time.monotonic() + 10
            while _acked_count(n3) < 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert _acked_count(n3) >= 3
            c.stop_node(3)   # receiver dies mid-session
        finally:
            faultfs.disarm()
        th.join(timeout=15)
        assert "err" in holder
        watermark = _acked_count(n3)
        assert watermark >= 3

        c.restart_node(3)
        res = n3.streams.resume_incomplete(timeout=30.0)
        assert len(res) == 1 and "error" not in res[0], res
        got = _gen_hashes(n3.engine.store("ks", "kv"), res[0]["gens"])
        assert got == want
        assert _receiver_dirs(n3) == []
    finally:
        c.shutdown()


# --------------------------------------------------- atomic commit point --

def test_crash_before_toc_leaves_no_visible_sstable(tmp_path):
    """A landing killed at the TOC write leaves ZERO visible sstables
    (discover requires the TOC) and replay_directory sweeps the
    orphaned components at restart."""
    from cassandra_tpu_torch.storage.lifecycle import replay_directory
    c = _mk_cluster(tmp_path, n=2, rf=2, rows=60)
    try:
        n1, n2 = c.node(1), c.node(2)
        cfs = n2.engine.store("ks", "kv")
        cfs.flush()
        before = {s.desc.generation for s in cfs.live_sstables()}
        with faultfs.inject("stream.land", "error",
                            path_substr="TOC.txt"):
            with pytest.raises(Exception):
                n2.streams.stream_range(n1.endpoint, "ks", "kv",
                                        MIN_TOKEN, MAX_TOKEN,
                                        timeout=10.0)
        cfs.reload_sstables()
        assert {s.desc.generation
                for s in cfs.live_sstables()} == before
        # the orphaned TOC-less components ARE on disk
        orphans = [fn for fn in os.listdir(cfs.directory)
                   if (p := fn.split("-", 2))
                   and len(p) == 3 and p[1].isdigit()
                   and int(p[1]) not in before]
        assert orphans, "crashed landing should leave orphan components"
        replay_directory(cfs.directory)   # the restart sweep
        left = [fn for fn in os.listdir(cfs.directory)
                if (p := fn.split("-", 2))
                and len(p) == 3 and p[1].isdigit()
                and int(p[1]) not in before]
        assert left == []
        cfs.reload_sstables()
        assert {s.desc.generation
                for s in cfs.live_sstables()} == before
    finally:
        c.shutdown()


# --------------------------------------- concurrency + dispatch liveness --

def test_concurrent_stream_and_quorum_writes_lose_nothing(tmp_path,
                                                          monkeypatch):
    """Bootstrap a 4th node while QUORUM writes hammer the same table:
    every write acknowledged during the join must be readable at QUORUM
    after it."""
    _small_chunks(monkeypatch, chunk=1024)
    c = _mk_cluster(tmp_path, rows=300)
    try:
        n2 = c.node(2)
        n2.default_cl = ConsistencyLevel.QUORUM
        s2 = c.session(2)
        s2.keyspace = "ks"
        written, errors = [], []
        stop = threading.Event()

        def writer():
            i = 10_000
            while not stop.is_set():
                try:
                    s2.execute(
                        f"INSERT INTO kv (k, v) VALUES ({i}, 'w{i}')")
                    written.append(i)
                    i += 1
                except Exception as e:   # a lost ack IS the failure
                    errors.append(e)
                    return

        faultfs.arm("stream.net", "latency", delay_s=0.005)
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            time.sleep(0.1)   # writes in flight before the join starts
            c.add_node()
        finally:
            stop.set()
            t.join(timeout=10)
            faultfs.disarm()
        assert not errors, errors
        assert written, "writer made no progress during the join"
        s1 = c.session(1)
        s1.keyspace = "ks"
        c.node(1).default_cl = ConsistencyLevel.QUORUM
        found = 0
        for i in range(0, len(written), 50):   # stay under the IN guardrail
            ks = ", ".join(str(k) for k in written[i:i + 50])
            found += len(
                s1.execute(f"SELECT k FROM kv WHERE k IN ({ks})").rows)
        assert found == len(written)
    finally:
        c.shutdown()


def test_gossip_and_reads_live_during_throttled_transfer(tmp_path,
                                                         monkeypatch):
    """A throttled bulk transfer must not stall the shared dispatch
    worker: reads and liveness probes stay responsive mid-stream, and
    the throughput knob hot-reloads to let the transfer finish."""
    _small_chunks(monkeypatch, chunk=2048)
    c = _mk_cluster(tmp_path, n=2, rf=2, rows=300)
    try:
        n1, n2 = c.node(1), c.node(2)
        # ~2 KiB/s: the transfer crawls until the knob is raised
        n1.engine.settings.set("stream_throughput_outbound", 0.002)
        th, holder = _stream_in_thread(n2, n1.endpoint, timeout=60.0)
        deadline = time.monotonic() + 10
        while not n2.streams.progress() and time.monotonic() < deadline:
            time.sleep(0.01)
        live = n2.streams.progress()
        assert live and live[0]["status"] in ("init", "requesting",
                                              "streaming")
        # the vtable surfaces the same live rows
        s2 = c.session(2)
        rows = s2.execute(
            "SELECT id, status FROM system_views.streams").dicts()
        assert rows and rows[0]["id"] == live[0]["sid"]
        s1 = c.session(1)
        s1.keyspace = "ks"
        for _ in range(3):   # dispatch stays live DURING the transfer
            t0 = time.monotonic()
            assert s1.execute("SELECT v FROM kv WHERE k = 1").rows
            assert time.monotonic() - t0 < 1.0
        assert n1.is_alive(n2.endpoint) and n2.is_alive(n1.endpoint)
        # hot-reload: the knob listener feeds the live token bucket
        n1.engine.settings.set("stream_throughput_outbound", 500.0)
        th.join(timeout=30)
        assert "res" in holder, holder.get("err")
        assert holder["res"]["files"] > 0
    finally:
        c.shutdown()


# ----------------------------------------------------- repair + legacy --

def test_repair_sync_converges_over_disconnect(tmp_path, monkeypatch):
    """A faultfs stream.net disconnect drops sync chunks on the floor;
    retransmit recovers and repair still converges."""
    import glob
    monkeypatch.setattr(StreamManager, "RETRANSMIT_BASE", 0.05)
    c = LocalCluster(3, str(tmp_path), rf=3, device="cpu")
    try:
        for nd in c.nodes:
            nd.proxy.timeout = 5.0
        n1 = c.node(1)
        n1.default_cl = ConsistencyLevel.ONE
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        victim = c.nodes[2]
        from cassandra_tpu_torch.cluster.messaging import Verb
        c.filters.drop(verb=Verb.MUTATION_REQ, to=victim.endpoint)
        for i in range(100, 112):
            s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'r{i}')")
        c.filters.clear()
        for nd in c.nodes:
            for f in glob.glob(os.path.join(nd.hints.directory, "*")):
                os.remove(f)
        t = c.schema.get_table("ks", "kv")
        missing = [i for i in range(100, 112)
                   if len(victim.engine.store("ks", "kv").read_partition(
                       t.columns["k"].cql_type.serialize(i))) == 0]
        assert missing, "victim should have missed writes"
        faultfs.arm("stream.net", "disconnect", times=2)
        try:
            stats = n1.repair.repair_table("ks", "kv")
        finally:
            fired = faultfs.GLOBAL.fires("stream.net")
            faultfs.disarm()
        assert stats["ranges_synced"] > 0
        assert fired > 0, "repair sync never crossed the armed fault"
        deadline = time.time() + 5
        store = victim.engine.store("ks", "kv")
        while time.time() < deadline and any(
                len(store.read_partition(
                    t.columns["k"].cql_type.serialize(i))) == 0
                for i in missing):
            time.sleep(0.1)
        assert all(len(store.read_partition(
            t.columns["k"].cql_type.serialize(i))) > 0 for i in missing)
    finally:
        c.shutdown()


def test_legacy_single_message_path_is_capped(tmp_path, monkeypatch):
    """An oversized legacy STREAM_REQ fails typed instead of
    materializing an unbounded payload on the dispatch worker."""
    from cassandra_tpu_torch.cluster.streaming import StreamService
    c = _mk_cluster(tmp_path, n=2, rf=2, rows=80)
    try:
        n1, n2 = c.node(1), c.node(2)
        monkeypatch.setattr(StreamService, "LEGACY_MAX_BYTES", 64)
        with pytest.raises(StreamPayloadTooLarge):
            n2.streams.fetch_range(n1.endpoint, "ks", "kv",
                                   MIN_TOKEN, MAX_TOKEN, 5.0)
        # in-range data under the cap still flows (the compat contract)
        monkeypatch.setattr(StreamService, "LEGACY_MAX_BYTES",
                            64 * 1024 * 1024)
        files, leftover = n2.streams.fetch_range(
            n1.endpoint, "ks", "kv", MIN_TOKEN, MAX_TOKEN, 5.0)
        assert files
    finally:
        c.shutdown()


def test_batch_bytes_roundtrip(tmp_path):
    """The chunked wire codec round-trips a CellBatch exactly."""
    c = _mk_cluster(tmp_path, n=2, rf=2, rows=40)
    try:
        batch = c.node(1).engine.store("ks", "kv").scan_all()
        assert len(batch) > 0
        back = batch_from_bytes(batch_to_bytes(batch))
        assert len(back) == len(batch)
        assert back.sorted == batch.sorted
        assert back.pk_map == batch.pk_map
        import numpy as np
        for fld in ("lanes", "ts", "ldt", "ttl", "flags", "off",
                    "val_start", "payload"):
            assert np.array_equal(getattr(back, fld), getattr(batch, fld))
    finally:
        c.shutdown()


def test_netstats_and_metrics_surface(tmp_path):
    """nodetool netstats exposes live + terminal sessions; streaming.*
    counters move."""
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
    from cassandra_tpu_torch.tools import nodetool
    c = _mk_cluster(tmp_path, n=2, rf=2, rows=40)
    try:
        n1, n2 = c.node(1), c.node(2)
        before = METRICS.snapshot().get("streaming.sessions_completed", 0)
        res = n2.streams.stream_range(n1.endpoint, "ks", "kv",
                                      MIN_TOKEN, MAX_TOKEN, timeout=30.0)
        assert res["files"] > 0
        st = nodetool.netstats(n2)
        assert "streams" in st and isinstance(st["streams"], list)
        assert any(s["status"] == "complete" for s in st["streaming"])
        snap = METRICS.snapshot()
        assert snap.get("streaming.sessions_completed", 0) > before
        assert snap.get("streaming.chunks_sent", 0) > 0
    finally:
        c.shutdown()
