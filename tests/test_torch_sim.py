"""The port's counterpart of tests/test_sim.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

Deterministic simulation (cassandra_tpu/sim): virtual time + a
seeded event queue own every message delivery, timeout, retry sleep and
background tick — so a distributed scenario REPLAYS byte-for-byte from
its seed, and interleaving space is explored by sweeping seeds.

Reference role: test/simulator (InterceptClasses.java achieves this via
bytecode interception; here it falls out of construction — one pumping
thread, scheduler-owned nondeterminism).

The scenario under test is round 4's shipped failure: a CMS metadata
commit racing a partition heal (VERDICT r4 Weak #1) — the exact class
of timing seam a deterministic scheduler exists to pin down.
"""
import pytest

from cassandra_tpu_torch.cluster.cms import MetadataUnavailable
from cassandra_tpu_torch.sim import SimCluster, simulated
from torch_tmp import tmp_path  # noqa: F401


def _cms_heal_scenario(tmp_path, seed, tag, sim=None):
    """Partition the lexically-first CMS member mid-stream, commit DDL
    on the majority DURING the partition, heal, and let anti-entropy
    converge the straggler. Returns (trace, epochs, logs). `sim` runs it
    on another package's simulator (its simulated, SimCluster, the
    keywords its SimCluster takes and its MetadataUnavailable)."""
    simulated_, cluster_, kw, unavailable = sim or (
        simulated, SimCluster, {"device": "cpu"}, MetadataUnavailable)
    with simulated_(seed) as sched:
        c = cluster_(sched, str(tmp_path / f"{tag}"), n=3, **kw)
        try:
            s1 = c.session(1)
            s1.execute("CREATE KEYSPACE ks WITH replication = "
                       "{'class': 'SimpleStrategy', "
                       "'replication_factor': 3}")
            sched.run(1.0)
            # cut node1 (a CMS member) off
            rules = c.partition(c.eps[0])
            sched.run(2.0)     # let conviction land
            # the majority commits DURING the partition
            s2 = c.session(2)
            s2.execute("CREATE TABLE ks.during (k int PRIMARY KEY)")
            # the minority must refuse (no quorum)
            with pytest.raises(unavailable):
                c.session(1).execute(
                    "CREATE TABLE ks.minority (k int PRIMARY KEY)")
            # heal: the races between liveness restoration, the healed
            # node's pull retries, gossip epoch anti-entropy and fresh
            # commits are exactly what the seed explores
            for r in rules:
                r["remaining"] = 0
            s2.execute("CREATE TABLE ks.racing (k int PRIMARY KEY)")
            sched.run(8.0)
            epochs = [n.schema_sync.epoch for n in c.nodes]
            logs = [n.schema_sync.entries_after(0) for n in c.nodes]
            return list(sched.trace), epochs, logs
        finally:
            c.shutdown()


def test_replay_is_byte_for_byte(tmp_path):
    """Same seed, same scenario, twice: the event traces — every
    delivery, timeout and tick, with virtual timestamps — must be
    IDENTICAL. This is the property that makes a seed a reproducer."""
    t1, e1, _ = _cms_heal_scenario(tmp_path, seed=1234, tag="a")
    t2, e2, _ = _cms_heal_scenario(tmp_path, seed=1234, tag="b")
    assert e1 == e2
    assert len(t1) == len(t2)
    assert t1 == t2, next(
        (i, a, b) for i, (a, b) in enumerate(zip(t1, t2)) if a != b)


def test_cms_heal_equals_jax_at_seed_1234(tmp_path, monkeypatch):
    """The port's simulator replays the JAX package's: under
    simulated(1234) the CMS-heal scenario gives the same event trace,
    epochs and logs in both packages. The simulator does not own
    uuid.uuid4 (a new table's id), so both runs draw it from one seeded
    sequence, restarted for each: the logs, ids included, are then
    equal only if both packages draw the same ids in the same order."""
    import random
    import uuid

    from cassandra_tpu.cluster.cms import MetadataUnavailable as JUnavail
    from cassandra_tpu.sim import SimCluster as JSimCluster
    from cassandra_tpu.sim import simulated as j_simulated

    def seeded_uuid4():
        rng = random.Random(99)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(
            int=rng.getrandbits(128), version=4))
    seeded_uuid4()
    j = _cms_heal_scenario(tmp_path, 1234, "jax",
                           sim=(j_simulated, JSimCluster, {}, JUnavail))
    seeded_uuid4()
    t = _cms_heal_scenario(tmp_path, 1234, "port")
    assert t[1] == j[1]
    assert len(t[0]) == len(j[0]) and t[0], (len(t[0]), len(j[0]))
    assert t[0] == j[0], next(
        (i, a, b) for i, (a, b) in enumerate(zip(t[0], j[0])) if a != b)
    assert t[2] == j[2]


def test_seeds_change_interleavings(tmp_path):
    """Different seeds must actually explore different delivery orders
    (otherwise the sweep below proves nothing)."""
    t1, _, _ = _cms_heal_scenario(tmp_path, seed=1, tag="s1")
    t2, _, _ = _cms_heal_scenario(tmp_path, seed=2, tag="s2")
    assert t1 != t2


@pytest.mark.parametrize("seed", [7, 77, 777, 7777, 77777])
def test_cms_heal_race_invariants_across_seeds(tmp_path, seed):
    """Sweep interleavings of the CMS-vs-heal race: under EVERY seed the
    cluster converges to ONE log — same epochs, identical entry
    sequences, client-acked DDL present everywhere, no fork."""
    _, epochs, logs = _cms_heal_scenario(tmp_path, seed, tag=f"s{seed}")
    assert len(set(epochs)) == 1, f"seed {seed}: epochs diverged {epochs}"
    assert all(lg == logs[0] for lg in logs[1:]), \
        f"seed {seed}: log fork"
    committed = {q for _, q, *_ in logs[0]} if logs[0] and \
        len(logs[0][0]) > 2 else set()
    texts = " ".join(str(e) for e in logs[0])
    assert "during" in texts and "racing" in texts, \
        f"seed {seed}: client-acked DDL missing from the log"


def _executor_harry_state(tmp_path, seed, tag):
    """A seeded harry op stream where flush-triggered compactions run
    through the engine's CompactionManager -> CompactionExecutor in
    SYNCHRONOUS inline mode (run_pending). Returns a fingerprint of the
    quiescent storage state: per-sstable (cells, digest) plus row count.
    """
    import os

    from cassandra_tpu_torch.tools.harry import OpGenerator

    with simulated(seed) as sched:
        c = SimCluster(sched, str(tmp_path / tag), n=3, device="cpu")
        try:
            s = c.session(1)
            node = c.node(1)
            s.execute("CREATE KEYSPACE ex WITH replication = "
                      "{'class': 'SimpleStrategy', "
                      "'replication_factor': 3}")
            s.execute("USE ex")
            s.execute("CREATE TABLE t (k int, c int, v text, w int, "
                      "st text static, m map<text,int>, "
                      "PRIMARY KEY (k, c))")
            sched.run(1.0)
            gen = OpGenerator(seed)
            eng = node.engine
            cfs = eng.store("ex", "t")
            for op in gen:
                if op.index >= 250:
                    break
                if op.kind == "advance":
                    sched.run(op.seconds)
                elif op.kind == "flush":
                    cfs.flush()
                elif op.kind == "compact":
                    # the executor's synchronous mode: deterministic,
                    # runs on this (pumping) thread
                    eng.compactions.run_pending()
                else:
                    s.execute(op.cql("t"))
            cfs.flush()
            eng.compactions.major_compaction(cfs)
            state = []
            for sst in sorted(cfs.live_sstables(),
                              key=lambda r: r.n_cells):
                with open(sst.desc.path("Digest.crc32")) as f:
                    state.append((sst.n_cells, f.read().strip()))
            nrows = len(cfs.scan_all())
            assert eng.compactions.compacting_generations(cfs) == set()
            return state, nrows
        finally:
            c.shutdown()


def test_executor_sync_mode_keeps_sim_deterministic(tmp_path):
    """Same seed, same harry stream, compactions routed through the
    CompactionExecutor's synchronous mode: the resulting storage state
    (sstable digests + logical rows) must be IDENTICAL across runs —
    the property that keeps executor-era compaction simulable."""
    s1, n1 = _executor_harry_state(tmp_path, 31337, "a")
    s2, n2 = _executor_harry_state(tmp_path, 31337, "b")
    assert s1 == s2
    assert n1 == n2
    assert s1, "no sstables produced — scenario under-exercised storage"


def test_harry_stream_under_simulation(tmp_path):
    """A seeded harry op stream against a simulated 3-node cluster with
    periodic MUTATION drops: hints replay on virtual time, and the
    quiescent state must match the model — the harry-under-simulator
    role, now with a deterministic schedule."""
    from cassandra_tpu_torch.cluster.messaging import Verb
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    from cassandra_tpu_torch.tools.harry import Model, OpGenerator, \
        check_partition
    from cassandra_tpu_torch.utils import timeutil

    with simulated(424242) as sched:
        c = SimCluster(sched, str(tmp_path), n=3, device="cpu")
        try:
            s = c.session(1)
            node = c.node(1)
            node.default_cl = ConsistencyLevel.QUORUM
            s.execute("CREATE KEYSPACE fz WITH replication = "
                      "{'class': 'SimpleStrategy', "
                      "'replication_factor': 3}")
            s.execute("USE fz")
            s.execute("CREATE TABLE t (k int, c int, v text, w int, "
                      "st text static, m map<text,int>, "
                      "PRIMARY KEY (k, c))")
            sched.run(1.0)
            gen = OpGenerator(424242)
            model = Model()
            dropping = None
            for op in gen:
                if op.index >= 400:
                    break
                if op.index % 100 == 40:
                    victim = c.nodes[1 + (op.index // 100) % 2]
                    dropping = c.filters.drop(verb=Verb.MUTATION_REQ,
                                              to=victim.endpoint)
                if op.index % 100 == 90 and dropping is not None:
                    dropping["remaining"] = 0
                    dropping = None
                if op.kind == "advance":
                    sched.run(op.seconds)
                elif op.kind == "flush":
                    node.engine.store("fz", "t").flush()
                elif op.kind == "compact":
                    from cassandra_tpu_torch.compaction.task import \
                        CompactionTask
                    cfs = node.engine.store("fz", "t")
                    inputs = list(cfs.live_sstables())
                    if len(inputs) >= 2:
                        CompactionTask(cfs, inputs,
                                       engine="numpy").execute()
                else:
                    s.execute(op.cql("t"))
                model.apply(op, now_s=timeutil.now_seconds())
            if dropping is not None:
                dropping["remaining"] = 0
            sched.run(10.0)     # hints replay on virtual time
            node.default_cl = ConsistencyLevel.ALL
            for pk in range(gen.n_pks):
                check_partition(s, model, "t", pk, 424242, 400,
                                now=timeutil.now_seconds())
        finally:
            c.shutdown()
