"""The port's counterpart of tests/test_tcm_topology.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

TCM over real processes: the ring is materialized from the epoch log,
joins are multi-step logged sequences, and a node that crashes between
start_join and finish_join resumes from its log on restart.

Reference: tcm/Startup.java:85 (initialize: first CMS node vs join),
tcm/sequences/BootstrapAndJoin.java (resumable multi-step op),
tcm/ClusterMetadata.java:81 (epoch-ordered log)."""
import json
import os
import socket
import subprocess
import sys
import time
import uuid

import pytest
from torch_tmp import tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLE_ID = uuid.uuid5(uuid.NAMESPACE_DNS, "ctpu.test.tcm")
DDL = [
    "CREATE KEYSPACE ks WITH replication = "
    "{'class': 'SimpleStrategy', 'replication_factor': 2}",
    f"CREATE TABLE ks.kv (k int PRIMARY KEY, v text) "
    f"WITH id = {TABLE_ID}",
]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _spawn(cfg_path, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "cassandra_tpu_torch.tools.noded",
         str(cfg_path)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)


@pytest.mark.slow
def test_join_crash_resume(tmp_path):
    p1_port, p2_port, obs_port = _free_ports(3)
    seed = {"name": "node1", "host": "127.0.0.1", "port": p1_port}
    cfg1 = {"name": "node1", "host": "127.0.0.1", "port": p1_port,
            "data_dir": str(tmp_path / "node1"), "auto_join": True,
            "seed_nodes": [], "gossip_interval": 0.1,
            "device": "cpu", "ddl": DDL, "vnodes": 4}
    cfg2 = {"name": "node2", "host": "127.0.0.1", "port": p2_port,
            "data_dir": str(tmp_path / "node2"), "auto_join": True,
            "seed_nodes": [seed], "gossip_interval": 0.1,
            "device": "cpu", "vnodes": 4}
    (tmp_path / "n1.json").write_text(json.dumps(cfg1))
    (tmp_path / "n2.json").write_text(json.dumps(cfg2))

    procs = []
    try:
        p1 = _spawn(tmp_path / "n1.json")
        procs.append(p1)
        line = p1.stdout.readline()
        assert line.startswith("READY"), (line, p1.stderr.read())

        # seed some data through the first node's native path: drive an
        # in-process observer that pulls the log and coordinates writes
        from cassandra_tpu_torch.cluster.node import Node
        from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
        from cassandra_tpu_torch.cluster.ring import Endpoint, Ring
        from cassandra_tpu_torch.cluster.schema_sync import SchemaSync
        from cassandra_tpu_torch.cluster.tcp import TcpTransport
        from cassandra_tpu_torch.schema import Schema

        seed_ep = Endpoint("node1", host="127.0.0.1", port=p1_port)
        obs_ring = Ring()
        obs = Node(Endpoint("observer", host="127.0.0.1", port=obs_port),
                   str(tmp_path / "observer"), Schema(), obs_ring,
                   TcpTransport(), seeds=[seed_ep], gossip_interval=0.1,
                   engine_opts={"device": "cpu"})
        obs.cluster_nodes = [obs]
        obs.schema_sync = SchemaSync(obs, str(tmp_path / "observer"))
        obs.schema_sync.pull_from_peers(timeout=10.0, peers=[seed_ep])
        assert any(e.name == "node1" for e in obs_ring.endpoints), \
            "observer did not learn node1 from the log"
        assert obs.schema.get_table("ks", "kv") is not None
        obs.gossiper.start()
        deadline = time.time() + 20
        while time.time() < deadline and not obs.is_alive(seed_ep):
            time.sleep(0.2)
        assert obs.is_alive(seed_ep), "gossip to node1 never converged"
        s = obs.session()
        s.keyspace = "ks"
        obs.default_cl = ConsistencyLevel.ONE
        for i in range(30):
            s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'v{i}')")

        # node2 crashes between start_join and the stream (staged fault)
        p2 = _spawn(tmp_path / "n2.json",
                    {"CTPU_TEST_CRASH_AFTER_START_JOIN": "1"})
        procs.append(p2)
        assert p2.wait(timeout=60) == 42, p2.stderr.read()
        # node2's log holds the start_join; node1's ring shows it pending
        log2 = (tmp_path / "node2" / "schema_log.jsonl").read_text()
        assert "start_join" in log2 and "finish_join" not in log2

        # restart WITHOUT the fault: the daemon must resume and finish
        p2b = _spawn(tmp_path / "n2.json")
        procs.append(p2b)
        deadline = time.time() + 90
        resumed = False
        while time.time() < deadline:
            line = p2b.stdout.readline()
            if not line:
                break
            if "resumed interrupted topology op" in line:
                resumed = True
            if line.startswith("READY"):
                break
        assert resumed, p2b.stderr.read()
        log2 = (tmp_path / "node2" / "schema_log.jsonl").read_text()
        assert "finish_join" in log2

        # the observer re-pulls: node2 is now a full member
        obs.schema_sync.pull_from_peers(timeout=10.0, peers=[seed_ep])
        assert any(e.name == "node2" for e in obs_ring.endpoints), \
            "node2 not promoted in the replicated ring"
        assert not obs_ring.pending
        # data is fully available with both members up (CL=ALL)
        node2_ep = next(e for e in obs_ring.endpoints
                        if e.name == "node2")
        deadline = time.time() + 20
        while time.time() < deadline and not obs.is_alive(node2_ep):
            time.sleep(0.2)
        assert obs.is_alive(node2_ep), "gossip to node2 never converged"
        obs.default_cl = ConsistencyLevel.ALL
        for i in (0, 7, 29):
            assert s.execute(f"SELECT v FROM kv WHERE k = {i}").rows == \
                [(f"v{i}",)]
        # describecluster surfaces the metadata epoch
        from cassandra_tpu_torch.tools import nodetool
        info = nodetool.describecluster(obs)
        assert info["metadata_epoch"] and info["metadata_epoch"] >= 4
        obs.shutdown()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
