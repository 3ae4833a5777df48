"""The port's daemon as a process: `python -m cassandra_tpu_torch.tools.noded
cfg.json` with "device": "cpu", a native port and an admin port, driven
through client.Cluster and admin_call; and the configs it must refuse:
without `device` it resolves `cuda` and, on a box without a card, exits
non-zero with the "no CUDA device" error; with the JAX package's
`jax_platform` key it is refused with an error that names `device`."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from cassandra_tpu_torch.client import Cluster, serialize_params
from cassandra_tpu_torch.cluster.ring import even_tokens
from cassandra_tpu_torch.service.admin import admin_call
from torch_tmp import tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DDL = ["CREATE KEYSPACE ks WITH replication = {'class': 'SimpleStrategy', "
       "'replication_factor': 1}",
       "CREATE TABLE ks.kv (k int PRIMARY KEY, v text) WITH id = "
       "5d3c9a60-0000-4000-8000-00000000d001"]


def _config(tmp_path, **extra) -> str:
    cfg = {"name": "solo", "host": "127.0.0.1", "port": 0,
           "tokens": even_tokens(1, vnodes=4)[0],
           "data_dir": str(tmp_path / "solo"), "peers": [], "seeds": [],
           "native_port": 0, "admin_port": 0, "ddl": DDL, **extra}
    path = tmp_path / f"solo-{'-'.join(sorted(extra)) or 'plain'}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _start(path: str) -> subprocess.Popen:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.Popen(
        [sys.executable, "-m", "cassandra_tpu_torch.tools.noded", path],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _stop(p: subprocess.Popen) -> None:
    if p.poll() is None:
        p.terminate()
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def test_daemon_on_cpu_serves_native_and_admin(tmp_path):
    p = _start(_config(tmp_path, device="cpu", consistency="ONE"))
    try:
        line = p.stdout.readline()
        assert line.startswith("READY"), (line, p.stderr.read())
        w = line.split()
        native, admin = int(w[w.index("NATIVE") + 1]), \
            int(w[w.index("ADMIN") + 1])
        s = Cluster("127.0.0.1", native).connect()
        from cassandra_tpu_torch.schema import make_table
        t = make_table("ks", "kv", pk=["k"], cols={"k": "int", "v": "text"})
        qid = s.prepare("INSERT INTO ks.kv (k, v) VALUES (?, ?)")
        for i in range(20):
            s.execute_prepared(qid, serialize_params(t, ["k", "v"],
                                                     [i, f"d{i}"]))
        assert admin_call("127.0.0.1", admin, "flush",
                          {"keyspace": "ks"}) == 1
        stats = admin_call("127.0.0.1", admin, "tablestats",
                           {"keyspace": "ks"})["ks.kv"]
        assert stats["sstable_count"] == 1 and stats["writes"] == 20
        assert s.execute("SELECT v FROM ks.kv WHERE k = 7").rows \
            == [("d7",)]
        assert sorted(r[0] for r in s.execute("SELECT k FROM ks.kv").rows) \
            == list(range(20))
        assert [e["status"] for e in admin_call("127.0.0.1", admin,
                                                "status")] == ["UN"]
        # the card's launch counters, which the smoke reads from each
        # daemon: on the CPU every wrapper runs its plain version
        prof = admin_call("127.0.0.1", admin, "profiler",
                          {"action": "status"})
        assert prof["launches"] and not any(prof["launches"].values())
        assert set(prof["launch_sizes"]) == set(prof["launches"])
        assert not any(prof["launch_sizes"].values())
        s.close()
    finally:
        _stop(p)
    assert p.returncode == 0, p.stderr.read()


def test_daemon_refuses_configs(tmp_path):
    cases = [({"jax_platform": "cpu"}, "device"),
             ({"device": "cpu", "jax_platform": "cpu"}, "device"),
             ({"device": "cpu", "consistency": "SOME"}, "consistency")]
    if not torch.cuda.is_available():
        cases.append(({}, "no CUDA device"))
    for extra, needle in cases:
        p = _start(_config(tmp_path, **extra))
        try:
            out, err = p.communicate(timeout=120)
        finally:
            _stop(p)
        assert p.returncode != 0, (extra, out)
        assert not out.startswith("READY"), extra
        assert needle in err, (extra, err[-500:])
        # refused before the engine opened its data directory
        assert not (tmp_path / "solo").exists(), extra


def test_build_node_device_and_consistency(tmp_path):
    """build_node hands the resolved device to the engine and the
    configured level to the node; without `device` and without a card
    it raises."""
    from cassandra_tpu_torch.tools import noded
    cfg = json.loads(open(_config(tmp_path, device="cpu",
                                  consistency="quorum")).read())
    node, transport = noded.build_node(cfg)
    try:
        assert node.engine.device.type == "cpu"
        assert node.default_cl == "QUORUM"
    finally:
        node.shutdown()
    if not torch.cuda.is_available():
        cfg.pop("device")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            noded.build_node(cfg)


def _alive(pid: int) -> bool:
    """Whether `pid` runs: not gone, and not a zombie left unreaped."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return False
    return state not in ("Z", "X")


def test_smoke_daemons_die_with_their_process(tmp_path):
    """chip_smoke.py's phase 10 daemons (device "cpu" here) die when the
    process that started them is killed with SIGKILL, which skips its
    `finally`: as the smoke's stop_tools ends a late tools process."""
    import signal
    import time
    script = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke as cs\n"
        "cs.DEVICE = 'cpu'\n"
        f"ds = cs.start_daemons({str(tmp_path)!r}, n=2)\n"
        "deadline = time.monotonic() + 120\n"
        "for d in ds:\n"
        "    d.ready(deadline)\n"
        "print(json.dumps([d.proc.pid for d in ds]), flush=True)\n"
        "time.sleep(600)\n")
    parent = subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    pids: list = []
    try:
        line = parent.stdout.readline()
        assert line.startswith("["), (line, parent.stderr.read()[-2000:])
        pids = json.loads(line)
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        parent.send_signal(signal.SIGKILL)
        parent.wait(timeout=15)
        deadline = time.monotonic() + 30
        while any(_alive(p) for p in pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(_alive(p) for p in pids), "a daemon outlived it"
    finally:
        if parent.poll() is None:
            parent.kill()
            parent.wait()
        for p in pids:
            if _alive(p):
                os.kill(p, signal.SIGKILL)
