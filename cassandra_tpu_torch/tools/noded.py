"""noded — the standalone node daemon (CassandraDaemon role).

Reference counterpart: service/CassandraDaemon.java (process entrypoint:
load config, init storage, join the ring, serve) driven by a JSON config
standing in for cassandra.yaml.

Config:
{
  "name": "node2", "host": "127.0.0.1", "port": 9502,
  "dc": "dc1", "rack": "rack1",
  "data_dir": "/var/lib/ctpu/node2",
  "tokens": [ ... this node's tokens ... ],
  "peers": [{"name": "node1", "host": "...", "port": 9501,
             "dc": "dc1", "rack": "rack1", "tokens": [...]}, ...],
  "seeds": ["node1"],
  "gossip_interval": 0.2,
  "server_tls":  {"certfile": ..., "keyfile": ..., "cafile": ...},
  "native_tls":  {"certfile": ..., "keyfile": ..., "cafile": ...,
                  "require_client_auth": false},
  "ddl": ["CREATE KEYSPACE ks WITH ...",
          "CREATE TABLE ks.t (...) WITH id = <uuid>"],
  "device": "cuda",
  "consistency": "QUORUM"
}

`device` is the torch device of the node's engine (its compaction and
vector-search kernels): `cuda` when unset, so without a card the daemon
refuses to start; "cpu" runs the kernels' plain PyTorch versions. A
config that still carries the JAX package's `jax_platform` key is
refused, so it never lands on a device the operator did not choose.
`consistency` is the level the node coordinates its requests at
(Node.default_cl; ONE when unset): the native protocol's per-request
level only tags the client_requests metrics, as in the JAX package, so
without it a daemon coordinates every request at ONE.

Every node executes the same `ddl` locally at startup; explicit
`WITH id = <uuid>` table ids keep independently-started processes in
agreement (distributed schema propagation is the TCM work item).
Prints "READY <port>" on stdout once the transport is listening and the
node serves requests; exits cleanly on SIGTERM.

Usage: python -m cassandra_tpu_torch.tools.noded <config.json>
"""
from __future__ import annotations

import json
import signal
import sys
import threading


def build_node(cfg: dict):
    device = _device(cfg)   # both checked before any socket opens
    cl = _consistency(cfg)
    from ..cluster.node import Node
    from ..cluster.ring import Endpoint, Ring
    from ..cluster.tcp import TcpTransport
    from ..schema import Schema

    from ..cluster.tls import TLSConfig
    if cfg.get("partitioner"):
        # cluster-wide key->token mapping; must install before any
        # write bakes tokens into lanes (cassandra.yaml `partitioner`)
        from ..utils import partitioners
        partitioners.set_current(cfg["partitioner"])
    dc, rack = cfg.get("dc"), cfg.get("rack")
    if cfg.get("snitch") and (dc is None or rack is None):
        # snitch-resolved placement (locator/ SPI): explicit dc/rack in
        # the config win; otherwise the snitch supplies them
        from ..cluster import snitch as snitch_mod
        sdc, srack = snitch_mod.create(
            cfg["snitch"]).local_dc_rack(cfg["name"])
        dc = dc or sdc
        rack = rack or srack
    me = Endpoint(cfg["name"], dc or "dc1", rack or "rack1",
                  cfg.get("host", "127.0.0.1"), int(cfg["port"]))
    if cfg.get("auto_join"):
        return _build_tcm_node(cfg, me, device, cl)
    ring = Ring()
    ring.add_node(me, [int(t) for t in cfg["tokens"]])
    peers = {}
    for p in cfg.get("peers", []):
        ep = Endpoint(p["name"], p.get("dc", "dc1"), p.get("rack", "rack1"),
                      p.get("host", "127.0.0.1"), int(p["port"]))
        peers[ep.name] = ep
        ring.add_node(ep, [int(t) for t in p["tokens"]])
    seeds = [peers[n] for n in cfg.get("seeds", []) if n in peers] or [me]

    # "server_tls": internode mutual TLS (server_encryption_options)
    transport = TcpTransport(
        tls=TLSConfig.from_dict(cfg.get("server_tls")))
    node = Node(me, cfg["data_dir"], Schema(), ring, transport,
                seeds=seeds,
                gossip_interval=float(cfg.get("gossip_interval", 0.2)),
                engine_opts=_engine_opts(cfg, device))
    if cl is not None:
        node.default_cl = cl
    node.cluster_nodes = [node]   # DDL opens stores on this engine only
    # TCM-lite: per-process schemas replicate DDL through the epoch log
    from ..cluster.schema_sync import SchemaSync
    node.schema_sync = SchemaSync(node, cfg["data_dir"])
    session = node.session()
    for stmt in cfg.get("ddl", []):
        # config DDL is per-node bootstrap state, not coordinated
        sync, node.schema_sync = node.schema_sync, None
        try:
            session.execute(stmt)
        finally:
            node.schema_sync = sync
    node.gossiper.start()
    node.engine.compactions.enable_auto()

    def _catch_up():
        # wait for gossip to mark a peer alive, then pull newer schema —
        # pulling immediately would no-op (no peer looks alive yet)
        import time as _t
        deadline = _t.monotonic() + 15.0
        while _t.monotonic() < deadline:
            try:
                if any(node.is_alive(ep) for ep in node.ring.endpoints
                       if ep != node.endpoint):
                    node.schema_sync.pull_from_peers(timeout=3.0)
                    return
            except Exception:
                # catch-up is best-effort bootstrap: a failed pull
                # retries until the deadline instead of silently ending
                # the thread (ctpulint worker-loops)
                pass
            _t.sleep(0.2)

    import threading as _threading
    _threading.Thread(target=_catch_up, daemon=True,
                      name="schema-catchup").start()
    return node, transport


def _engine_opts(cfg: dict, device) -> dict:
    """TDE + commitlog archiver knobs (cassandra.yaml
    transparent_data_encryption_options / commitlog_archiving role), plus
    the typed `config:` block (config.Config — the cassandra.yaml
    equivalent, validated with unit-spec parsing; unknown keys fail
    startup). Runtime-mutable settings flow through engine.settings.
    `device` is the engine's resolved torch device."""
    from ..config import Config, Settings
    out = {"settings": Settings(Config.load(cfg.get("config", {})))}
    if cfg.get("keystore_dir"):
        out["keystore_dir"] = cfg["keystore_dir"]
    if cfg.get("commitlog_archive_dir"):
        out["commitlog_archive_dir"] = cfg["commitlog_archive_dir"]
    if cfg.get("encrypt_commitlog"):
        out["encrypt_commitlog"] = True
    out["device"] = device
    return out


def _device(cfg: dict):
    """The engine's torch device: the config's `device`, `cuda` when
    unset (raising without a card). The JAX package's `jax_platform`
    key is refused rather than ignored."""
    if "jax_platform" in cfg:
        raise ValueError(
            "noded: the config key 'jax_platform' is not supported; set "
            "'device' to 'cuda' (the default) or 'cpu' instead")
    from ..device import resolve
    return resolve(cfg.get("device"))


def _consistency(cfg: dict):
    """The config's `consistency` as a ConsistencyLevel, or None."""
    if cfg.get("consistency") is None:
        return None
    from ..cluster.replication import ConsistencyLevel
    name = str(cfg["consistency"]).upper()
    if not hasattr(ConsistencyLevel, name):
        raise ValueError(f"noded: unknown consistency {cfg['consistency']!r}")
    return getattr(ConsistencyLevel, name)


def _build_tcm_node(cfg: dict, me, device, cl):
    """TCM startup (tcm/Startup.initialize role): the RING IS THE LOG.
    A fresh node pulls the epoch log from its seed addresses, replays it
    into ring+schema, then either resumes an interrupted multi-step
    operation, registers as the first node, or runs the full
    BootstrapAndJoin sequence. No static peer/token config.

    Config keys: auto_join: true, seed_nodes: [{name,host,port,dc,rack}],
    optional tokens (else allocated), vnodes (default 4)."""
    import time as _t

    from ..cluster.node import Node
    from ..cluster.ring import Endpoint, Ring, allocate_tokens
    from ..cluster.schema_sync import SchemaSync
    from ..cluster.tcp import TcpTransport
    from ..cluster.tls import TLSConfig

    from ..schema import Schema

    seed_eps = [Endpoint(s["name"], s.get("dc", "dc1"),
                         s.get("rack", "rack1"),
                         s.get("host", "127.0.0.1"), int(s["port"]))
                for s in cfg.get("seed_nodes", [])]
    ring = Ring()
    transport = TcpTransport(tls=TLSConfig.from_dict(cfg.get("server_tls")))
    node = Node(me, cfg["data_dir"], Schema(), ring, transport,
                seeds=[e for e in seed_eps if e != me] or [me],
                gossip_interval=float(cfg.get("gossip_interval", 0.2)),
                engine_opts=_engine_opts(cfg, device))
    if cl is not None:
        node.default_cl = cl
    node.cluster_nodes = [node]
    node.schema_sync = SchemaSync(node, cfg["data_dir"])
    # local log first (restart), then the cluster's newer entries
    node.schema_sync.replay_all()
    others = [e for e in seed_eps if e != me]
    if others:
        # discovery MUST succeed: falling through to "I am the first
        # node" after a failed pull would fork a second cluster with its
        # own epoch log claiming the same token space
        ok = False
        for _ in range(6):
            if node.schema_sync.pull_from_peers(timeout=5.0, peers=others):
                ok = True
                break
            _t.sleep(1.0)
        if not ok and node.schema_sync.epoch == 0:
            raise RuntimeError(
                f"{me.name}: no configured seed answered the log pull; "
                f"refusing to start a new cluster (remove seed_nodes to "
                f"bootstrap a fresh cluster)")
    node.gossiper.start()
    if others and (me not in ring.endpoints or me in ring.pending
                   or me in ring.replacing):
        # joining/resuming streams from live owners: wait for gossip to
        # mark the members alive first (bootstrap FAILS on a range with
        # no live source rather than completing empty — this wait just
        # avoids failing a healthy join on startup timing). The node a
        # replace is displacing is dead by definition and never waited on.
        being_replaced = ring.replacing.get(me)
        deadline = _t.monotonic() + 20.0
        while _t.monotonic() < deadline and \
                not all(node.is_alive(e) for e in ring.endpoints
                        if e != me and e != being_replaced):
            _t.sleep(0.1)
    import os as _os
    if me in ring.pending or me in ring.replacing:
        streamed = node.resume_topology()
        print(f"[noded] {me.name}: resumed interrupted topology op "
              f"({streamed} cells) at epoch {node.schema_sync.epoch}",
              flush=True)
    elif me not in ring.endpoints:
        tokens = [int(t) for t in cfg.get("tokens") or []] or \
            allocate_tokens(ring, int(cfg.get("vnodes", 4)))
        if ring.endpoints:
            if _os.environ.get("CTPU_TEST_CRASH_AFTER_START_JOIN"):
                # fault-injection seam for the resume test (the
                # reference stages the same crash with Byteman rules)
                node.topology_commit({"op": "start_join",
                                      "node": node._ep_dict(),
                                      "tokens": tokens})
                _os._exit(42)
            node.join_cluster(tokens)
            print(f"[noded] {me.name}: joined at epoch "
                  f"{node.schema_sync.epoch}", flush=True)
        else:
            node.topology_commit({"op": "register",
                                  "node": node._ep_dict(),
                                  "tokens": tokens})
            # first node: cfg DDL runs COORDINATED so it lands in the
            # log and replicates to every later joiner via pull
            session = node.session()
            for stmt in cfg.get("ddl", []):
                session.execute(stmt)
    node.engine.compactions.enable_auto()
    return node, transport


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: noded <config.json>", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        cfg = json.load(f)
    node, transport = build_node(cfg)
    native = None
    if cfg.get("native_port") is not None:
        # client-facing CQL native protocol endpoint (port 9042 role)
        from ..cluster.tls import TLSConfig
        from ..transport.server import CQLServer
        # "native_tls": client_encryption_options role
        native = CQLServer(node, cfg.get("host", "127.0.0.1"),
                           int(cfg["native_port"]),
                           tls=TLSConfig.from_dict(cfg.get("native_tls")))
    admin = None
    if cfg.get("admin_port") is not None:
        # remote nodetool endpoint (the JMX port 7199 role); loopback
        # binds run in the shell-access trust model, non-loopback binds
        # REQUIRE admin_secret (AdminServer refuses otherwise)
        from ..service.admin import AdminServer
        secret = cfg.get("admin_secret")
        if secret is None and cfg.get("admin_secret_file"):
            with open(cfg["admin_secret_file"]) as sf:
                secret = sf.read().strip()
        admin = AdminServer(node, cfg.get("admin_host", "127.0.0.1"),
                            int(cfg["admin_port"]), secret=secret)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print(f"READY {transport.bound_port}"
          + (f" NATIVE {native.port}" if native else "")
          + (f" ADMIN {admin.port}" if admin else ""), flush=True)
    stop.wait()
    if admin is not None:
        admin.close()
    if native is not None:
        native.close()
    node.engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
