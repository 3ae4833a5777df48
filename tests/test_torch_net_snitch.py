"""The port's counterpart of tests/test_snitch.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

Snitch breadth (locator/ SPI): GossipingPropertyFileSnitch,
PropertyFileSnitch, Ec2Snitch az parsing, DynamicEndpointSnitch scores,
and the daemon wiring that feeds NTS placement."""
import pytest

from cassandra_tpu_torch.cluster import snitch as snitch_mod
from torch_tmp import tmp_path  # noqa: F401


def test_gpfs_reads_rackdc(tmp_path):
    p = tmp_path / "cassandra-rackdc.properties"
    p.write_text("# comment\ndc=DC_EAST\nrack=RACK9\nprefer_local=true\n")
    s = snitch_mod.GossipingPropertyFileSnitch(str(p))
    assert s.local_dc_rack() == ("DC_EAST", "RACK9")


def test_property_file_snitch(tmp_path):
    p = tmp_path / "cassandra-topology.properties"
    p.write_text("node1=DC1:r1\nnode2=DC2:r7\ndefault=DC9:rX\n")
    s = snitch_mod.PropertyFileSnitch(str(p))
    assert s.dc_rack_of("node1") == ("DC1", "r1")
    assert s.dc_rack_of("node2") == ("DC2", "r7")
    assert s.dc_rack_of("unknown") == ("DC9", "rX")


def test_ec2_snitch_az_parsing():
    assert snitch_mod.Ec2Snitch.parse_az("us-east-1a") == \
        ("us-east-1", "1a")
    assert snitch_mod.Ec2Snitch.parse_az("eu-west-2b") == \
        ("eu-west-2", "2b")
    assert snitch_mod.Ec2Snitch.parse_az("ap-southeast-11c") == \
        ("ap-southeast-11", "11c")
    s = snitch_mod.Ec2Snitch(fetch=lambda: "us-west-2c")
    assert s.local_dc_rack() == ("us-west-2", "2c")


def test_ec2_snitch_file_fetch(tmp_path, monkeypatch):
    az = tmp_path / "az"
    az.write_text("eu-central-1b\n")
    monkeypatch.setenv("CTPU_EC2_AZ_FILE", str(az))
    assert snitch_mod.Ec2Snitch().local_dc_rack() == \
        ("eu-central-1", "1b")


def test_create_from_daemon_config(tmp_path):
    assert isinstance(snitch_mod.create(None), snitch_mod.SimpleSnitch)
    p = tmp_path / "rackdc"
    p.write_text("dc=D\nrack=R\n")
    s = snitch_mod.create({"class": "GossipingPropertyFileSnitch",
                           "rackdc": str(p)})
    assert s.local_dc_rack() == ("D", "R")
    with pytest.raises(ValueError):
        snitch_mod.create({"class": "NopeSnitch"})


def test_snitch_feeds_nts_placement(tmp_path):
    """A GPFS-resolved dc flows into the Endpoint and from there into
    NetworkTopologyStrategy placement — the snitch genuinely decides
    where replicas go."""
    from cassandra_tpu_torch.tools import noded
    rackdc = tmp_path / "rackdc"
    rackdc.write_text("dc=dc_snitched\nrack=rz\n")
    cfg = {"name": "n1", "port": 0, "tokens": [0],
           "data_dir": str(tmp_path / "d"), "device": "cpu",
           "snitch": {"class": "GossipingPropertyFileSnitch",
                      "rackdc": str(rackdc)}}
    node, transport = noded.build_node(cfg)
    try:
        assert node.endpoint.dc == "dc_snitched"
        assert node.endpoint.rack == "rz"
        s = node.session()
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'NetworkTopologyStrategy', "
                  "'dc_snitched': 1}")
        s.execute("CREATE TABLE ks.t (k int PRIMARY KEY)")
        s.execute("INSERT INTO ks.t (k) VALUES (1)")
        assert s.execute("SELECT k FROM ks.t").rows == [(1,)]
    finally:
        node.shutdown()
        shut = getattr(transport, "shutdown", None)
        if shut:
            shut()


def test_property_file_snitch_resolves_local_node(tmp_path):
    """Regression: the daemon must pass ITS OWN name to the snitch —
    a nameless lookup silently fell back to the topology default."""
    from cassandra_tpu_torch.tools import noded
    topo = tmp_path / "topo"
    topo.write_text("n1=DC_FROM_FILE:R3\ndefault=dc1:rack1\n")
    cfg = {"name": "n1", "port": 0, "tokens": [0],
           "data_dir": str(tmp_path / "d"), "device": "cpu",
           "snitch": {"class": "PropertyFileSnitch",
                      "topology": str(topo)}}
    node, transport = noded.build_node(cfg)
    try:
        assert node.endpoint.dc == "DC_FROM_FILE"
        assert node.endpoint.rack == "R3"
    finally:
        node.shutdown()
