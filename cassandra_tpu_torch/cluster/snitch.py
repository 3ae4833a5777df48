"""Snitches: where does each endpoint live (DC / rack)?

Reference counterparts: locator/SimpleSnitch.java,
locator/GossipingPropertyFileSnitch.java (cassandra-rackdc.properties
for the LOCAL node, peers learned via gossip application state),
locator/PropertyFileSnitch.java (cassandra-topology.properties full
map), locator/Ec2Snitch.java + AbstractCloudMetadataServiceSnitch
(dc/rack inferred from the cloud instance metadata service), and
locator/DynamicEndpointSnitch.java (latency-ranked replica ordering —
implemented as the EWMA ranking inside cluster/coordinator.py; exposed
here for introspection).

Placement consumes Endpoint.dc/.rack (cluster/replication.py NTS), so a
snitch's job is to RESOLVE those two strings: the daemon asks its
snitch at startup for the local node's values and gossips them
(GPFS propagation model); peers' values arrive with their Endpoint
records."""
from __future__ import annotations

import os


class SimpleSnitch:
    """Everything in one dc/rack (locator/SimpleSnitch.java)."""

    name = "SimpleSnitch"

    def local_dc_rack(self, name: str = "") -> tuple[str, str]:
        return "dc1", "rack1"


class GossipingPropertyFileSnitch:
    """Local dc/rack from cassandra-rackdc.properties; peers via gossip
    (locator/GossipingPropertyFileSnitch.java). File format:

        dc=DC1
        rack=RACK1
        # prefer_local=true     (accepted, ignored here)
    """

    name = "GossipingPropertyFileSnitch"

    def __init__(self, rackdc_path: str):
        self.path = rackdc_path

    def local_dc_rack(self, name: str = "") -> tuple[str, str]:
        dc, rack = "dc1", "rack1"
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                k, _, v = line.partition("=")
                k = k.strip().lower()
                v = v.strip()
                if k == "dc":
                    dc = v
                elif k == "rack":
                    rack = v
        return dc, rack


class PropertyFileSnitch:
    """Full cluster topology from one file
    (locator/PropertyFileSnitch.java). Format per line:

        <node-name-or-host:port>=DC1:RACK1
        default=DC1:r1
    """

    name = "PropertyFileSnitch"

    def __init__(self, topology_path: str):
        self.path = topology_path
        self.map: dict[str, tuple[str, str]] = {}
        self.default = ("dc1", "rack1")
        with open(topology_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, v = line.partition("=")
                dc, _, rack = v.strip().partition(":")
                if key.strip().lower() == "default":
                    self.default = (dc, rack or "rack1")
                else:
                    self.map[key.strip()] = (dc, rack or "rack1")

    def dc_rack_of(self, name: str) -> tuple[str, str]:
        return self.map.get(name, self.default)

    def local_dc_rack(self, name: str = "") -> tuple[str, str]:
        return self.dc_rack_of(name)


class Ec2Snitch:
    """Cloud metadata snitch (locator/Ec2Snitch.java): the availability
    zone string from the instance metadata service becomes dc + rack —
    "us-east-1a" -> dc "us-east-1", rack "1a" (the reference's legacy
    ec2 naming scheme). `fetch` is injectable: production would GET
    http://169.254.169.254/latest/meta-data/placement/availability-zone
    (IMDS), tests and airgapped deployments inject a reader (e.g. a
    file via CTPU_EC2_AZ_FILE)."""

    name = "Ec2Snitch"
    IMDS_AZ_URL = ("http://169.254.169.254/latest/meta-data/"
                   "placement/availability-zone")

    def __init__(self, fetch=None):
        self._fetch = fetch or self._default_fetch

    @staticmethod
    def _default_fetch() -> str:
        path = os.environ.get("CTPU_EC2_AZ_FILE")
        if path:
            with open(path) as f:
                return f.read().strip()
        import urllib.request
        with urllib.request.urlopen(Ec2Snitch.IMDS_AZ_URL,
                                    timeout=2) as r:
            return r.read().decode().strip()

    @staticmethod
    def parse_az(az: str) -> tuple[str, str]:
        """"us-east-1a" -> ("us-east-1", "1a"): dc is the region
        including its number, rack is the number + zone letter
        (Ec2Snitch legacy naming)."""
        az = az.strip()
        i = len(az)                      # trailing zone letters
        while i > 0 and az[i - 1].isalpha():
            i -= 1
        j = i                            # the digit run before them
        while j > 0 and az[j - 1].isdigit():
            j -= 1
        return az[:i], az[j:]

    def local_dc_rack(self, name: str = "") -> tuple[str, str]:
        return self.parse_az(self._fetch())


class DynamicEndpointSnitch:
    """Latency-ranked replica ordering (DynamicEndpointSnitch.java):
    the ranking itself lives in StorageProxy (EWMA per endpoint, used
    for data-replica selection). This wrapper exposes the scores."""

    name = "DynamicEndpointSnitch"

    def __init__(self, proxy):
        self.proxy = proxy

    def scores(self) -> dict:
        with self.proxy._lat_lock:
            return {ep.name: s for ep, s in self.proxy._latency.items()}


def create(cfg: dict | None):
    """Snitch from a daemon config block:
        {"class": "GossipingPropertyFileSnitch", "rackdc": <path>}
        {"class": "PropertyFileSnitch", "topology": <path>}
        {"class": "Ec2Snitch"}
    None/absent -> SimpleSnitch."""
    if not cfg:
        return SimpleSnitch()
    cls = cfg.get("class", "SimpleSnitch").rsplit(".", 1)[-1]
    if cls == "SimpleSnitch":
        return SimpleSnitch()
    if cls == "GossipingPropertyFileSnitch":
        return GossipingPropertyFileSnitch(cfg["rackdc"])
    if cls == "PropertyFileSnitch":
        return PropertyFileSnitch(cfg["topology"])
    if cls == "Ec2Snitch":
        return Ec2Snitch()
    raise ValueError(f"unknown snitch {cls}")
