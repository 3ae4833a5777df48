"""Replication strategies: token -> replica set.

Reference counterpart: locator/AbstractReplicationStrategy (SimpleStrategy,
NetworkTopologyStrategy with per-DC RF and rack spreading, LocalStrategy),
locator/ReplicaPlans (consistency-level math).
"""
from __future__ import annotations

from .ring import Endpoint, Ring


class ReplicationStrategy:
    def __init__(self, options: dict):
        self.options = options

    def replicas(self, ring: Ring, token: int) -> list[Endpoint]:
        raise NotImplementedError

    def replication_factor(self) -> int:
        """The CONFIGURED total RF — consistency-level blockFor math uses
        this, never the materialized replica list, so a small ring does not
        silently weaken the guarantee (locator/ReplicationFactor.java,
        ConsistencyLevel.blockFor)."""
        raise NotImplementedError

    def dc_replication_factors(self) -> dict[str, int] | None:
        """Per-DC RF for NTS; None for non-topology-aware strategies."""
        return None

    @staticmethod
    def create(options: dict) -> "ReplicationStrategy":
        cls = str(options.get("class", "SimpleStrategy")).rsplit(".", 1)[-1]
        if cls == "SimpleStrategy":
            return SimpleStrategy(options)
        if cls == "NetworkTopologyStrategy":
            return NetworkTopologyStrategy(options)
        if cls == "LocalStrategy":
            return LocalStrategy(options)
        raise ValueError(f"unknown replication strategy {cls}")


class SimpleStrategy(ReplicationStrategy):
    def replication_factor(self) -> int:
        return int(self.options.get("replication_factor", 1))

    def replicas(self, ring: Ring, token: int) -> list[Endpoint]:
        rf = self.replication_factor()
        out: list[Endpoint] = []
        for ep in ring.successors(token):
            if ep not in out:
                out.append(ep)
            if len(out) >= rf:
                break
        return out


class NetworkTopologyStrategy(ReplicationStrategy):
    """Per-DC replication factor, spreading across racks within a DC
    (locator/NetworkTopologyStrategy.calculateNaturalReplicas)."""

    def dc_replication_factors(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.options.items() if k != "class"}

    def replication_factor(self) -> int:
        return sum(self.dc_replication_factors().values())

    def replicas(self, ring: Ring, token: int) -> list[Endpoint]:
        rf_by_dc = self.dc_replication_factors()
        chosen: list[Endpoint] = []
        racks_seen: dict[str, set] = {}
        per_dc: dict[str, int] = {}
        skipped: dict[str, list[Endpoint]] = {}
        for ep in ring.successors(token):
            rf = rf_by_dc.get(ep.dc, 0)
            if per_dc.get(ep.dc, 0) >= rf or ep in chosen:
                continue
            racks = racks_seen.setdefault(ep.dc, set())
            if ep.rack in racks:
                skipped.setdefault(ep.dc, []).append(ep)
                continue
            chosen.append(ep)
            racks.add(ep.rack)
            per_dc[ep.dc] = per_dc.get(ep.dc, 0) + 1
            if all(per_dc.get(dc, 0) >= rf for dc, rf in rf_by_dc.items()):
                break
        # fill remaining slots from skipped same-rack nodes
        for dc, rf in rf_by_dc.items():
            for ep in skipped.get(dc, []):
                if per_dc.get(dc, 0) >= rf:
                    break
                if ep not in chosen:
                    chosen.append(ep)
                    per_dc[dc] = per_dc.get(dc, 0) + 1
        return chosen


class LocalStrategy(ReplicationStrategy):
    def replication_factor(self) -> int:
        return 1

    def replicas(self, ring: Ring, token: int) -> list[Endpoint]:
        return []


# ------------------------------------------------------ consistency levels --

class ConsistencyLevel:
    ANY = "ANY"
    ONE = "ONE"
    TWO = "TWO"
    THREE = "THREE"
    QUORUM = "QUORUM"
    ALL = "ALL"
    LOCAL_QUORUM = "LOCAL_QUORUM"
    LOCAL_ONE = "LOCAL_ONE"
    EACH_QUORUM = "EACH_QUORUM"

    @staticmethod
    def block_for(cl: str, strategy: "ReplicationStrategy",
                  local_dc: str = "dc1") -> int:
        """How many acks the consistency level demands, from the CONFIGURED
        replication factor — not the materialized replica list. With RF=3
        on a 1-node ring, QUORUM must demand 2 and fail Unavailable, not
        quietly succeed with 1 (db/ConsistencyLevel.java blockFor)."""
        rf = strategy.replication_factor()
        if cl in ("ANY", "ONE", "LOCAL_ONE"):
            return 1 if rf else 0
        if cl == "TWO":
            return 2
        if cl == "THREE":
            return 3
        if cl == "QUORUM":
            return rf // 2 + 1
        if cl == "ALL":
            return rf
        if cl == "LOCAL_QUORUM":
            by_dc = strategy.dc_replication_factors()
            dc_rf = by_dc.get(local_dc, 0) if by_dc is not None else rf
            return dc_rf // 2 + 1
        if cl == "EACH_QUORUM":
            # total count only; the per-DC availability gate lives in
            # each_quorum_unavailable_dcs (ack counting stays global — a
            # DC whose quorum times out after the gate is approximated)
            by_dc = strategy.dc_replication_factors()
            if by_dc is not None:
                return sum(v // 2 + 1 for v in by_dc.values())
            return rf // 2 + 1
        raise ValueError(f"unknown consistency level {cl}")

    @staticmethod
    def each_quorum_unavailable_dcs(strategy: "ReplicationStrategy",
                                    live: list[Endpoint]) -> list[str]:
        """DCs whose quorum cannot be met from the live replicas —
        EACH_QUORUM must refuse if any (reference assureSufficient
        LiveReplicasForWrite per-DC path). Empty for non-NTS."""
        by_dc = strategy.dc_replication_factors()
        if by_dc is None:
            return []
        live_per_dc: dict[str, int] = {}
        for r in live:
            live_per_dc[r.dc] = live_per_dc.get(r.dc, 0) + 1
        return [dc for dc, rf in by_dc.items()
                if live_per_dc.get(dc, 0) < rf // 2 + 1]
