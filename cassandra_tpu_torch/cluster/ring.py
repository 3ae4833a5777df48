"""Token ring: node ownership of the murmur3 token space.

Reference counterpart: dht/IPartitioner + Murmur3Partitioner (tokens),
locator/TokenMetadata (ring state; superseded by tcm/ClusterMetadata's
tokenMap in 5.1 — our Ring plays that tokenMap role), dht/Splitter
(even range splitting).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from ..utils import murmur3


@dataclass(frozen=True)
class Endpoint:
    """A node address (InetAddressAndPort role). host/port address real
    socket transports; the in-process transport routes by identity."""
    name: str
    dc: str = "dc1"
    rack: str = "rack1"
    host: str = "127.0.0.1"
    port: int = 0

    def __repr__(self):
        return self.name


class Ring:
    """token -> owning endpoint, sorted; replica walks go clockwise
    (locator/AbstractReplicationStrategy.calculateNaturalReplicas walk)."""

    def __init__(self):
        self._tokens: list[int] = []
        self._owners: dict[int, Endpoint] = {}
        self.endpoints: dict[Endpoint, list[int]] = {}
        self.pending: dict[Endpoint, list[int]] = {}
        # replacement in progress: new endpoint -> dead endpoint whose
        # tokens it will assume (tcm/sequences replace-address flow).
        # Writes meanwhile go to BOTH (future ring maps dead -> new).
        self.replacing: dict[Endpoint, Endpoint] = {}
        # token move in progress: endpoint -> the OLD tokens it will
        # release at finish_move. The future ring excludes them, so
        # writes racing the move are duplicated to the owners gaining
        # the surrendered ranges (not just the gained ones).
        self.moving: dict[Endpoint, list[int]] = {}
        self._future_cache: "Ring | None" = None

    def add_node(self, ep: Endpoint, tokens: list[int]) -> None:
        for t in tokens:
            if t in self._owners:
                raise ValueError(f"token {t} already owned")
            bisect.insort(self._tokens, t)
            self._owners[t] = ep
        self.endpoints.setdefault(ep, []).extend(tokens)
        self._future_cache = None

    def remove_node(self, ep: Endpoint) -> None:
        for t in self.endpoints.pop(ep, []):
            self._tokens.remove(t)
            del self._owners[t]
        self._future_cache = None

    def remove_tokens(self, ep: Endpoint, tokens: list[int]) -> None:
        """Release a subset of ep's tokens (the shrink half of a token
        move; tcm/sequences/Move releases the old placement last)."""
        owned = self.endpoints.get(ep, [])
        for t in tokens:
            if self._owners.get(t) == ep:
                self._tokens.remove(t)
                del self._owners[t]
                owned.remove(t)
        if ep in self.endpoints and not self.endpoints[ep]:
            del self.endpoints[ep]
        self._future_cache = None

    # -------------------------------------------------------------- move --

    def start_move(self, ep: Endpoint, new_tokens: list[int]) -> None:
        """Begin a token move: new tokens pending, old tokens marked
        moving (excluded from the future ring so racing writes reach the
        owners gaining the surrendered ranges)."""
        self.add_pending(ep, new_tokens)
        self.moving[ep] = list(self.endpoints.get(ep, []))
        self._future_cache = None

    def finish_move(self, ep: Endpoint, old_tokens: list[int]) -> None:
        self.promote_pending(ep)
        self.remove_tokens(ep, old_tokens)
        self.moving.pop(ep, None)
        self._future_cache = None

    def abort_move(self, ep: Endpoint) -> None:
        self.cancel_pending(ep)
        self.moving.pop(ep, None)
        self._future_cache = None

    # ------------------------------------------------------- replacement --

    def start_replace(self, new_ep: Endpoint, dead_ep: Endpoint) -> None:
        """Begin replace-address: new_ep will assume dead_ep's tokens.
        Until finish, reads still route to the (dead) owner's replica set
        and writes are duplicated to new_ep via the future ring."""
        if dead_ep not in self.endpoints:
            raise ValueError(f"{dead_ep} not in ring")
        if new_ep in self.endpoints or new_ep in self.replacing:
            raise ValueError(f"{new_ep} already joined or replacing")
        self.replacing[new_ep] = dead_ep
        self._future_cache = None

    def finish_replace(self, new_ep: Endpoint) -> None:
        """Commit point: dead node leaves, new node owns its tokens."""
        dead = self.replacing.pop(new_ep)
        toks = list(self.endpoints.get(dead, []))
        self.remove_node(dead)
        self.add_node(new_ep, toks)
        self._future_cache = None

    def cancel_replace(self, new_ep: Endpoint) -> None:
        self.replacing.pop(new_ep, None)
        self._future_cache = None

    def successors(self, token: int):
        """Endpoints in ring order starting at the first token >= token."""
        if not self._tokens:
            return
        start = bisect.bisect_left(self._tokens, token)
        n = len(self._tokens)
        for i in range(n):
            t = self._tokens[(start + i) % n]
            yield self._owners[t]

    def primary(self, token: int) -> Endpoint:
        return next(self.successors(token))

    def token_of(self, key: bytes) -> int:
        from ..utils import partitioners
        return partitioners.token_of(key)

    def ranges_of(self, ep: Endpoint) -> list[tuple[int, int]]:
        """(start, end] ranges owned primarily by ep."""
        out = []
        n = len(self._tokens)
        for i, t in enumerate(self._tokens):
            if self._owners[t] is ep or self._owners[t] == ep:
                prev = self._tokens[(i - 1) % n]
                out.append((prev, t))
        return out

    def clone_without(self, ep: Endpoint) -> "Ring":
        """A copy of the ring as it was before `ep` joined (bootstrap
        stream sources must be computed against PRE-join ownership)."""
        r = Ring()
        for e, toks in self.endpoints.items():
            if e != ep:
                r.add_node(e, list(toks))
        return r

    # --------------------------------------------------- pending ranges --
    # A joining node's tokens are PENDING until its bootstrap stream
    # completes: reads keep routing to the pre-join owners, while writes
    # are duplicated to the pending node so nothing written mid-join is
    # missing when ownership flips (locator/ReplicaPlans pending
    # replicas; tcm/sequences/BootstrapAndJoin write-survey phase).

    def add_pending(self, ep: Endpoint, tokens: list[int]) -> None:
        taken = set(self._owners)
        for toks in self.pending.values():
            taken.update(toks)
        for t in tokens:
            if t in taken:
                raise ValueError(f"token {t} already owned or pending")
        self.pending[ep] = list(tokens)
        self._future_cache = None

    def promote_pending(self, ep: Endpoint) -> None:
        """Atomically flip ownership to the joined node (the join commit
        point: reads start routing to it, write duplication stops)."""
        toks = self.pending.pop(ep)
        self._future_cache = None
        self.add_node(ep, toks)

    def cancel_pending(self, ep: Endpoint) -> None:
        self.pending.pop(ep, None)
        self._future_cache = None

    def future_ring(self) -> "Ring":
        """The ring as it will be once every pending join/replace
        completes — pending-write placement is computed against this
        (cached: every write during a join consults it)."""
        if self._future_cache is not None:
            return self._future_cache
        r = Ring()
        swap = {dead: new for new, dead in self.replacing.items()}
        for e, toks in self.endpoints.items():
            drop = set(self.moving.get(e, ()))
            kept = [t for t in toks if t not in drop]
            if kept:
                r.add_node(swap.get(e, e), kept)
        for e, toks in self.pending.items():
            r.add_node(e, list(toks))
        self._future_cache = r
        return r

    def all_ranges(self) -> list[tuple[int, int]]:
        """Every (start, end] vnode range of the ring (start > end for the
        wrap-around range)."""
        n = len(self._tokens)
        return [(self._tokens[(i - 1) % n], t)
                for i, t in enumerate(self._tokens)]


def allocate_tokens(ring: "Ring", vnodes: int = 4) -> list[int]:
    """Tokens for a JOINING node: bisect the current largest ranges so
    ownership stays balanced as the cluster grows (the
    dht/tokenallocator role — the reference optimizes per-RF ownership
    variance; bisection of the widest arcs is the core of it)."""
    MIN, MAX = -(1 << 63) + 1, (1 << 63) - 1
    existing = sorted(ring._owners)
    for toks in ring.pending.values():
        existing.extend(toks)
    existing.sort()
    if not existing:
        span = (1 << 64) // vnodes
        return [MIN + i * span for i in range(vnodes)]
    out: list[int] = []
    for _ in range(vnodes):
        pts = sorted(existing + out)
        best_gap, best_mid = -1, None
        n = len(pts)
        for i, t in enumerate(pts):
            prev = pts[(i - 1) % n]
            gap = (t - prev) % (1 << 64)
            if gap == 0:
                gap = 1 << 64        # single token: the arc IS the ring
            mid = prev + gap // 2
            if mid > MAX:
                mid -= 1 << 64
            if gap > best_gap and mid not in pts:
                best_gap, best_mid = gap, int(mid)
        if best_mid is None:         # pathological density: fall back
            import random
            while True:
                c = random.randrange(MIN, MAX)
                if c not in pts:
                    best_mid = c
                    break
        out.append(best_mid)
    return out


def even_tokens(n_nodes: int, vnodes: int = 1) -> list[list[int]]:
    """Evenly spread initial tokens (dht/tokenallocator role, simplified
    to the uniform case)."""
    total = n_nodes * vnodes
    span = 1 << 64
    step = span // total
    out: list[list[int]] = [[] for _ in range(n_nodes)]
    for i in range(total):
        tok = -(1 << 63) + 1 + i * step
        out[i % n_nodes].append(tok)
    return out
