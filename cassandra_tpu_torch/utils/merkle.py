"""Merkle tree over token ranges for anti-entropy repair.

Reference counterpart: utils/MerkleTree.java:72 (fixed-depth binary tree
over the token range; leaves hold hashes of the partitions they cover) and
repair/Validator.java:61 (adds partition digests in token order).

The tree is a flat array of 2^depth leaf hashes over an even split of the
(signed 64-bit) token space; inner hashes combine children. difference()
returns the token ranges whose subtrees disagree.
"""
from __future__ import annotations

import hashlib

import numpy as np

_SPAN = 1 << 64
_MIN = -(1 << 63)


class MerkleTree:
    def __init__(self, depth: int = 10):
        self.depth = depth
        self.n_leaves = 1 << depth
        self._leaf_data: list[bytes] = [b""] * self.n_leaves
        self.leaves: np.ndarray | None = None

    def leaf_of(self, token: int) -> int:
        return int(((token - _MIN) * self.n_leaves) // _SPAN)

    def add(self, token: int, digest: bytes) -> None:
        """Mix a partition digest into its leaf (order-insensitive mix so
        replicas can add in any order; the reference adds in token order —
        XOR keeps it commutative)."""
        i = self.leaf_of(token)
        cur = self._leaf_data[i]
        if not cur:
            self._leaf_data[i] = digest
        else:
            self._leaf_data[i] = bytes(a ^ b for a, b in zip(
                cur.ljust(16, b"\0"), digest.ljust(16, b"\0")))

    def seal(self) -> None:
        self.leaves = np.frombuffer(
            b"".join(h.ljust(16, b"\0")[:16] for h in self._leaf_data),
            dtype=np.uint8).reshape(self.n_leaves, 16)

    def root(self) -> bytes:
        if self.leaves is None:
            self.seal()
        return hashlib.md5(self.leaves.tobytes()).digest()

    def leaf_range(self, i: int) -> tuple[int, int]:
        """(start, end] token range of leaf i."""
        lo = _MIN + (i * _SPAN) // self.n_leaves
        hi = _MIN + ((i + 1) * _SPAN) // self.n_leaves - 1
        return lo, hi

    def difference(self, other: "MerkleTree") -> list[tuple[int, int]]:
        """Token ranges whose leaves differ (adjacent merged)."""
        if self.leaves is None:
            self.seal()
        if other.leaves is None:
            other.seal()
        assert self.depth == other.depth
        diff = (self.leaves != other.leaves).any(axis=1)
        out: list[tuple[int, int]] = []
        for i in np.flatnonzero(diff):
            lo, hi = self.leaf_range(int(i))
            if out and out[-1][1] + 1 == lo:
                out[-1] = (out[-1][0], hi)
            else:
                out.append((lo, hi))
        return out

    def serialize(self) -> bytes:
        if self.leaves is None:
            self.seal()
        return bytes([self.depth]) + self.leaves.tobytes()

    @classmethod
    def deserialize(cls, data: bytes) -> "MerkleTree":
        t = cls(depth=data[0])
        t.leaves = np.frombuffer(data, dtype=np.uint8,
                                 offset=1).reshape(t.n_leaves, 16)
        return t
