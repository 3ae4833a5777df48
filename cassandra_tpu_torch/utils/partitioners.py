"""Partitioners: partition key -> int64 ring token.

Reference counterparts: dht/Murmur3Partitioner.java (default),
dht/ByteOrderedPartitioner.java (order-preserving tokens — key-range
scans become token-range scans), dht/RandomPartitioner.java (md5),
dht/LocalPartitioner.java (raw-key comparison for internal tables).

TPU-first adaptation: the reference's ByteOrdered/Random partitioners
use variable-width token types (byte[] / BigInteger). Here EVERY
partitioner maps into the SAME signed-int64 token space the columnar
lane format and the device kernels are built on: ByteOrdered embeds the
first 8 key bytes order-preservingly (lexicographic byte order ==
numeric token order), Random takes md5's top 64 bits. Keys that share
an 8-byte prefix share a token — identity stays exact through the
murmur3 h2 lanes + pk_map, exactly like murmur3 token collisions do
today; only RANGE GRANULARITY coarsens, which matches the reference's
caveat that ByteOrdered ranges are only as fine as key prefixes in use.

The partitioner is PROCESS-GLOBAL like the reference's
DatabaseDescriptor.getPartitioner (one per cluster — sstables, ring
ownership and paging state all depend on it; set it before any data is
written and never mix)."""
from __future__ import annotations

import hashlib

import numpy as np

from . import murmur3

_BIAS = 1 << 63


class Murmur3Partitioner:
    name = "Murmur3Partitioner"

    def token(self, pk: bytes) -> int:
        return murmur3.token_of(pk)

    def tokens_mat(self, padded: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
        """Vectorised tokens from pre-padded key rows (bulk path)."""
        h1, _ = murmur3.hash128_mat(padded, lens)
        tok = h1.astype(np.int64)
        return np.where(tok == np.iinfo(np.int64).min,
                        np.iinfo(np.int64).max, tok)


class ByteOrderedPartitioner:
    """Order-preserving: token = first 8 key bytes, big-endian,
    zero-padded, biased to signed — lexicographic key order equals
    numeric token order, so partition scans walk keys in key order
    (dht/ByteOrderedPartitioner.java role in the int64 token space)."""

    name = "ByteOrderedPartitioner"

    def token(self, pk: bytes) -> int:
        raw = (pk[:8] + b"\x00" * 8)[:8]
        return int.from_bytes(raw, "big") - _BIAS

    def tokens_mat(self, padded: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
        n = len(lens)
        first8 = np.zeros((n, 8), dtype=np.uint8)
        w = min(8, padded.shape[1])
        first8[:, :w] = padded[:, :w]
        # rows shorter than 8 bytes already zero-padded by construction
        u = first8.copy().view(">u8").reshape(n).astype(np.uint64)
        with np.errstate(over="ignore"):
            return (u - np.uint64(_BIAS)).astype(np.int64)


class RandomPartitioner:
    """md5-based hashing (dht/RandomPartitioner.java), top 64 bits of
    the digest mapped into the signed token space."""

    name = "RandomPartitioner"

    def token(self, pk: bytes) -> int:
        d = hashlib.md5(pk).digest()
        return int.from_bytes(d[:8], "big") - _BIAS

    def tokens_mat(self, padded: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
        out = np.empty(len(lens), dtype=np.int64)
        for i, ln in enumerate(lens):
            out[i] = self.token(padded[i, :int(ln)].tobytes())
        return out


class LocalPartitioner(ByteOrderedPartitioner):
    """Raw-key ordering for node-local tables (secondary index
    internals) — never ring-distributed (dht/LocalPartitioner.java)."""

    name = "LocalPartitioner"


_REGISTRY = {c.name: c for c in (Murmur3Partitioner,
                                 ByteOrderedPartitioner,
                                 RandomPartitioner, LocalPartitioner)}

_current: Murmur3Partitioner = Murmur3Partitioner()


def get(name: str):
    short = name.rsplit(".", 1)[-1]
    if short not in _REGISTRY:
        raise ValueError(f"unknown partitioner: {name}")
    return _REGISTRY[short]()


def current():
    return _current


def set_current(name_or_instance) -> None:
    """Install the cluster partitioner (cassandra.yaml `partitioner`).
    Must happen before any data is written — tokens are baked into
    sstable lanes."""
    global _current
    _current = get(name_or_instance) if isinstance(name_or_instance, str) \
        else name_or_instance


def token_of(pk: bytes) -> int:
    return _current.token(pk)
