"""MurmurHash3 x64/128 as Apache Cassandra computes it, over many keys of
one length at once (plain NumPy).

Cassandra's `MurmurHash.hash3_x64_128` reads the tail bytes as signed
Java bytes, so a tail byte >= 0x80 is sign-extended before it is XORed
in; canonical murmur3 differs there. `Murmur3Partitioner` takes the
first word as a signed token and maps Long.MIN_VALUE to Long.MAX_VALUE.
"""
from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_MIN = -(1 << 63)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(0xFF51AFD7ED558CCD)
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(0xC4CEB9FE1A85EC53)
    return k ^ (k >> np.uint64(33))


def _signed_byte(col: np.ndarray) -> np.ndarray:
    """A uint8 column as the uint64 bit pattern of the sign-extended
    Java byte."""
    v = col.astype(np.uint64)
    return np.where(col >= 0x80, v | np.uint64(0xFFFFFFFFFFFFFF00), v)


def hash128(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(h1, h2) as uint64 arrays for an (n, L) uint8 matrix of keys, all
    of length L."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n, length = keys.shape
    h1 = np.zeros(n, dtype=np.uint64)
    h2 = np.zeros(n, dtype=np.uint64)
    nblocks = length // 16
    with np.errstate(over="ignore"):
        for b in range(nblocks):
            words = keys[:, 16 * b:16 * b + 16].copy().view("<u8")
            k1, k2 = words[:, 0].astype(np.uint64), words[:, 1].astype(
                np.uint64)
            k1 = _rotl(k1 * _C1, 31) * _C2
            h1 ^= k1
            h1 = (_rotl(h1, 27) + h2) * np.uint64(5) + np.uint64(0x52DCE729)
            k2 = _rotl(k2 * _C2, 33) * _C1
            h2 ^= k2
            h2 = (_rotl(h2, 31) + h1) * np.uint64(5) + np.uint64(0x38495AB5)
        tail = keys[:, 16 * nblocks:]
        tl = tail.shape[1]
        if tl >= 9:
            k2 = np.zeros(n, dtype=np.uint64)
            for i in range(tl - 1, 7, -1):
                k2 ^= _signed_byte(tail[:, i]) << np.uint64(8 * (i - 8))
            h2 ^= _rotl(k2 * _C2, 33) * _C1
        if tl > 0:
            k1 = np.zeros(n, dtype=np.uint64)
            for i in range(min(tl, 8) - 1, -1, -1):
                k1 ^= _signed_byte(tail[:, i]) << np.uint64(8 * i)
            h1 ^= _rotl(k1 * _C1, 31) * _C2
        h1 ^= np.uint64(length)
        h2 ^= np.uint64(length)
        h1 = h1 + h2
        h2 = h2 + h1
        h1 = _fmix(h1)
        h2 = _fmix(h2)
        h1 = h1 + h2
        h2 = h2 + h1
    return h1, h2


def biased_tokens(h1: np.ndarray) -> np.ndarray:
    """Murmur3Partitioner tokens plus 2^63, as uint64 (so unsigned order
    is token order)."""
    tok = h1.view(np.int64)
    tok = np.where(tok == _MIN, np.int64((1 << 63) - 1), tok)
    return tok.view(np.uint64) ^ np.uint64(1 << 63)
