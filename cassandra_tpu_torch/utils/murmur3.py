"""MurmurHash3 x64/128 — the partitioner and bloom-filter hash.

Semantics follow the reference's hasher used by Murmur3Partitioner
(reference: src/java/org/apache/cassandra/utils/MurmurHash.java:145
``hash3_x64_128``) and the token normalisation in
dht/Murmur3Partitioner.java (Long.MIN_VALUE is mapped to Long.MAX_VALUE so
the token space is (MIN, MAX]).

Two implementations:
  * ``hash128(data, seed)`` — scalar, exact, for keys at write/read time.
  * ``hash128_batch(keys)`` — numpy-vectorised over a padded uint8 matrix,
    used to hash many partition keys per call (bloom-filter builds, token
    computation during flush). A Pallas/TPU port is the natural next step
    since the state is 2 lanes of u64 math.
"""
from __future__ import annotations

import struct

import numpy as np

_MASK = 0xFFFFFFFFFFFFFFFF
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _fmix(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK
    k ^= k >> 33
    return k


def hash128(data: bytes, seed: int = 0) -> tuple[int, int]:
    """MurmurHash3 x64/128. Returns (h1, h2) as unsigned 64-bit ints."""
    length = len(data)
    nblocks = length // 16
    h1 = seed & _MASK
    h2 = seed & _MASK

    for i in range(nblocks):
        k1, k2 = struct.unpack_from("<QQ", data, i * 16)
        k1 = (k1 * _C1) & _MASK
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK
        h1 = (h1 * 5 + 0x52DCE729) & _MASK
        k2 = (k2 * _C2) & _MASK
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK
        h2 = (h2 * 5 + 0x38495AB5) & _MASK

    # Tail: the reference XOR-accumulates SIGN-EXTENDED bytes
    # (MurmurHash.java:216-232, `(long) key.get(...)` without & 0xff), which
    # diverges from canonical murmur3 whenever a tail byte is >= 0x80. We
    # reproduce that exactly so tokens match Murmur3Partitioner.
    tail = data[nblocks * 16:]
    k1 = 0
    k2 = 0
    tl = len(tail)
    if tl >= 9:
        for i in range(tl - 1, 7, -1):
            sb = tail[i] - 256 if tail[i] >= 128 else tail[i]
            k2 ^= (sb << (8 * (i - 8))) & _MASK
        k2 = (k2 * _C2) & _MASK
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
    if tl > 0:
        for i in range(min(tl, 8) - 1, -1, -1):
            sb = tail[i] - 256 if tail[i] >= 128 else tail[i]
            k1 ^= (sb << (8 * i)) & _MASK
        k1 = (k1 * _C1) & _MASK
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    return h1, h2


def token_of(key: bytes) -> int:
    """Signed 64-bit token of a partition key.

    Mirrors Murmur3Partitioner.getToken: first 128-bit word as signed long,
    with Long.MIN_VALUE normalised to Long.MAX_VALUE."""
    h1, _ = hash128(key)
    t = h1 - (1 << 64) if h1 >= (1 << 63) else h1
    if t == -(1 << 63):
        t = (1 << 63) - 1
    return t


MIN_TOKEN = -(1 << 63)  # ring origin; no key hashes to it after normalisation


# ---------------------------------------------------------------- batch ----

def _pad_keys(keys: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length keys into a (n, maxlen) uint8 matrix + lengths."""
    n = len(keys)
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    maxlen = int(lens.max()) if n else 0
    # round up to a 16-byte block boundary (+16 so tail logic has room)
    width = ((maxlen + 15) // 16 + 1) * 16
    mat = np.zeros((n, width), dtype=np.uint8)
    for i, k in enumerate(keys):
        mat[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
    return mat, lens


def hash128_batch(keys: list[bytes], seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised murmur3 x64/128 over many keys. Returns (h1, h2) uint64
    arrays."""
    if not keys:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    mat, lens = _pad_keys(keys)
    return hash128_mat(mat, lens, seed)


def hash128_mat(mat: np.ndarray, lens: np.ndarray,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised murmur3 over a pre-padded (n, width) uint8 matrix with
    per-row lengths; width must be a multiple of 16 with >= 16 bytes of
    padding beyond the longest row. Zero python loops over rows — the bulk
    generator and bloom builds feed millions of keys through here.

    All keys are processed in lock-step over the padded width; per-key block
    counts are honoured by masking (a block is only mixed into rows whose key
    is long enough). This is the same data-parallel shape a Pallas kernel
    would use."""
    lens = np.asarray(lens, dtype=np.int64)
    n, width = mat.shape
    blocks = mat.reshape(n, width // 16, 16)
    # little-endian u64 pairs per block (explicit dtype: host may be BE)
    as64 = blocks.view(np.dtype("<u8")).reshape(n, width // 16, 2)
    nblocks = (lens // 16).astype(np.int64)

    h1 = np.full(n, seed, dtype=np.uint64)
    h2 = np.full(n, seed, dtype=np.uint64)
    c1 = np.uint64(_C1)
    c2 = np.uint64(_C2)

    with np.errstate(over="ignore"):
        for b in range(width // 16):
            active = nblocks > b
            if not active.any():
                break
            k1 = as64[:, b, 0].copy()
            k2 = as64[:, b, 1].copy()
            k1 *= c1
            k1 = (k1 << np.uint64(31)) | (k1 >> np.uint64(33))
            k1 *= c2
            nh1 = h1 ^ k1
            nh1 = (nh1 << np.uint64(27)) | (nh1 >> np.uint64(37))
            nh1 += h2
            nh1 = nh1 * np.uint64(5) + np.uint64(0x52DCE729)
            k2 *= c2
            k2 = (k2 << np.uint64(33)) | (k2 >> np.uint64(31))
            k2 *= c1
            nh2 = h2 ^ k2
            nh2 = (nh2 << np.uint64(31)) | (nh2 >> np.uint64(33))
            nh2 += nh1
            nh2 = nh2 * np.uint64(5) + np.uint64(0x38495AB5)
            h1 = np.where(active, nh1, h1)
            h2 = np.where(active, nh2, h2)

        # Tails: XOR of SIGN-EXTENDED shifted bytes (reference
        # MurmurHash.java:216-232 semantics; see scalar impl above).
        tail_start = (nblocks * 16).astype(np.int64)
        tail_len = lens - tail_start
        idx = np.arange(16, dtype=np.int64)
        # (n, 16) gather of tail bytes, zero-padded
        gather_idx = tail_start[:, None] + idx[None, :]
        gather_idx = np.minimum(gather_idx, width - 1)
        tails = np.take_along_axis(mat, gather_idx, axis=1)
        valid = idx[None, :] < tail_len[:, None]
        stails = np.where(valid, tails.astype(np.int8).astype(np.int64), 0)
        shifts = (np.int64(8) * idx)[None, :]
        k1 = np.bitwise_xor.reduce(
            stails[:, :8] << shifts[:, :8], axis=1).astype(np.uint64)
        k2 = np.bitwise_xor.reduce(
            stails[:, 8:] << shifts[:, :8], axis=1).astype(np.uint64)

        has_k2 = tail_len >= 9
        k2 = (k2 * c2)
        k2 = (k2 << np.uint64(33)) | (k2 >> np.uint64(31))
        k2 = k2 * c1
        h2 = np.where(has_k2, h2 ^ k2, h2)
        has_k1 = tail_len > 0
        k1 = k1 * c1
        k1 = (k1 << np.uint64(31)) | (k1 >> np.uint64(33))
        k1 = k1 * c2
        h1 = np.where(has_k1, h1 ^ k1, h1)

        h1 ^= lens.astype(np.uint64)
        h2 ^= lens.astype(np.uint64)
        h1 += h2
        h2 += h1

        def fmix(k):
            k ^= k >> np.uint64(33)
            k *= np.uint64(0xFF51AFD7ED558CCD)
            k ^= k >> np.uint64(33)
            k *= np.uint64(0xC4CEB9FE1A85EC53)
            k ^= k >> np.uint64(33)
            return k

        h1 = fmix(h1)
        h2 = fmix(h2)
        h1 += h2
        h2 += h1
    return h1, h2


def tokens_of(keys: list[bytes]) -> np.ndarray:
    """Batch token computation. Returns int64 array of normalised tokens."""
    h1, _ = hash128_batch(keys)
    t = h1.astype(np.int64)
    return np.where(t == np.iinfo(np.int64).min, np.iinfo(np.int64).max, t)
