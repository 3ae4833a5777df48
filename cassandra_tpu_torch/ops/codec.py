"""Chunk compressor framework — the ICompressor seam.

Reference semantics: io/compress/ICompressor.java:27 (compress/uncompress,
recommendedUses), schema/CompressionParams.java:45 (per-table configuration,
16KiB default chunks, min_compress_ratio / maxCompressedLength fallback).

Five codecs, matching the reference set:
  LZ4Compressor      C++ (ops/native/codec.cpp), LZ4 block format
  SnappyCompressor   C++ (ops/native/codec.cpp), snappy raw format
  ZstdCompressor     system libzstd dlopen'd by the C++ layer (the
                     reference's zstd-jni role); python `zstandard`
                     fallback when the library is absent
  DeflateCompressor  zlib stdlib
  NoopCompressor     identity

Batch-first API: `compress_batch`/`decompress_batch` move a whole flush or
compaction write's chunks across the FFI in one call.
"""
from __future__ import annotations

import ctypes
import threading
import zlib

import numpy as np

from .native import build as native_build

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - baked into this image
    _zstd = None


class Compressor:
    name = "?"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def uncompress(self, data: bytes, uncompressed_length: int) -> bytes:
        raise NotImplementedError

    def compress_batch(self, chunks: list[bytes]) -> list[bytes]:
        return [self.compress(c) for c in chunks]

    def decompress_batch(self, chunks: list[bytes],
                         lengths: list[int]) -> list[bytes]:
        return [self.uncompress(c, n) for c, n in zip(chunks, lengths)]

    @staticmethod
    def _frame_view(f):
        """Zero-copy read view of a buffer-protocol frame. bytes pass
        through; numpy arrays / memoryviews become flat byte views —
        no staging copy unless the frame is non-contiguous."""
        if isinstance(f, (bytes, bytearray)):
            return f
        if isinstance(f, np.ndarray):
            return memoryview(np.ascontiguousarray(f)).cast("B")
        return memoryview(f).cast("B")

    def compress_iov(self, frames: list) -> tuple:
        """Compress buffer-protocol frames (numpy arrays / memoryviews)
        without staging copies. Returns (dst_uint8_array, offsets, sizes):
        frame i's compressed bytes are dst[offsets[i]:offsets[i]+sizes[i]].
        Generic fallback; the native codecs override with a zero-copy
        FFI path. The pure-Python codecs (zlib, zstandard) accept any
        buffer object, so frames go in as views — the per-frame
        bytes(f) copy this used to make was a measured cost on the
        encrypted-table write path (bench.py codec section)."""
        outs = [self.compress(self._frame_view(f)) for f in frames]
        offs = np.zeros(len(outs) + 1, dtype=np.int64)
        np.cumsum([len(o) for o in outs], out=offs[1:])
        # b"".join is the single unavoidable gather of the compressed
        # output; frombuffer wraps it without another copy
        dst = np.frombuffer(b"".join(outs), dtype=np.uint8)
        return dst, offs[:-1], np.diff(offs)

    def decompress_iov(self, src: np.ndarray, src_offs, src_lens,
                       dsts: list) -> None:
        """Decompress chunk i (src[src_offs[i] : +src_lens[i]]) directly
        into the writable buffer dsts[i] (numpy uint8 views — the arrays
        the decoded CellBatch will own). Generic fallback."""
        for i, d in enumerate(dsts):
            o, l = int(src_offs[i]), int(src_lens[i])
            raw = self.uncompress(src[o:o + l].tobytes(), d.nbytes)
            d.reshape(-1).view(np.uint8)[:] = np.frombuffer(raw,
                                                            dtype=np.uint8)


class _NativeCompressor(Compressor):
    """ctypes front-end over the C++ batch codecs."""
    _prefix = "?"

    def _prepare(self) -> None:
        """Hook run (on the calling thread) before each FFI entry —
        codecs with per-instance state (zstd level) sync it here."""

    def __init__(self):
        self._lib = native_build.load()
        self._compress = getattr(self._lib, f"{self._prefix}_compress")
        self._decompress = getattr(self._lib, f"{self._prefix}_decompress")
        self._compress_b = getattr(self._lib, f"{self._prefix}_compress_batch")
        self._decompress_b = getattr(self._lib, f"{self._prefix}_decompress_batch")
        self._compress_iov = getattr(self._lib, f"{self._prefix}_compress_iov")
        self._decompress_iov = getattr(self._lib,
                                       f"{self._prefix}_decompress_iov")
        self._max = getattr(self._lib, f"{self._prefix}_max_compressed")

    def compress(self, data: bytes) -> bytes:
        self._prepare()
        cap = self._max(len(data))
        dst = ctypes.create_string_buffer(cap)
        src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        n = self._compress(src, len(data),
                           ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError(f"{self.name}: compression failed")
        return dst.raw[:n]

    def uncompress(self, data: bytes, uncompressed_length: int) -> bytes:
        self._prepare()
        dst = ctypes.create_string_buffer(uncompressed_length or 1)
        src = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\x00")
        n = self._decompress(src, len(data),
                             ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
                             uncompressed_length)
        if n < 0 or n != uncompressed_length:
            raise ValueError(f"{self.name}: corrupt chunk")
        return dst.raw[:n]

    def compress_batch(self, chunks: list[bytes]) -> list[bytes]:
        if not chunks:
            return []
        self._prepare()
        src = b"".join(chunks)
        src_offs = np.zeros(len(chunks) + 1, dtype=np.int64)
        np.cumsum([len(c) for c in chunks], out=src_offs[1:])
        dst_offs = np.zeros(len(chunks) + 1, dtype=np.int64)
        np.cumsum([self._max(len(c)) for c in chunks], out=dst_offs[1:])
        dst = ctypes.create_string_buffer(int(dst_offs[-1]))
        sizes = np.zeros(len(chunks), dtype=np.int64)
        sbuf = (ctypes.c_uint8 * len(src)).from_buffer_copy(src)
        r = self._compress_b(
            sbuf, src_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
            dst_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(chunks))
        if r < 0:
            raise RuntimeError(f"{self.name}: batch compression failed")
        raw = dst.raw
        return [raw[int(dst_offs[i]):int(dst_offs[i]) + int(sizes[i])]
                for i in range(len(chunks))]

    def decompress_batch(self, chunks: list[bytes],
                         lengths: list[int]) -> list[bytes]:
        if not chunks:
            return []
        self._prepare()
        src = b"".join(chunks)
        src_offs = np.zeros(len(chunks) + 1, dtype=np.int64)
        np.cumsum([len(c) for c in chunks], out=src_offs[1:])
        dst_offs = np.zeros(len(chunks) + 1, dtype=np.int64)
        np.cumsum(lengths, out=dst_offs[1:])
        dst = ctypes.create_string_buffer(max(int(dst_offs[-1]), 1))
        sizes = np.zeros(len(chunks), dtype=np.int64)
        sbuf = (ctypes.c_uint8 * max(len(src), 1)).from_buffer_copy(src or b"\x00")
        r = self._decompress_b(
            sbuf, src_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
            dst_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(chunks))
        if r < 0 or not (sizes == np.asarray(lengths, dtype=np.int64)).all():
            raise ValueError(f"{self.name}: corrupt chunk in batch")
        raw = dst.raw
        return [raw[int(dst_offs[i]):int(dst_offs[i + 1])]
                for i in range(len(chunks))]


    @staticmethod
    def _as_u8(buf) -> np.ndarray:
        a = np.frombuffer(buf, dtype=np.uint8) if not isinstance(
            buf, np.ndarray) else buf
        if a.dtype != np.uint8:
            a = a.view(np.uint8)
        return np.ascontiguousarray(a).reshape(-1)

    def compress_iov(self, frames: list) -> tuple:
        """Zero-copy scatter-gather compression: frames go over the FFI as
        (pointer, length) pairs; results land in one preallocated numpy
        buffer. No b''.join, no from_buffer_copy, no .raw re-copy — the
        write path's staging copies were a measured compaction hot spot."""
        n = len(frames)
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64), \
                np.zeros(0, np.int64)
        self._prepare()
        arrs = [self._as_u8(f) for f in frames]
        lens = np.array([a.nbytes for a in arrs], dtype=np.int64)
        dst_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([self._max(int(l)) for l in lens], out=dst_offs[1:])
        dst = np.empty(int(dst_offs[-1]), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ptrs = (u8p * n)(*[a.ctypes.data_as(u8p) for a in arrs])
        sizes = np.zeros(n, dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        r = self._compress_iov(
            ptrs, lens.ctypes.data_as(i64p), dst.ctypes.data_as(u8p),
            dst_offs.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p), n)
        if r < 0:
            raise RuntimeError(f"{self.name}: iov compression failed")
        return dst, dst_offs[:-1], sizes

    def decompress_iov(self, src: np.ndarray, src_offs, src_lens,
                       dsts: list) -> None:
        n = len(dsts)
        if n == 0:
            return
        self._prepare()
        src = np.ascontiguousarray(src.view(np.uint8).reshape(-1))
        src_offs = np.ascontiguousarray(src_offs, dtype=np.int64)
        src_lens = np.ascontiguousarray(src_lens, dtype=np.int64)
        arrs = []
        for d in dsts:
            a = d.reshape(-1).view(np.uint8)
            if not a.flags.c_contiguous:
                raise ValueError("decompress_iov needs contiguous dsts")
            arrs.append(a)
        lens = np.array([a.nbytes for a in arrs], dtype=np.int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        ptrs = (u8p * n)(*[a.ctypes.data_as(u8p) for a in arrs])
        r = self._decompress_iov(
            src.ctypes.data_as(u8p), src_offs.ctypes.data_as(i64p),
            src_lens.ctypes.data_as(i64p), ptrs,
            lens.ctypes.data_as(i64p), n)
        if r < 0:
            raise ValueError(f"{self.name}: corrupt chunk in iov batch")


class LZ4Compressor(_NativeCompressor):
    name = "LZ4Compressor"
    _prefix = "lz4"


class SnappyCompressor(_NativeCompressor):
    name = "SnappyCompressor"
    _prefix = "snappy"


class DeflateCompressor(Compressor):
    name = "DeflateCompressor"

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, 6)

    def uncompress(self, data: bytes, uncompressed_length: int) -> bytes:
        out = zlib.decompress(data)
        if len(out) != uncompressed_length:
            raise ValueError("DeflateCompressor: corrupt chunk")
        return out


class ZstdNativeCompressor(_NativeCompressor):
    """Zstd over the system libzstd, dlopen'd by the C++ layer (the
    reference's zstd-jni role). Raises at construction when libzstd is
    absent — the registry falls back to the Python binding."""
    name = "ZstdCompressor"
    _prefix = "zstd"

    def __init__(self, level: int = 3):
        super().__init__()
        if not self._lib.zstd_available():
            raise RuntimeError("libzstd unavailable")
        self.level = level

    def _prepare(self) -> None:
        # the native level is THREAD-LOCAL; syncing it before every FFI
        # entry keeps instances with different levels independent
        self._lib.zstd_set_level(self.level)


class ZstdPythonCompressor(Compressor):
    name = "ZstdCompressor"

    def __init__(self, level: int = 3):
        if _zstd is None:
            raise RuntimeError("zstandard module unavailable")
        self.level = level
        self._c = _zstd.ZstdCompressor(level=level)
        self._d = _zstd.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def uncompress(self, data: bytes, uncompressed_length: int) -> bytes:
        out = self._d.decompress(data, max_output_size=uncompressed_length)
        if len(out) != uncompressed_length:
            raise ValueError("ZstdCompressor: corrupt chunk")
        return out


def ZstdCompressor(level: int = 3) -> Compressor:
    """Factory: native libzstd when present, else the Python binding."""
    try:
        return ZstdNativeCompressor(level)
    except Exception:
        return ZstdPythonCompressor(level)


class NoopCompressor(Compressor):
    name = "NoopCompressor"

    def compress(self, data: bytes) -> bytes:
        return data

    def uncompress(self, data: bytes, uncompressed_length: int) -> bytes:
        if len(data) != uncompressed_length:
            raise ValueError("NoopCompressor: length mismatch")
        return data


_REGISTRY = {
    "LZ4Compressor": LZ4Compressor,
    "SnappyCompressor": SnappyCompressor,
    "DeflateCompressor": DeflateCompressor,
    "ZstdCompressor": ZstdCompressor,
    "NoopCompressor": NoopCompressor,
}


class SegmentPacker:
    """Front-end over the fused native write path (segment_pack): one
    GIL-released call does lane delta + order check + compress-or-raw +
    CRC32 + sequential placement. Returns None from `create` when the
    codec has no native id (Deflate) or the library is unavailable —
    callers fall back to the per-block Python chain."""

    _CODEC_IDS = {"NoopCompressor": 0, "LZ4Compressor": 1,
                  "SnappyCompressor": 2, "ZstdCompressor": 3}

    @classmethod
    def create(cls, compressor: Compressor) -> "SegmentPacker | None":
        cid = cls._CODEC_IDS.get(compressor.name)
        if cid is None:
            return None
        if cid == 3 and not isinstance(compressor, ZstdNativeCompressor):
            return None
        try:
            lib = native_build.load()
        except Exception:
            return None
        return cls(lib, cid, getattr(compressor, "level", 0))

    def __init__(self, lib, codec_id: int, zstd_level: int = 0):
        self._lib = lib
        self._cid = codec_id
        self._zstd_level = zstd_level
        self._u8p = ctypes.POINTER(ctypes.c_uint8)
        self._i64p = ctypes.POINTER(ctypes.c_int64)
        self._u32p = ctypes.POINTER(ctypes.c_uint32)
        # per-THREAD shuffle scratch: one packer instance serves every
        # worker of the parallel compress pool concurrently (the native
        # zstd level is already thread-local on the C side)
        self._tls = threading.local()

    def _scratch_for(self, need: int) -> np.ndarray:
        buf = getattr(self._tls, "scratch", None)
        if buf is None or buf.nbytes < need:
            buf = np.empty(need, dtype=np.uint8)
            self._tls.scratch = buf
        return buf

    def pack(self, blocks: list[np.ndarray], attempt: list[bool],
             max_compressed_length: int, shuffle_block: int,
             lane_width: int, out: np.ndarray):
        """Pack `blocks` into `out`. Returns (total, sizes, rawflags,
        crcs); raises ValueError on an order violation in the shuffled
        block."""
        n = len(blocks)
        arrs = [np.ascontiguousarray(b.reshape(-1).view(np.uint8))
                for b in blocks]
        lens = np.array([a.nbytes for a in arrs], dtype=np.int64)
        scratch = self._scratch_for(int(lens[shuffle_block])
                                    if shuffle_block >= 0 else 0)
        sizes = np.zeros(n, dtype=np.int64)
        raws = np.zeros(n, dtype=np.uint8)
        crcs = np.zeros(n, dtype=np.uint32)
        att = np.array([1 if a else 0 for a in attempt], dtype=np.uint8)
        ptrs = (self._u8p * n)(*[a.ctypes.data_as(self._u8p)
                                 for a in arrs])
        if self._cid == 3:
            self._lib.zstd_set_level(self._zstd_level)
        total = self._lib.segment_pack(
            self._cid, ptrs, lens.ctypes.data_as(self._i64p), n,
            att.ctypes.data_as(self._u8p), max_compressed_length,
            shuffle_block, lane_width,
            scratch.ctypes.data_as(self._u8p),
            out.ctypes.data_as(self._u8p), out.nbytes,
            sizes.ctypes.data_as(self._i64p),
            raws.ctypes.data_as(self._u8p),
            crcs.ctypes.data_as(self._u32p))
        if total == -3:
            raise ValueError("appended cells out of order")
        if total < 0:
            raise RuntimeError("segment_pack failed")
        return int(total), sizes, raws, crcs


def lanes_unshuffle(planes: np.ndarray, lanes_out: np.ndarray) -> None:
    """Byte planes -> [n, K] u32 rows (reader side of the segment_pack
    shuffle transform)."""
    n, k = lanes_out.shape
    if n == 0:
        return
    try:
        lib = native_build.load()
        lib.lanes_unshuffle(
            planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lanes_out.view(np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)), n, k)
    except Exception:
        lanes_out.view(np.uint8).reshape(n, 4 * k)[:] = \
            planes.reshape(4 * k, n).T


def lanes_shuffle(lanes: np.ndarray) -> np.ndarray:
    """[n, K] u32 rows -> byte planes (numpy path — used by writers that
    cannot take the fused native call, e.g. encrypted tables)."""
    n, k = lanes.shape
    return np.ascontiguousarray(
        lanes.astype(np.uint32, copy=False).view(np.uint8)
        .reshape(n, 4 * k).T).ravel()
_instances: dict[str, Compressor] = {}


def get_compressor(name: str) -> Compressor:
    """Resolve by class name (schema/CompressionParams.java loads the class
    reflectively; this registry is the equivalent seam)."""
    short = name.rsplit(".", 1)[-1]
    if short not in _instances:
        if short not in _REGISTRY:
            raise ValueError(f"unknown compressor: {name}")
        _instances[short] = _REGISTRY[short]()
    return _instances[short]


class CompressionParams:
    """Per-table compression options (schema/CompressionParams.java:45)."""
    DEFAULT_CHUNK_LENGTH = 16 * 1024

    def __init__(self, compressor: str = "LZ4Compressor",
                 chunk_length: int = DEFAULT_CHUNK_LENGTH,
                 min_compress_ratio: float = 0.0,
                 enabled: bool = True):
        if chunk_length & (chunk_length - 1):
            raise ValueError("chunk_length must be a power of two")
        self.compressor_name = compressor
        self.chunk_length = chunk_length
        self.min_compress_ratio = min_compress_ratio
        self.enabled = enabled

    @property
    def max_compressed_length(self) -> int:
        """Chunks that compress worse than min_compress_ratio are stored
        uncompressed (CompressedSequentialWriter.java:160-175)."""
        if self.min_compress_ratio <= 0:
            return 1 << 62
        return int(self.chunk_length / self.min_compress_ratio)

    def compressor(self) -> Compressor:
        return get_compressor(self.compressor_name)

    def to_dict(self) -> dict:
        return {"class": self.compressor_name,
                "chunk_length_in_kb": self.chunk_length // 1024,
                "min_compress_ratio": self.min_compress_ratio,
                "enabled": self.enabled}

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionParams":
        if not d:
            return cls("NoopCompressor", enabled=False)
        p = cls(d.get("class", "LZ4Compressor").rsplit(".", 1)[-1],
                int(d.get("chunk_length_in_kb", 16)) * 1024,
                float(d.get("min_compress_ratio", 0.0)),
                enabled=bool(d.get("enabled", True)))
        return p

    def compressor_or_noop(self) -> Compressor:
        return self.compressor() if self.enabled else get_compressor("NoopCompressor")
