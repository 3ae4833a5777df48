"""Build + load the native codec library (g++ -> .so, loaded with ctypes).

Rebuilds automatically when the source is newer than the cached .so.
pybind11 is not available in this image; the C ABI + ctypes keeps the
binding layer dependency-free."""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "codec.cpp")
_SRCS = [os.path.join(_DIR, f) for f in ("codec.cpp", "merge.cpp")]
_SO = os.path.join(_DIR, "libcodec.so")
_STAMP = _SO + ".srchash"
_lock = threading.Lock()
_lib = None
_load_error = None  # negative cache: don't re-run g++ per call on failure


def _src_hash() -> str:
    src = b""
    for p in _SRCS:
        with open(p, "rb") as f:
            src += f.read()
    # stamp covers sources AND host (a -march=native binary from a
    # different CPU must never be loaded: SIGILL)
    host = f"{platform.machine()}|{platform.processor()}|{platform.node()}"
    return hashlib.sha256(src + host.encode()).hexdigest()


def _build(h: str) -> None:
    tmp = f"{_SO}.tmp.{os.getpid()}"  # unique per process: no build races
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp] + _SRCS + ["-lz", "-ldl"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    with open(_STAMP + f".{os.getpid()}", "w") as f:
        f.write(h)
    os.replace(_STAMP + f".{os.getpid()}", _STAMP)


def _stale(h: str) -> bool:
    # source-hash stamp, not mtime: a -march=native binary from another
    # machine (or a stale checkout) must never be loaded
    if not os.path.exists(_SO) or not os.path.exists(_STAMP):
        return True
    with open(_STAMP) as f:
        return f.read().strip() != h


def load() -> ctypes.CDLL:
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        raise _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            h = _src_hash()
            if _stale(h):
                _build(h)
        except Exception as e:
            _load_error = RuntimeError(f"native codec build failed: {e}")
            raise _load_error
        lib = ctypes.CDLL(_SO)
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        for fn in ("lz4_compress", "lz4_decompress",
                   "snappy_compress", "snappy_decompress",
                   "zstd_compress", "zstd_decompress"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [u8p, i64, u8p, i64]
        for fn in ("lz4_max_compressed", "snappy_max_compressed",
                   "zstd_max_compressed"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [i64]
        lib.zstd_available.restype = i64
        lib.zstd_available.argtypes = []
        lib.zstd_set_level.restype = None
        lib.zstd_set_level.argtypes = [ctypes.c_int]
        for fn in ("lz4_compress_batch", "lz4_decompress_batch",
                   "snappy_compress_batch", "snappy_decompress_batch",
                   "zstd_compress_batch", "zstd_decompress_batch"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [u8p, i64p, u8p, i64p, i64p, i64]
        u8pp = ctypes.POINTER(u8p)
        for fn in ("lz4_compress_iov", "snappy_compress_iov",
                   "zstd_compress_iov"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [u8pp, i64p, u8p, i64p, i64p, i64]
        for fn in ("lz4_decompress_iov", "snappy_decompress_iov",
                   "zstd_decompress_iov"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [u8p, i64p, i64p, u8pp, i64p, i64]
        u32p_ = ctypes.POINTER(ctypes.c_uint32)
        lib.segment_pack.restype = i64
        lib.segment_pack.argtypes = [
            i64, u8pp, i64p, i64,            # codec, blocks, lens, nblocks
            u8p, i64,                        # attempt, maxCompressedLen
            i64, i64, u8p,                   # delta_block, lane_width, scratch
            u8p, i64,                        # out, outCap
            i64p, u8p, u32p_]                # outSizes, outRaw, outCrcs
        lib.lanes_unshuffle.restype = None
        lib.lanes_unshuffle.argtypes = [u8p, u8p, i64, i64]
        lib.part_boundaries.restype = i64
        lib.part_boundaries.argtypes = [u32p_, i64, i64, i64p]
        lib.gather_frames.restype = i64
        lib.gather_frames.argtypes = [u8p, i64p, i64p, i64, i64p, u8p]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.merge_reconcile.restype = i64
        lib.merge_reconcile.argtypes = [
            u32p, i64p, i32p, u8p, i64p, i64p, u8p, i64,  # batch arrays, K
            i64p, i64,                                    # run_starts, n
            i64p, i64, i64,                               # pts, gc, now
            i64p, u8p]                                    # out_idx, out_exp
        _lib = lib
        return _lib
