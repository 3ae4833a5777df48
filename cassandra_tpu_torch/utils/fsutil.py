"""Filesystem helpers for the durable write paths.

Block preallocation: on this environment's ext4 mount, writes that extend
a file (delayed allocation) run at ~16-24 MiB/s while writes into
preallocated ranges run at ~1.8 GiB/s — allocation, not data movement, is
the cost. The reference leans on the JVM's buffered writers + the kernel;
here the sstable writer and commitlog preallocate explicitly (the
reference's commitlog does the same thing for its own reasons:
CommitLogSegment pre-creates fixed 32MiB segments).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os

_FALLOC_FL_KEEP_SIZE = 0x01

_libc = None
_has_fallocate = None


def _load():
    global _libc, _has_fallocate
    if _has_fallocate is None:
        try:
            _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                                use_errno=True)
            _libc.fallocate.restype = ctypes.c_int
            _libc.fallocate.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int64, ctypes.c_int64]
            _has_fallocate = True
        except (OSError, AttributeError):
            _has_fallocate = False
    return _has_fallocate


def preallocate_keep_size(fd: int, offset: int, length: int) -> bool:
    """fallocate(FALLOC_FL_KEEP_SIZE): reserve blocks without changing
    st_size, so append-mode writers and EOF-terminated readers (commitlog
    replay) are unaffected. Returns False if unsupported (caller falls
    back to plain extending writes)."""
    if length <= 0 or not _load():
        return False
    r = _libc.fallocate(fd, _FALLOC_FL_KEEP_SIZE, offset, length)
    return r == 0
