"""The least work of the compaction kernels K1-K5 from their launch
shapes, and the card's published peaks: a frozen copy of the arithmetic,
so that a change to the program cannot move the yardstick.

Bytes count each input byte read once and each output byte written
once, at the rows a launch was given (a round is padded to a power of
two of at least 1,024 rows, and its padding is part of the operands).
K is the table's lane count.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 bandwidth, and the
# float32 rate outside the tensor cores, which bounds K5's integer
# compares from above (the integer rate is lower, so the bound is loose)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# the rows' stamp, key and mask columns that K2 reads beside the lanes
_REC_COLS = 9
# K5's candidate match distances: 1..64 and the powers of two 128..32768
_DISTANCES = 64 + 9


def sort_perm(N: int, K: int) -> tuple[int, int]:
    """K1: valid, K lanes, ts_h, ts_l read; the permutation written."""
    return N * ((K + 3) * 4 + 4), 0


def reconcile(N: int, K: int) -> tuple[int, int]:
    """K2: the lanes, nine u32 columns and the permutation read, one
    packed byte a row written."""
    return N * (4 * K + 4 * _REC_COLS + 4 + 1), 0


def compact_gather(N: int, K: int) -> tuple[int, int]:
    """K3: permutation and packed read, the eight columns read and
    written, the kept permutation and three counts written."""
    return N * (4 + 1 + 2 * (4 * K + 6 * 4 + 1) + 4) + 12, 0


def meta_block(n: int, K: int) -> tuple[int, int]:
    """K4: seven columns read (25 B a cell), the 25 B META block and the
    segment's stats written."""
    return n * 50 + 40, 0


def segment_scan(n: int, K: int) -> tuple[int, int]:
    """K5 on a segment of n rows: META (25 B a row) and the lanes read,
    the byte planes and two int32 results (best length and distance)
    per scanned byte written;
    four operations (compare, min, run, max) per byte and distance."""
    meta, lanes = 25 * n, 4 * K * n
    scanned = meta + lanes
    return meta + 2 * lanes + 8 * scanned, 4 * _DISTANCES * scanned


# the program's kernel names (its launch counters)
KERNELS = {"merge.sort_perm": sort_perm, "merge.reconcile": reconcile,
           "write.compact_gather": compact_gather,
           "write.meta_block": meta_block,
           "write.segment_scan": segment_scan}


def least_seconds(kernel: str, rows: int, K: int) -> tuple[float, str]:
    """The least time one launch needs, and which bound sets it."""
    nbytes, ops = KERNELS[kernel](rows, K)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


# the device functions of each kernel (csrc/sort.cu, reconcile.cu,
# compact.cu, meta.cu, lzscan.cu), by which the profiler's events are
# matched to it
FUNCTIONS = {"merge.sort_perm": ("plan_hist", "plan_bases", "plan_table",
                                 "split_pack", "round_pass"),
             "merge.reconcile": ("rec_tiles",),
             "write.compact_gather": ("cmp_partition", "cmp_gather"),
             "write.meta_block": ("meta_tiles",),
             "write.segment_scan": ("lz_segment",)}
_KERNEL_OF = {f: k for k, fs in FUNCTIONS.items() for f in fs}


def kernel_of(event: str) -> str | None:
    """The kernel whose device function a profiler event names (its
    demangled signature), or None."""
    head = event.replace("(anonymous namespace)", "").split("(", 1)[0]
    name = head.split("<", 1)[0].rsplit("::", 1)[-1].rsplit(" ", 1)[-1]
    return _KERNEL_OF.get(name)
