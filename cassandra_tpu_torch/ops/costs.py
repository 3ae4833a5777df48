"""The least work of each kernel (K1-K10), from its shapes: the bytes it
must move, each input read once and each output written once, and, where
PERF.md's table counts them, its operations. One definition serves
`system_views.device_programs` (cost_bytes, cost_flops: the kernel's
most recent new shape, as the JAX package reports its XLA cost analysis
there) and chip_smoke.py, which divides them by the card's rates for
each kernel's bound."""
from __future__ import annotations

import math

# the run's stamp, key and mask columns that K2 reads beside the lanes:
# ts_h, ts_l, valid, ldt, expiring, cdel, death, purge_h, purge_l
_REC_COLS = 9


def sort_perm(N: int, K: int) -> tuple[int, int]:
    """K1: (valid, K lanes, ts_h, ts_l) read, perm written."""
    return N * ((K + 3) * 4 + 4), 0


def reconcile(N: int, K: int) -> tuple[int, int]:
    """K2: the lanes, nine u32 columns and perm read, packed written."""
    return N * (4 * K + 4 * _REC_COLS + 4 + 1), 0


def compact_gather(N: int, K: int) -> tuple[int, int]:
    """K3: perm and packed read, the eight columns read and written,
    perm_out and the three counts written."""
    return N * (4 + 1 + 2 * (4 * K + 6 * 4 + 1) + 4) + 12, 0


def meta_block(n: int) -> tuple[int, int]:
    """K4: seven columns read (25 B a cell), the 25 B META block
    written, and the stats."""
    return n * 50 + 40, 0


def segment_scan(meta_bytes: int, lane_bytes: int,
                 distances: int) -> tuple[int, int]:
    """K5: META and lanes read, the byte planes and four int32 arrays
    per scanned byte written; four operations per (position, distance):
    compare, min, run, max."""
    n_scan = meta_bytes + lane_bytes
    return (meta_bytes + 2 * lane_bytes + 8 * n_scan,
            4 * distances * n_scan)


def plane_fast(buf_bytes: int, N: int) -> tuple[int, int]:
    """K6: the packed buffer read, one byte a row written."""
    return buf_bytes + N, N * math.ceil(math.log2(max(N, 2))) * 4


def plane_v2(plane_bytes: int, N: int) -> tuple[int, int]:
    """K7: the planes read, (masks << 24) | perm written."""
    return plane_bytes + 4 * N, N * math.ceil(math.log2(max(N, 2))) * 5


def scan_mask(n: int) -> tuple[int, int]:
    """K9's mask: u64 keys read, a bool a key written."""
    return 9 * n, 0


def scan_fold(n: int) -> tuple[int, int]:
    """K9's fold: u64 keys and the mask read, count/min/max written."""
    return 9 * n + 24, 0


def ann(n: int, d: int, k: int, sim: str) -> tuple[int, int]:
    """K10: the matrix and the query read, k scores and indices written;
    a multiply and an add per element (cosine another two for the norm,
    euclidean a subtract, multiply and add)."""
    return (4 * n * d + 4 * d + 8 * k,
            {"cosine": 4, "dot": 2, "euclidean": 3}[sim] * n * d)


def mesh_step(S: int, N: int, K: int) -> tuple[int, int]:
    """K8: the operands read (lanes, nine columns), perm and packed
    written, plus the per-shard and summed stats."""
    return S * N * (4 * K + _REC_COLS * 4 + 4 + 1) + 16 * (S + 1), 0


def _nbytes(v) -> int:
    """Bytes of a plane: a tensor's storage, 4 for a u32 scalar."""
    return v.numel() * v.element_size() if hasattr(v, "numel") else 4


def _planes_fast(buf, cfg):
    from .merge import _fast_layout
    return plane_fast(buf.numel(), _fast_layout(buf, cfg)[0])


def _segment_scan(meta, lanes):
    from .device_compress import DISTANCES
    return segment_scan(meta.numel(), lanes.numel() * 4, len(DISTANCES))


# kernel name (cuda_lib.KERNELS) -> the cost of a call from its
# wrapper's arguments
_OF_CALL = {
    "merge.sort_perm": lambda ops: sort_perm(*ops["lanes"].shape),
    "merge.reconcile": lambda ops, perm: reconcile(*ops["lanes"].shape),
    "write.compact_gather":
        lambda ops, perm, packed: compact_gather(*ops["lanes"].shape),
    "write.meta_block": lambda ts_h, *cols: meta_block(ts_h.numel()),
    "write.segment_scan": _segment_scan,
    "merge.plane_fast": _planes_fast,
    "merge.plane_v2": lambda planes, cfg: plane_v2(
        sum(_nbytes(v) for v in planes.values()), planes["rank"].numel()),
    "scan.mask": lambda keys, kop, qkeys: scan_mask(keys.numel()),
    "scan.fold": lambda keys, mask: scan_fold(keys.numel()),
    "index.ann": lambda m, q, k, similarity="cosine": ann(
        m.shape[0], m.shape[1], k, similarity),
    "mesh.sharded_step": lambda ops: mesh_step(*ops["lanes"].shape),
}


def of(name: str):
    """The cost of one call of kernel `name`'s wrapper: a function of
    the wrapper's arguments giving (bytes, operations)."""
    return _OF_CALL[name]
