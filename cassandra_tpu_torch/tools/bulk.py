"""Vectorised bulk cell generation — the cassandra-stress data path.

Reference counterpart: tools/stress (workload generation) and
CQLSSTableWriter (offline bulk writes). Builds CellBatches with zero
per-cell Python: lanes, hashes, and payload frames are all assembled with
numpy. Used by bench.py, the stress tool, and the multichip dry run.
"""
from __future__ import annotations

import numpy as np

from ..schema import COL_REGULAR_BASE, TableMetadata
from ..storage.cellbatch import CellBatch, CellBatchBuilder, lanes_for_table
from ..utils import murmur3

_BIAS = 1 << 63


def _int_pk_bytes(pk_ints: np.ndarray) -> np.ndarray:
    """(n, 4) uint8 matrix of Int32Type-serialized keys."""
    return np.ascontiguousarray(
        pk_ints.astype(">i4")).view(np.uint8).reshape(-1, 4)


def _ck_frame_and_comp(ck_ints: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For int32 clustering values: the serialized frame (vint len 4 + BE
    bytes = 5B) and the escaped byte-comparable composite (sign-flipped BE,
    0x00 escaped, 0x00 0x00 terminated). Escaping is value-dependent, so we
    build per-byte expansion masks vectorised."""
    n = len(ck_ints)
    ser = np.ascontiguousarray(ck_ints.astype(">i4")).view(
        np.uint8).reshape(n, 4)
    frame = np.zeros((n, 5), dtype=np.uint8)
    frame[:, 0] = 4          # vint length 4 (single byte)
    frame[:, 1:] = ser
    # byte-comparable: flip sign bit then escape 0x00 -> 0x00 0x01
    bc = ser.copy()
    bc[:, 0] ^= 0x80
    is_zero = bc == 0
    out_len = 4 + is_zero.sum(axis=1) + 2   # escapes + terminator
    width = int(out_len.max())
    comp = np.zeros((n, width), dtype=np.uint8)
    # positions: each source byte emits 1 or 2 bytes
    emit = 1 + is_zero.astype(np.int64)
    pos = np.zeros((n, 4), dtype=np.int64)
    pos[:, 1:] = np.cumsum(emit, axis=1)[:, :-1]
    rows = np.arange(n)[:, None]
    comp[rows, pos] = bc
    esc_rows, esc_cols = np.nonzero(is_zero)
    comp[esc_rows, pos[esc_rows, esc_cols] + 1] = 0x01
    # terminator 0x00 0x00 already zeros; lengths vector marks true end
    return frame, comp, out_len


def build_int_batch(table: TableMetadata, pk_ints: np.ndarray,
                    ck_ints: np.ndarray, values: np.ndarray,
                    ts: np.ndarray, column_id: int = COL_REGULAR_BASE,
                    ) -> CellBatch:
    """Bulk CellBatch for a table with int pk, single int clustering, and
    one regular column. values: (n, L) uint8. Fully vectorised."""
    n = len(pk_ints)
    assert len(ck_ints) == n and len(values) == n and len(ts) == n
    K = lanes_for_table(table)
    C = table.clustering_lanes

    pk_mat = _int_pk_bytes(pk_ints)
    # token + pk hash lanes (pad to 32-byte width for the hasher)
    padded = np.zeros((n, 32), dtype=np.uint8)
    padded[:, :4] = pk_mat
    lens4 = np.full(n, 4, dtype=np.int64)
    h1, h2 = murmur3.hash128_mat(padded, lens4)
    from ..utils import partitioners
    part = partitioners.current()
    if isinstance(part, partitioners.Murmur3Partitioner):
        # identity hash already computed h1: derive the token from it
        # instead of hashing every key a second time
        tok = h1.astype(np.int64)
        tok = np.where(tok == np.iinfo(np.int64).min,
                       np.iinfo(np.int64).max, tok)
    else:
        tok = part.tokens_mat(padded, lens4)
    with np.errstate(over="ignore"):
        ut = tok.astype(np.uint64) ^ np.uint64(_BIAS)

    frame5, comp, comp_len = _ck_frame_and_comp(ck_ints)
    # clustering hash over the composite
    cwidth = ((comp.shape[1] + 15) // 16 + 1) * 16
    cpad = np.zeros((n, cwidth), dtype=np.uint8)
    cpad[:, : comp.shape[1]] = comp
    ch1, _ = murmur3.hash128_mat(cpad, comp_len)

    lanes = np.zeros((n, K), dtype=np.uint32)
    lanes[:, 0] = (ut >> np.uint64(32)).astype(np.uint32)
    lanes[:, 1] = (ut & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lanes[:, 2] = (h2 >> np.uint64(32)).astype(np.uint32)
    lanes[:, 3] = (h2 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    # clustering prefix lanes: big-endian pack of comp bytes
    prefix = np.zeros((n, 4 * C), dtype=np.uint8)
    take = min(4 * C, comp.shape[1])
    prefix[:, :take] = comp[:, :take]
    lanes[:, 4:4 + C] = prefix.reshape(n, C, 4).astype(np.uint32) @ \
        np.array([1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32)
    lanes[:, 4 + C] = (ch1 >> np.uint64(32)).astype(np.uint32)
    lanes[:, 5 + C] = (ch1 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lanes[:, 6 + C] = column_id
    # path lanes stay 0

    # payload frames: [vint ck_len=5][frame5][vint path_len=0][value]
    Lv = values.shape[1]
    frame_len = 1 + 5 + 1 + Lv
    payload = np.zeros((n, frame_len), dtype=np.uint8)
    payload[:, 0] = 5
    payload[:, 1:6] = frame5
    payload[:, 6] = 0
    payload[:, 7:] = values
    off = np.arange(n + 1, dtype=np.int64) * frame_len
    val_start = off[:-1] + 7

    pk_map = {}
    lane4_be = np.ascontiguousarray(lanes[:, :4].astype(">u4"))
    uniq = np.unique(pk_ints, return_index=True)[1]
    for i in uniq:
        pk_map[lane4_be[i].tobytes()] = bytes(pk_mat[i])

    out = CellBatch(lanes, np.asarray(ts, dtype=np.int64),
                    np.full(n, 0x7FFFFFFF, dtype=np.int32),
                    np.zeros(n, dtype=np.int32),
                    np.zeros(n, dtype=np.uint8),
                    off, val_start, payload.reshape(-1),
                    pk_map, sorted=False)
    out.ck_comp = table.clustering_comp
    out.ck_fits_prefix = int(comp_len.max(initial=0)) <= 4 * C
    return out


def selfcheck(table: TableMetadata) -> None:
    """The fast path must agree exactly with CellBatchBuilder."""
    pk = np.array([5, -3, 1000], dtype=np.int64)
    ck = np.array([7, 0, -200], dtype=np.int64)
    ts = np.array([10, 20, 30], dtype=np.int64)
    vals = np.frombuffer(b"aaaBBBccc", dtype=np.uint8).reshape(3, 3)
    fast = build_int_batch(table, pk, ck, vals, ts)
    slow = CellBatchBuilder(table)
    idt = table.partition_key_columns[0].cql_type
    for i in range(3):
        slow.add_cell(idt.serialize(int(pk[i])),
                      table.serialize_clustering([int(ck[i])]),
                      COL_REGULAR_BASE, bytes(vals[i]), int(ts[i]))
    sb = slow.seal()
    np.testing.assert_array_equal(fast.lanes, sb.lanes)
    np.testing.assert_array_equal(fast.payload, sb.payload)
    np.testing.assert_array_equal(fast.off, sb.off)
    np.testing.assert_array_equal(fast.val_start, sb.val_start)
    assert fast.pk_map == sb.pk_map
