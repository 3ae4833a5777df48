"""Fused device scan: predicate masks and aggregate folds over value lanes.

Reference counterpart: the SAI query path (index/sai/plan) fused with
LUDA's thesis (PAPERS.md, arxiv 2004.03054) — when the host would touch
every byte anyway, move the per-cell work onto the accelerator. The
columnar "ce" segment layout already carries each column's cells as
(value offset, length) runs over one payload blob, so predicate
evaluation vectorizes without row assembly.

The trick that keeps ONE kernel per predicate shape instead of one per
CQL type: every supported column type maps monotonically into a single
u64 *scan key* space (`keys_from_values`), so comparison predicates on
values become unsigned comparisons on keys:

  i64     tinyint/smallint/int/bigint — sign-bias to u64 (exact)
  f64     float/double — widen to f64, IEEE total-order bits (exact;
          -0.0 normalized to 0.0 so key equality == value equality)
  bool    the serialized byte (exact)
  prefix  text/ascii/blob — first 8 bytes, zero-padded (monotone but
          NOT injective: masks are a SUPERSET and every candidate is
          re-verified by the executor's exact `_match`)

The same keys feed the flush-time zone maps (index/sstable_index.py):
a segment's (min key, max key) bounds every live cell, so
`prune_keep_mask` can drop whole segments without decoding them.

The `scan_device_filter` gate picks the leg: on, the predicate mask
and the count/min/max fold are kernel K9 (csrc/scanmask.cu) on the
store's torch device, with the u64 keys as native 64-bit words (torch
carries them as int64 bit patterns); off, the numpy `mask_host`. Both
legs compute identical results. A scan masks a run of consecutive
device-gated segments of one source with one launch (`mask_run`, at
most RUN_KEYS keys): the keys go to the card in one copy from pinned
memory and the mask comes back in one, with one wait per run. With
the gate on nothing falls back to
the host: a CUDA device launches the kernel or raises, and only a CPU
device runs K9's plain PyTorch version (`scan_mask_plain`,
`scan_fold_plain`). The NaN fix-up (`nan_fix`) and the SUM stay on the
host over the mask, as in the JAX package: the sum needs an exact
64-bit accumulator over the selected keys.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .. import device as devmod
from ..schema import ColumnKind, TableMetadata
from ..service.profiling import GLOBAL as _kprof
from . import costs, cuda_lib
from .merge import _check

_BIAS = 1 << 63
_U64_MAX = (1 << 64) - 1
_SIGN64 = np.uint64(_BIAS)

#: kinds whose key space is order-isomorphic AND injective to the value
#: space — key comparisons reproduce `_match` exactly (modulo the NaN
#: fixup `nan_fix` applies); prefix keys are conservative supersets.
EXACT_KINDS = frozenset({"i64", "f64", "bool"})


# ------------------------------------------------------------------ kinds --

def zone_kind(cql_type):
    """(kind, width) for a column type the scan lane understands, else
    None. Deliberately narrow: counters reconcile by shard-summing,
    collections compare whole reassembled containers, and the
    object-valued types (timestamp/date/uuid/...) deserialize to Python
    objects whose ordering the key space does not model."""
    from ..types import marshal as m
    t = cql_type
    if getattr(t, "is_counter", False) or getattr(t, "is_collection", False) \
            or getattr(t, "is_multicell", False):
        return None
    cls = type(t)   # exact class: TimestampType subclasses the int kinds
    if cls in (m.TinyIntType, m.SmallIntType, m.Int32Type, m.LongType):
        return ("i64", t.width)
    if cls is m.FloatType:
        return ("f64", 4)
    if cls is m.DoubleType:
        return ("f64", 8)
    if cls is m.BooleanType:
        return ("bool", 1)
    if cls in (m.TextType, m.AsciiType, m.BlobType):
        return ("prefix", 0)
    return None


def zonemap_columns(table: TableMetadata) -> list[tuple[int, str, int]]:
    """[(column_id, kind, width)] for every regular/static column the
    zone maps cover, ascending column id (the on-disk order)."""
    out = []
    for col in table.static_columns + table.regular_columns:
        kw = zone_kind(col.cql_type)
        if kw is not None:
            out.append((col.column_id, kw[0], kw[1]))
    out.sort()
    return out


# ---------------------------------------------------------------- scan keys --

def _fold_be(b: np.ndarray) -> np.ndarray:
    """Big-endian fold of a [n, w] uint8 byte matrix into u64."""
    k = np.zeros(len(b), dtype=np.uint64)
    for j in range(b.shape[1]):
        k = (k << np.uint64(8)) | b[:, j].astype(np.uint64)
    return k


def _f64_order(vals: np.ndarray) -> np.ndarray:
    """IEEE-754 total-order transform: monotone f64 -> u64 (after
    normalizing -0.0 to 0.0 so key equality equals value equality)."""
    vals = vals + 0.0           # -0.0 + 0.0 == +0.0
    bits = np.ascontiguousarray(vals, dtype=np.float64).view(np.uint64)
    neg = (bits >> np.uint64(63)) != 0
    return np.where(neg, ~bits, bits | _SIGN64)


def keys_from_values(kind: str, width: int, payload: np.ndarray,
                     vs: np.ndarray, ve: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """u64 scan keys for value byte-ranges [vs, ve) of `payload`.
    Returns (keys, valid): a cell whose stored length does not fit the
    kind gets valid=False (callers widen it to "matches anything" —
    conservative, and such cells cannot appear through the write path).
    """
    n = len(vs)
    keys = np.zeros(n, dtype=np.uint64)
    ln = ve - vs
    if n == 0:
        return keys, np.ones(0, dtype=bool)
    if len(payload) == 0:       # all-empty frames: nothing to gather
        payload = np.zeros(1, dtype=np.uint8)
    if kind == "prefix":
        take = np.minimum(ln, 8)
        idx = vs[:, None] + np.arange(8, dtype=vs.dtype)[None, :]
        have = np.arange(8)[None, :] < take[:, None]
        b = np.where(have,
                     payload[np.minimum(idx, len(payload) - 1)],
                     np.uint8(0))
        return _fold_be(b), np.ones(n, dtype=bool)
    valid = ln == width
    safe_vs = np.where(valid, vs, 0)
    idx = safe_vs[:, None] + np.arange(width, dtype=vs.dtype)[None, :]
    b = payload[np.minimum(idx, len(payload) - 1)].reshape(n, width)
    raw = _fold_be(b)
    if kind == "bool":
        return raw, valid
    if kind == "i64":
        sign = np.uint64(1 << (8 * width - 1))
        keys = (raw ^ sign) + np.uint64(_BIAS - (1 << (8 * width - 1)))
        return keys, valid
    # f64: widen the stored IEEE float to f64, then total-order
    if width == 4:
        vals = raw.astype(np.uint32).view(np.float32).astype(np.float64)
    else:
        vals = raw.view(np.float64)
    return _f64_order(vals), valid


def key_of_value(kind: str, value) -> int | None:
    """Scan key of a BOUND Python value (the post-bind literal), or None
    when the value cannot be keyed exactly — the caller falls back.
    Bound keys are computed from the Python value directly, never
    through a serialize round-trip: FloatType.serialize would truncate
    an f8 bound to f4 and diverge from `_match`'s f8 comparison."""
    if kind == "bool":
        return int(value) if isinstance(value, bool) else None
    if kind == "i64":
        if isinstance(value, bool) or not isinstance(value, int):
            return None
        if not (-_BIAS <= value < _BIAS):
            return None
        return value + _BIAS
    if kind == "f64":
        if isinstance(value, bool):
            return None
        if isinstance(value, int):
            if float(value) != value:
                return None     # not exactly representable: key order
            value = float(value)  # could disagree with int comparison
        if not isinstance(value, float) or value != value:
            return None         # NaN bound: _match is all-False anyway
        return int(_f64_order(np.array([value]))[0])
    if kind == "prefix":
        if isinstance(value, str):
            try:
                value = value.encode("utf-8")
            except UnicodeEncodeError:
                return None
        if not isinstance(value, (bytes, bytearray)):
            return None
        b = bytes(value)[:8]
        return int.from_bytes(b + b"\x00" * (8 - len(b)), "big")
    return None


def value_of_key(kind: str, key: int):
    """Inverse of the key map for the exact kinds (min/max fold results
    come back from the device as keys)."""
    if kind == "i64":
        return key - _BIAS
    if kind == "bool":
        return bool(key)
    if kind == "f64":
        bits = key ^ _BIAS if key >= _BIAS else ~key & _U64_MAX
        return struct.unpack(">d", bits.to_bytes(8, "big"))[0]
    raise ValueError(f"kind {kind!r} has no exact inverse")


# ------------------------------------------------------------- predicates --

class ScanKeyError(ValueError):
    """A stored cell whose width does not fit the predicate's key kind:
    the executor answers such a query with its row scan (counted as
    `scan.fallback`). The only error the pushdown hands back to the
    row scan."""


#: executor op -> (kernel op, still-exact) per kind family. Prefix keys
#: truncate, so strict ops widen to their inclusive forms and '!='
#: degenerates to "every live cell" — all supersets the executor's
#: exact `_match` re-verification shrinks back.
_EXACT_KOPS = {"=": "eq", "!=": "ne", "<": "lt", "<=": "le",
               ">": "gt", ">=": "ge", "IN": "in"}
_PREFIX_KOPS = {"=": "eq", "!=": "all", "<": "le", "<=": "le",
                ">": "ge", ">=": "ge", "IN": "in"}


class CompiledPredicate:
    """One pushdown-supported column filter, compiled to key space."""

    __slots__ = ("col_id", "col_name", "kind", "width", "op", "kop",
                 "qkeys", "exact", "is_static")

    def __init__(self, col_id, col_name, kind, width, op, kop, qkeys,
                 exact, is_static):
        self.col_id = col_id
        self.col_name = col_name
        self.kind = kind
        self.width = width
        self.op = op
        self.kop = kop
        self.qkeys = qkeys          # np.uint64[m]
        self.exact = exact
        self.is_static = is_static


def compile_predicate(table: TableMetadata, filters) -> CompiledPredicate | None:
    """Compile the FIRST pushdown-supported filter as the driving
    predicate (the remaining filters stay host-checked by the executor,
    which re-applies ALL of them to every candidate row). None when no
    filter is supported — the caller keeps the Python path."""
    for col, op, v in filters:
        kw = zone_kind(col.cql_type)
        if kw is None or col.kind not in (ColumnKind.REGULAR,
                                          ColumnKind.STATIC):
            continue
        kind, width = kw
        kops = _EXACT_KOPS if kind in EXACT_KINDS else _PREFIX_KOPS
        kop = kops.get(op)
        if kop is None:
            continue
        if op == "IN":
            if not isinstance(v, (list, tuple)):
                continue
            qk = [key_of_value(kind, x) for x in v]
            if any(k is None for k in qk):
                continue
        else:
            k = key_of_value(kind, v)
            if k is None:
                continue
            qk = [k]
        return CompiledPredicate(
            col.column_id, col.name, kind, width, op, kop,
            np.asarray(qk, dtype=np.uint64),
            kind in EXACT_KINDS,
            col.kind == ColumnKind.STATIC)
    return None


# ------------------------------------------------------- zone-map pruning --

def segment_zone_entries(zone_cols, col_lane, flags, vs, ve, payload):
    """Per-column (min_key, max_key, live, dead) rows for ONE segment —
    shared by the writer tail (flush/compaction) and the rebuild path.
    `dead` counts death-flagged cells of the column (tombstones at any
    scope); empty-range sentinels are (U64_MAX, 0). A cell the kind
    cannot key widens the column to the full key range (never prunes)."""
    from ..storage.cellbatch import DEATH_FLAGS
    col_lane = np.asarray(col_lane)
    flags = np.asarray(flags)
    out = []
    for cid, kind, width in zone_cols:
        sel = col_lane == cid
        n_col = int(sel.sum())
        if n_col == 0:
            out.append((_U64_MAX, 0, 0, 0))
            continue
        alive = sel & ((flags & DEATH_FLAGS) == 0)
        live = int(alive.sum())
        dead = n_col - live
        if live == 0:
            out.append((_U64_MAX, 0, 0, dead))
            continue
        idx = np.flatnonzero(alive)
        keys, valid = keys_from_values(kind, width, payload,
                                       vs[idx], ve[idx])
        if not valid.all():
            out.append((0, _U64_MAX, live, dead))
            continue
        out.append((int(keys.min()), int(keys.max()), live, dead))
    return out


def prune_keep_mask(kmin, kmax, live, pred: CompiledPredicate) -> np.ndarray:
    """bool[n_segments] — True where the segment MAY hold a live cell
    matching pred and must be decoded. Conservative by construction:
    keys are monotone, so value a <= b implies key(a) <= key(b), and a
    matching cell's key always lands inside [kmin, kmax]."""
    keep = live > 0
    kop = pred.kop
    if kop == "all":
        return keep
    q = pred.qkeys
    if kop == "eq":
        return keep & (kmin <= q[0]) & (q[0] <= kmax)
    if kop == "in":
        any_in = np.zeros(len(kmin), dtype=bool)
        for qk in q:
            any_in |= (kmin <= qk) & (qk <= kmax)
        return keep & any_in
    if kop in ("lt", "le"):
        return keep & (kmin <= q[0]) if kop == "le" \
            else keep & (kmin < q[0])
    if kop in ("gt", "ge"):
        return keep & (kmax >= q[0]) if kop == "ge" \
            else keep & (kmax > q[0])
    if kop == "ne":
        # exact kinds only: a segment where every live cell IS the
        # bound can never match !=
        return keep & ~((kmin == q[0]) & (kmax == q[0]))
    raise ValueError(f"unknown kernel op {kop!r}")


# ------------------------------------------------------------ mask kernels --
# K9 on u64 keys held as int64 bit patterns. The plain versions compare
# unsigned order as signed int64 after flipping the sign bit (torch has
# no unsigned 64-bit compare on the CPU).

#: kernel op -> csrc/scanmask.cu ScanOp code
SCAN_OPS = {"eq": 0, "ne": 1, "lt": 2, "ge": 3, "gt": 4, "le": 5,
            "in": 6, "all": 7}
_SIGN_I64 = -(1 << 63)


#: keys per K9 launch of a scan's run of segments (8 MB of keys, 1 MB
#: of mask): a run ends at a host-gated segment, at the end of a source,
#: or before a segment that would take it past this cap, which bounds
#: the segments a scan holds until their mask is back (16 full ones)
RUN_KEYS = 1 << 20


def keys_tensor(keys: np.ndarray, device) -> torch.Tensor:
    """u64 keys (numpy) as the int64 tensor of their bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(
        keys, dtype=np.uint64).view(np.int64)).to(device)


def scan_mask_plain(keys: torch.Tensor, kop: str,
                    qkeys: np.ndarray) -> torch.Tensor:
    """Plain PyTorch K9 mask (bool[n])."""
    if kop == "all":
        return torch.ones(keys.shape[0], dtype=torch.bool,
                          device=keys.device)
    q = keys_tensor(qkeys, keys.device)
    if kop == "in":
        return torch.isin(keys, q)
    if kop in ("eq", "ne"):
        return keys == q[0] if kop == "eq" else keys != q[0]
    a, b = keys ^ _SIGN_I64, q[0] ^ _SIGN_I64
    return {"lt": torch.lt, "ge": torch.ge, "gt": torch.gt,
            "le": torch.le}[kop](a, b)


def _scan_mask_cuda(keys: torch.Tensor, kop: str,
                    qkeys: np.ndarray) -> torch.Tensor:
    dev = keys.device
    n = keys.shape[0]
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        _check(keys, "keys", torch.int64, (n,), dev)     # raises
    op = SCAN_OPS[kop]
    lib = cuda_lib.lib()
    with cuda_lib.on_device(dev):
        out = torch.empty(n, dtype=torch.bool, device=dev)
        if kop == "in":
            qlist = keys_tensor(qkeys, dev)
            q0, qptr, m = 0, qlist.data_ptr(), qlist.shape[0]
        else:   # the single bound by value; no list (a null pointer)
            q0, qptr, m = int(qkeys[0]) if len(qkeys) else 0, None, 0
        rc = lib.ctpu_scan_mask(keys.data_ptr(), n, op, q0, qptr, m,
                                out.data_ptr(), cuda_lib.raw_stream(dev))
        if rc:
            cuda_lib.check(rc, "ctpu_scan_mask")
        cuda_lib.count_launch("scan.mask", n)
    return out


def scan_mask(keys: torch.Tensor, kop: str,
              qkeys: np.ndarray) -> torch.Tensor:
    """K9's predicate mask: bool[n], True where key <kop> the bound
    (qkeys[0]; any of qkeys for "in", none when qkeys is empty; every
    key for "all"). keys: int64[n] bit patterns of the u64 keys. CUDA
    tensors launch the kernel; CPU tensors run `scan_mask_plain`."""
    if keys.is_cuda or cuda_lib.is_cuda(keys):
        return _scan_mask_cuda(keys, kop, qkeys)
    return scan_mask_plain(keys, kop, qkeys)


scan_mask = _kprof.wrap("scan.mask", scan_mask, cost=costs.of("scan.mask"))


def scan_fold_plain(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9 fold: int64[3] = (count, min, max) of the keys
    under the mask, min and max as u64 bit patterns, sentinels
    (0, U64_MAX, 0) for an empty mask."""
    a = keys ^ _SIGN_I64
    imax = torch.iinfo(torch.int64).max
    mn = torch.where(mask, a, imax).min() if len(a) else \
        torch.tensor(imax, device=keys.device)
    mx = torch.where(mask, a, _SIGN_I64).max() if len(a) else \
        torch.tensor(_SIGN_I64, device=keys.device)
    return torch.stack([mask.sum(), mn ^ _SIGN_I64, mx ^ _SIGN_I64])


def _scan_fold_cuda(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    dev = keys.device
    n = keys.shape[0]
    _check(keys, "keys", torch.int64, (n,), dev)
    _check(mask, "mask", torch.bool, (n,), dev)
    lib = cuda_lib.lib()
    with cuda_lib.on_device(dev):
        out = torch.empty(3, dtype=torch.int64, device=dev)
        scratch = torch.empty(int(lib.ctpu_scan_fold_scratch_bytes(n)),
                              dtype=torch.uint8, device=dev)
        rc = lib.ctpu_scan_fold(keys.data_ptr(), mask.data_ptr(), n,
                                out.data_ptr(), scratch.data_ptr(),
                                cuda_lib.stream_of(keys))
        cuda_lib.check(rc, "ctpu_scan_fold")
        cuda_lib.count_launch("scan.fold", n)
    return out


def scan_fold(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K9's fold: int64[3] = (count, min key, max key) under the mask
    (keys as int64 bit patterns, mask bool[n]). CUDA tensors launch the
    kernel; CPU tensors run `scan_fold_plain`."""
    if cuda_lib.is_cuda(keys):
        return _scan_fold_cuda(keys, mask)
    return scan_fold_plain(keys, mask)


scan_fold = _kprof.wrap("scan.fold", scan_fold, cost=costs.of("scan.fold"))


def mask_run(keys_list: list, pred: CompiledPredicate,
             device=None) -> list:
    """K9 on `device` (default `cuda`) over the keys of a run of
    segments (numpy u64 arrays) in ONE launch, split back into one mask
    per segment, each bit-identical to `segment_mask`'s device leg (the
    NaN fix-up included). On a card the keys are staged in pinned host
    memory, copied once, and the mask comes back into pinned memory
    with one wait; the buffers belong to the call (mesh lanes scan on
    several threads at once)."""
    dev = devmod.resolve(device)
    if not keys_list:
        return []
    sizes = [len(k) for k in keys_list]
    n = sum(sizes)
    if dev.type == "cuda":
        staged = torch.empty(n, dtype=torch.int64, pin_memory=True)
        keys = staged.numpy().view(np.uint64)
        np.concatenate(keys_list, out=keys)
        with cuda_lib.on_device(dev):
            mt = scan_mask(staged.to(dev, non_blocking=True), pred.kop,
                           pred.qkeys)
            back = torch.empty(n, dtype=torch.bool, pin_memory=True)
            back.copy_(mt, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        mask = back.numpy()
    else:
        keys = np.concatenate(keys_list)
        mask = scan_mask(keys_tensor(keys, dev), pred.kop,
                         pred.qkeys).numpy()
    mask = nan_fix(mask, keys, pred)
    return np.split(mask, np.cumsum(sizes)[:-1])


def mask_device(keys: np.ndarray, pred: CompiledPredicate,
                device=None) -> np.ndarray:
    """Predicate mask evaluated by K9 on `device` (default `cuda`):
    bit-identical to mask_host for any input."""
    dev = devmod.resolve(device)
    return scan_mask(keys_tensor(keys, dev), pred.kop,
                     pred.qkeys).cpu().numpy()


def mask_host(keys: np.ndarray, pred: CompiledPredicate) -> np.ndarray:
    """Numpy reference for mask_device — the leg the gate picks off."""
    kop, q = pred.kop, pred.qkeys
    if kop == "all":
        return np.ones(len(keys), dtype=bool)
    if kop == "in":
        out = np.zeros(len(keys), dtype=bool)
        for qk in q:
            out |= keys == qk
        return out
    ops = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
           "le": np.less_equal, "gt": np.greater,
           "ge": np.greater_equal}
    return ops[kop](keys, q[0])


def nan_fix(mask: np.ndarray, keys: np.ndarray,
            pred: CompiledPredicate) -> np.ndarray:
    """Align key-space masks with Python NaN semantics: `_match` is
    False for every comparison against a NaN cell EXCEPT '!=' (which is
    True). NaN keys sit outside the finite total-order run, so patch
    them explicitly; other kinds pass through untouched."""
    if pred.kind != "f64" or not len(mask):
        return mask
    kinf = _f64_order(np.array([np.inf, -np.inf]))
    is_nan = (keys > kinf[0]) | (keys < kinf[1])
    if not is_nan.any():
        return mask
    mask = mask.copy()
    mask[is_nan] = pred.op == "!="
    return mask


def segment_mask(keys: np.ndarray, pred: CompiledPredicate,
                 use_device: bool, device=None) -> tuple[np.ndarray, bool]:
    """(mask, ran_on_device). use_device: K9 on `device` (default
    `cuda`), which launches or raises; else the numpy mask."""
    if use_device:
        return mask_run([keys], pred, device)[0], True
    return nan_fix(mask_host(keys, pred), keys, pred), False


# ----------------------------------------------------------- batch helpers --

def batch_predicate_cells(batch, pred: CompiledPredicate,
                          reconciled: bool
                          ) -> tuple[np.ndarray, np.ndarray]:
    """(cell indices, u64 keys) of the predicate column's live cells in
    a CellBatch. reconciled=False (write-order segments / memtable):
    live means no death flag — a superset is fine, the executor
    re-verifies. reconciled=True (merge_sorted output): live means
    exactly what rows_from_batch would surface as a non-null value.
    A cell the kind cannot key keeps key 0 with its index returned in
    the caller-visible `keys` as-is only when valid — invalid cells
    raise, matching the naive path's deserialize failure."""
    from ..storage.cellbatch import (DEATH_FLAGS, FLAG_COMPLEX_DEL,
                                     FLAG_TOMBSTONE)
    n = len(batch)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    C = batch.n_lanes - 9
    cols = np.asarray(batch.lanes[:, 6 + C])
    flags = np.asarray(batch.flags)
    deadbits = (FLAG_TOMBSTONE | FLAG_COMPLEX_DEL) if reconciled \
        else DEATH_FLAGS
    sel = np.flatnonzero((cols == pred.col_id) & ((flags & deadbits) == 0))
    if not len(sel):
        return sel, np.zeros(0, dtype=np.uint64)
    off = np.asarray(batch.off)
    vs = np.asarray(batch.val_start)[sel]
    ve = off[sel + 1]
    payload = np.asarray(batch.payload)
    keys, valid = keys_from_values(pred.kind, pred.width, payload, vs, ve)
    if not valid.all():
        raise ScanKeyError(
            f"column {pred.col_name}: stored cell width does not fit "
            f"kind {pred.kind}")
    return sel, keys


def fold_batch(batch, pred: CompiledPredicate, use_device: bool,
               device=None
               ) -> tuple[int, int | None, int | None, int, bool]:
    """Exact aggregate partials over a RECONCILED batch: (count,
    min_key, max_key, int_sum, ran_on_device). Only called for exact
    predicate kinds, so the mask equals `_match` row for row; the i64
    sum is exact because the executor only pushes SUM/AVG for integer
    widths <= 4 bytes (no 64-bit overflow for any realistic row count).
    use_device: the mask and the count/min/max fold are K9 on `device`
    (default `cuda`), which launches or raises; the NaN fix-up between
    them and the sum run on the host.
    """
    sel, keys = batch_predicate_cells(batch, pred, reconciled=True)
    if not len(sel):
        return 0, None, None, 0, use_device
    if use_device:
        dev = devmod.resolve(device)
        kt = keys_tensor(keys, dev)
        mt = scan_mask(kt, pred.kop, pred.qkeys)
        raw = mt.cpu().numpy()
        mask = nan_fix(raw, keys, pred)
        if mask is not raw:
            mt = torch.from_numpy(mask).to(dev)
        cnt, kmin, kmax = (int(v) & _U64_MAX
                           for v in scan_fold(kt, mt).tolist())
        if cnt == 0:
            return 0, None, None, 0, True
    else:
        mask = nan_fix(mask_host(keys, pred), keys, pred)
        cnt = int(mask.sum())
        if cnt == 0:
            return 0, None, None, 0, False
        kmin, kmax = int(keys[mask].min()), int(keys[mask].max())
    sel_keys = keys[mask]
    total = 0
    if pred.kind == "i64":
        vals = (sel_keys ^ _SIGN64).view(np.int64)
        total = int(vals.sum())
    elif pred.kind == "bool":
        total = int(sel_keys.sum())
    return cnt, kmin, kmax, total, use_device
