"""Device-resident compaction rounds: merge → purge → segment-cut →
serialize without bouncing cell columns through the host (counterpart of
cassandra_tpu/ops/device_write.py).

Each round runs three kernels on the card: the sort (K1) and the
reconcile (K2) of ops/merge.py, then the kept-first compaction and
column gather (K3, `compact_gather`, csrc/compact.cu), so the round's
fixed-width columns (lanes / ts / ldt / ttl / flags / frame offsets)
stay on the device in output order, kept cells first. They wait in the
write lane's device pending buffer across rounds; segment cuts slice
them on the device, and the META serializer (K4, `meta_block_kernel`,
csrc/meta.cu) writes each full segment's META block, byte-identical to
the host serializer (storage/sstable/writer.py build_meta_block). The
host receives the finished META bytes, the row-major LANES matrix
`segment_pack` wants, and the kept permutation for the payload gather;
the variable-length payload never goes to the device.

Byte identity with the serial host path is exact: rounds the device
cannot reproduce exactly are materialized on the host per round —

  * equal-(identity, ts) duplicate runs (the host resolves them with
    full values, `merge.host_tiebreak`),
  * kept expired-TTL cells (tombstone conversion rewrites flags AND
    drops the value bytes),
  * range-tombstone bounds (host-only reconcile, as in the JAX package),
  * counter rounds (the plane program K7 through `merge.submit_merge`,
    then the host's counter summation).

When the writer's device-compress gate is on, each full segment also
runs the LZ4 policy scan on the card (K5, ops/device_compress.py
`segment_scan`) over the META block K4 left there and the segment's
lanes; the host pulls the byte planes and the match arrays and only
emits the LZ4 sequences (`pack_device_segment`).

`submit_merge_resident` only launches; `collect_merge_resident`
synchronises through one small copy of the three counts.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as devmod
from ..service.profiling import GLOBAL as _kprof
from ..storage.cellbatch import (DEATH_FLAGS, FLAG_COUNTER,
                                 FLAG_RANGE_BOUND, CellBatch)
from . import cuda_lib
from . import device_compress
from . import merge as dmerge

_BIAS_H = 0x80000000  # high u32 word of the 2^63 timestamp bias
_SIGN64 = -(1 << 63)   # int64 with only the sign bit set


# ------------------------------------------------------------- operands --

def build_resident_operands(cat: CellBatch, gc_before: int, now: int,
                            purgeable_ts_fn):
    """The packed operands (merge.build_operands) extended with the
    serialize-side columns: full flags byte, ttl, u32 frame lengths and
    value offsets, as numpy. Returns (operands, pts_host) or None when a
    frame exceeds the u32 lanes."""
    n = len(cat)
    N = dmerge._bucket(n)
    lens64 = cat.off[1:] - cat.off[:-1]
    vrel64 = cat.val_start - cat.off[:-1]
    if n and (int(lens64.max()) >= 1 << 32
              or int(vrel64.max()) >= 1 << 32):
        return None
    pts_host = None
    if purgeable_ts_fn is not None:
        pts_host = purgeable_ts_fn(cat).astype(np.int64)
        fn = lambda _c: pts_host  # noqa: E731
    else:
        fn = None
    operands = dmerge.build_operands(cat, gc_before=gc_before, now=now,
                                     purgeable_ts_fn=fn, bucket=N)
    flags8 = np.zeros(N, dtype=np.uint8)
    flags8[:n] = cat.flags
    ttl = np.zeros(N, dtype=np.int32)
    ttl[:n] = cat.ttl
    fl = np.zeros(N, dtype=np.uint32)
    fl[:n] = lens64.astype(np.uint32)
    vr = np.zeros(N, dtype=np.uint32)
    vr[:n] = vrel64.astype(np.uint32)
    operands["flags8"] = flags8
    operands["ttl"] = ttl
    operands["fl"] = fl
    operands["vr"] = vr
    return operands, pts_host


RESIDENT_COLS = ("lanes", "ts_h", "ts_l", "ldt", "ttl", "flags8",
                 "fl", "vr")
# a segment's three block streams, in stored order (metric names)
PACK_BLOCKS = ("meta", "lanes", "payload")


# --------------------------------------------------- K3: compact + gather --

def compact_gather_plain(operands, perm, packed):
    """Plain PyTorch K3: (counts int32[3] = n_keep, n_amb, n_exp_kept;
    perm_out, the stable kept-first reorder of perm; the RESIDENT_COLS
    gathered through perm_out)."""
    keep = (packed & 1) != 0
    amb = (packed & 2) != 0
    expired = (packed & 4) != 0
    counts = torch.stack([keep.sum(), amb.sum(),
                          (expired & keep).sum()]).to(torch.int32)
    order = torch.cat([torch.nonzero(keep).flatten(),
                       torch.nonzero(~keep).flatten()])
    perm_out = perm[order]
    idx = perm_out.to(torch.int64)
    cols = {k: operands[k][idx] for k in RESIDENT_COLS}
    return counts, perm_out, cols


def _compact_gather_cuda(operands, perm, packed):
    N, K = dmerge._check_operands(operands)
    lanes = operands["lanes"]
    dev = lanes.device
    dmerge._check(perm, "perm", torch.int32, (N,), dev)
    dmerge._check(packed, "packed", torch.uint8, (N,), dev)
    for k in ("ttl", "fl", "vr"):
        dmerge._check(operands[k], k, torch.int32, (N,), dev)
    dmerge._check(operands["flags8"], "flags8", torch.uint8, (N,), dev)
    lib = cuda_lib.lib()
    with torch.cuda.device(dev):
        counts = torch.zeros(3, dtype=torch.int32, device=dev)
        perm_out = torch.empty(N, dtype=torch.int32, device=dev)
        cols = {k: torch.empty_like(operands[k]) for k in RESIDENT_COLS}
        scratch = torch.empty(lib.ctpu_compact_scratch_bytes(N),
                              dtype=torch.uint8, device=dev)
        rc = lib.ctpu_compact_gather(
            perm.data_ptr(), packed.data_ptr(), N, K,
            *[operands[k].data_ptr() for k in RESIDENT_COLS],
            counts.data_ptr(), perm_out.data_ptr(),
            *[cols[k].data_ptr() for k in RESIDENT_COLS],
            scratch.data_ptr(), cuda_lib.stream_of(lanes))
        cuda_lib.check(rc, "ctpu_compact_gather")
        cuda_lib.count_launch("write.compact_gather", N)
    return counts, perm_out, cols


def compact_gather(operands, perm, packed):
    """K3: counts, the kept-first permutation and the gathered columns.
    CUDA operands launch the kernel; CPU operands run
    `compact_gather_plain`."""
    if dmerge._on_cuda(operands):
        return _compact_gather_cuda(operands, perm, packed)
    return compact_gather_plain(operands, perm, packed)


compact_gather = _kprof.wrap("write.compact_gather", compact_gather)


def resident_program(operands):
    """K1 + K2 + K3, the JAX package's `_resident_program`: (counts =
    [n_keep, n_amb, n_exp_kept], perm_out, cols, perm, packed), the
    merged round in output order with kept cells first; perm and packed
    feed the host fallback when the counts demand it."""
    perm = dmerge.device_sort_perm(operands)
    packed = dmerge.reconcile_kernel(operands, perm)
    counts, perm_out, cols = compact_gather(operands, perm, packed)
    return counts, perm_out, cols, perm, packed


# ------------------------------------------------- K4: serialize kernel --

def meta_block_plain(ts_h, ts_l, ldt, ttl, flags8, fl, vr):
    """Plain PyTorch K4: (META block u8[25 n], stats int64[5]) — the "ce"
    ts-delta over the biased (hi, lo) pairs plus the 25 B/cell layout;
    stats hold min/max ts as packed (h << 32) | l bit patterns, min/max
    ldt and the tombstone count (decode with `meta_stats`)."""
    dev = ts_h.device
    h = dmerge._wide(ts_h)
    lo = dmerge._wide(ts_l)
    ph = torch.cat([torch.full((1,), _BIAS_H, dtype=torch.int64,
                               device=dev), h[:-1]])
    pl = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), lo[:-1]])
    d_l = (lo - pl) & dmerge._U32
    d_h = (h - ph - (lo < pl).to(torch.int64)) & dmerge._U32

    def i32(a):   # u32 values held in int64 -> their int32 bit patterns
        return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)

    def u8(a):
        return a.contiguous().view(torch.uint8).reshape(-1)

    meta = torch.cat([u8(torch.stack([i32(d_l), i32(d_h)], dim=1)),
                      u8(ldt), u8(ttl), flags8.reshape(-1), u8(fl), u8(vr)])
    ts = (h - _BIAS_H) * (1 << 32) + lo     # the signed timestamp
    ldt64 = ldt.to(torch.int64)
    tombs = ((flags8 & DEATH_FLAGS) != 0).sum()
    st = torch.stack([ts.min() ^ _SIGN64, ts.max() ^ _SIGN64,
                      ldt64.min(), ldt64.max(), tombs.to(torch.int64)])
    return meta, st


def _meta_block_cuda(ts_h, ts_l, ldt, ttl, flags8, fl, vr):
    n = ts_h.shape[0]
    dev = ts_h.device
    for name, t in (("ts_h", ts_h), ("ts_l", ts_l), ("ldt", ldt),
                    ("ttl", ttl), ("fl", fl), ("vr", vr)):
        dmerge._check(t, name, torch.int32, (n,), dev)
    dmerge._check(flags8, "flags8", torch.uint8, (n,), dev)
    lib = cuda_lib.lib()
    with torch.cuda.device(dev):
        meta = torch.empty(25 * n, dtype=torch.uint8, device=dev)
        # sentinels: u64 max, 0, i64 max, i64 min, 0 (fills, no copy)
        st = torch.zeros(5, dtype=torch.int64, device=dev)
        st[0] = -1
        st[2] = (1 << 63) - 1
        st[3] = -(1 << 63)
        rc = lib.ctpu_meta_block(
            ts_h.data_ptr(), ts_l.data_ptr(), ldt.data_ptr(),
            ttl.data_ptr(), flags8.data_ptr(), fl.data_ptr(),
            vr.data_ptr(), n, DEATH_FLAGS, meta.data_ptr(), st.data_ptr(),
            cuda_lib.stream_of(ts_h))
        cuda_lib.check(rc, "ctpu_meta_block")
        cuda_lib.count_launch("write.meta_block", n)
    return meta, st


def meta_block_kernel(ts_h, ts_l, ldt, ttl, flags8, fl, vr):
    """K4: the META block of one full segment and its stats. CUDA
    columns launch the kernel; CPU columns run `meta_block_plain`."""
    if ts_h.device.type == "cuda":
        return _meta_block_cuda(ts_h, ts_l, ldt, ttl, flags8, fl, vr)
    if ts_h.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for {ts_h.device!s}")
    return meta_block_plain(ts_h, ts_l, ldt, ttl, flags8, fl, vr)


meta_block_kernel = _kprof.wrap("write.meta_block", meta_block_kernel)


def meta_stats(st) -> tuple[int, int, int, int, int]:
    """(ts_min, ts_max, ldt_min, ldt_max, tombstones) from the stats
    tensor of `meta_block_kernel` (one device-to-host copy)."""
    v = [int(x) for x in st.cpu().tolist()]
    return v[0] ^ _SIGN64, v[1] ^ _SIGN64, v[2], v[3], v[4]


def _u32_np(t: torch.Tensor) -> np.ndarray:
    """A device int32 column as its host u32 numpy array."""
    return t.cpu().numpy().view(np.uint32)


def _pull(tensors: list) -> list:
    """Device tensors as host numpy arrays. From a card they copy into
    pinned buffers behind the kernels on the current stream, then one
    synchronize."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in hosts]


# --------------------------------------------------------------- rounds --

class DeviceRound:
    """One merged round whose fixed-width columns live on the device
    (padded; `n` is the kept length). The payload side — the only
    ragged data — stays host-resident."""

    __slots__ = ("n", "cols", "payload", "off", "val_start", "pk_map",
                 "ck_fits_prefix")

    def __init__(self, n, cols, payload, off, val_start, pk_map,
                 ck_fits_prefix):
        self.n = n
        self.cols = cols
        self.payload = payload
        self.off = off
        self.val_start = val_start
        self.pk_map = pk_map
        self.ck_fits_prefix = ck_fits_prefix

    def __len__(self) -> int:
        return self.n


class ResidentHandle:
    __slots__ = ("mode", "result", "cat", "n", "out", "pts",
                 "gc_before", "now", "prof", "fallback", "device")


def submit_merge_resident(batches: list[CellBatch], gc_before: int = 0,
                          now: int = 0, purgeable_ts_fn=None,
                          prof: dict | None = None,
                          device=None) -> ResidentHandle:
    """Launch one device-resident round (returns without waiting for
    the device). Range-bound rounds, counter rounds and oversized frames
    go through `merge.submit_merge` (the host for range bounds, the
    plane programs K6/K7 otherwise).
    device: where the round runs (default `cuda`; `cpu` runs the plain
    versions)."""
    import time as _time

    h = ResidentHandle()
    h.device = devmod.resolve(device)
    h.gc_before, h.now, h.prof = gc_before, now, prof
    h.fallback = None
    cat = CellBatch.concat(batches)
    h.cat, h.n = cat, len(cat)
    if h.n == 0:
        h.mode, h.result = "done", cat
        return h
    if ((cat.flags & (FLAG_RANGE_BOUND | FLAG_COUNTER)) != 0).any():
        h.mode = "host"
        h.fallback = dmerge.submit_merge(batches, gc_before, now,
                                         purgeable_ts_fn, prof=prof,
                                         device=h.device)
        return h
    t0 = _time.perf_counter()
    built = build_resident_operands(cat, gc_before, now, purgeable_ts_fn)
    if built is None:   # >= 4 GiB frame: the plane programs' round
        h.mode = "host"
        h.fallback = dmerge.submit_merge(batches, gc_before, now,
                                         purgeable_ts_fn, prof=prof,
                                         device=h.device)
        return h
    operands_np, h.pts = built
    operands = dmerge.operands_to_device(operands_np, h.device)
    t1 = _time.perf_counter()
    h.out = resident_program(operands)
    h.mode = "resident"
    if prof is not None:
        prof["pack"] = prof.get("pack", 0.0) + (t1 - t0)
    return h


def collect_merge_resident(h: ResidentHandle):
    """Wait for a resident round. Returns a DeviceRound (columns still
    on the device) for rounds the device reproduced exactly, else the
    host materialization lifted back onto the device."""
    import time as _time

    if h.mode == "done":
        return promote_round(h.result, h.device)
    if h.mode == "host":
        return promote_round(dmerge.collect_merge(h.fallback), h.device)
    cat, prof = h.cat, h.prof
    counts_d, perm_out_d, cols, perm_d, packed_d = h.out
    t0 = _time.perf_counter()
    n_keep, n_amb, n_exp_kept = (int(x) for x in counts_d.cpu().tolist())
    t1 = _time.perf_counter()
    _kprof.record_execute("merge.resident", t1 - t0)
    if prof is not None:
        prof["device"] = prof.get("device", 0.0) + (t1 - t0)

    if n_amb or n_exp_kept:
        # exact-resolution round: equal-(identity, ts) runs need the
        # host's full-value tie-break, kept expired cells need the
        # tombstone conversion's payload rewrite
        n = h.n
        perm = perm_d.cpu().numpy().astype(np.int64)[:n]
        keep, amb, expired, shadowed = dmerge.unpack_masks(
            packed_d.cpu().numpy()[:n])
        pts_sorted = h.pts[perm] if h.pts is not None else None
        if amb.any():
            dmerge.host_tiebreak(cat, perm, keep, amb, shadowed,
                                 expired, h.gc_before, pts_sorted)
        out = dmerge.finalize_merged(cat, perm, keep, expired, shadowed)
        if prof is not None:
            prof["gather"] = prof.get("gather", 0.0) \
                + (_time.perf_counter() - t1)
        return promote_round(out, h.device)

    # resident round: pull ONLY the kept permutation (the payload
    # gather's index vector) — the columns stay on the device
    perm_kept = perm_out_d[:n_keep].cpu().numpy().astype(np.int64)
    payload, off, val_start = _gather_payload(cat, perm_kept)
    if prof is not None:
        prof["gather"] = prof.get("gather", 0.0) \
            + (_time.perf_counter() - t1)
    return DeviceRound(n_keep, cols, payload, off, val_start,
                       dict(cat.pk_map), cat.ck_fits_prefix)


def promote_round(batch: CellBatch, device) -> DeviceRound:
    """Lift a host-materialized round onto the device so the write lane
    consumes ONE ordered stream. Values are copied verbatim, so the
    serialized bytes are identical to feeding the batch through the
    host writer."""
    n = len(batch)
    lens64 = batch.off[1:] - batch.off[:-1]
    vrel64 = batch.val_start - batch.off[:-1]
    if n and (int(lens64.max()) >= 1 << 32
              or int(vrel64.max()) >= 1 << 32):
        # mirror the host serializer's loud failure (writer._cut_segment)
        raise ValueError(
            f"cell frame exceeds the u32 offset lane "
            f"(max frame {int(lens64.max())} bytes)")
    with np.errstate(over="ignore"):
        uts = batch.ts.astype(np.uint64) ^ np.uint64(1 << 63)

    def put(a: np.ndarray) -> torch.Tensor:
        return dmerge.host_to_device(np.array(a, order="C"), device)

    i32 = dmerge._i32
    cols = {
        "lanes": put(i32(batch.lanes)),
        "ts_h": put(i32((uts >> np.uint64(32)).astype(np.uint32))),
        "ts_l": put(i32((uts & np.uint64(0xFFFFFFFF)).astype(np.uint32))),
        "ldt": put(batch.ldt.astype(np.int32, copy=False)),
        "ttl": put(batch.ttl.astype(np.int32, copy=False)),
        "flags8": put(batch.flags.astype(np.uint8, copy=False)),
        "fl": put(i32(lens64.astype(np.uint32))),
        "vr": put(i32(vrel64.astype(np.uint32))),
    }
    return DeviceRound(n, cols, np.asarray(batch.payload),
                       np.asarray(batch.off, dtype=np.int64),
                       np.asarray(batch.val_start, dtype=np.int64),
                       dict(batch.pk_map), batch.ck_fits_prefix)


def _gather_payload(cat: CellBatch, perm: np.ndarray):
    """Host-side ragged payload gather (the one part of the round that
    never went to the device) — same native path apply_permutation
    uses, without touching the fixed-width columns."""
    from ..storage.cellbatch import _native_gather
    n = len(perm)
    starts = cat.off[:-1][perm]
    lens = (cat.off[1:] - cat.off[:-1])[perm]
    new_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    total = int(new_off[-1])
    if total:
        payload = _native_gather(cat.payload, cat.off, perm, new_off)
        if payload is None:
            pos_in_cell = np.arange(total, dtype=np.int64) - \
                np.repeat(new_off[:-1], lens)
            payload = cat.payload[np.repeat(starts, lens) + pos_in_cell]
    else:
        payload = np.zeros(0, dtype=np.uint8)
    val_start = new_off[:-1] + (cat.val_start - cat.off[:-1])[perm]
    return payload, new_off, val_start


# ----------------------------------------------------------- write lane --

class DeviceWriteLane:
    """The device-resident write stage: accumulates rounds' columns in
    a device pending buffer, cuts segments on the device, serializes
    each full segment's META block with K4 and hands the writer only
    finished blocks (writer._emit_segment). The final partial segment
    assembles through the host build_meta_block on pulled column
    slices (one segment per output)."""

    def __init__(self, writer, device=None):
        from ..storage.sstable.format import SEGMENT_CELLS
        self.writer = writer
        self.device = devmod.resolve(device)
        self.seg_cells = writer.segment_cells or SEGMENT_CELLS
        self.cols: dict | None = None     # device pending columns
        self.pending = 0                  # valid cells in self.cols
        self.payloads: list = []          # (payload, off, val_start)
        self.payload_cells = 0
        self.pk_map: dict = {}

    def append(self, r: DeviceRound) -> None:
        import time as _time
        t0 = _time.perf_counter()
        w = self.writer
        if r.n and r.cols["lanes"].device != self.device:
            raise ValueError(f"round on {r.cols['lanes'].device}, lane on "
                             f"{self.device}")
        if w.K is None:
            w.K = int(r.cols["lanes"].shape[1])
        w._ck_fits = w._ck_fits and r.ck_fits_prefix
        take = {k: v[:r.n] for k, v in r.cols.items()}
        if self.cols is None or self.pending == 0:
            self.cols = take
        else:
            self.cols = {k: torch.cat([self.cols[k][:self.pending],
                                       take[k]])
                         for k in RESIDENT_COLS}
        self.pending += r.n
        self.payloads.append((r.payload, r.off, r.val_start))
        self.payload_cells += r.n
        for k, v in r.pk_map.items():
            self.pk_map[k] = v
        w._acct("serialize", _time.perf_counter() - t0)
        while self.pending >= self.seg_cells:
            self._cut(self.seg_cells)

    def flush(self) -> None:
        """Cut everything left (the final partial segment); call before
        writer.finish()/roll."""
        while self.pending >= self.seg_cells:
            self._cut(self.seg_cells)
        if self.pending:
            self._cut(self.pending)

    # ------------------------------------------------------------ internals

    def _take_payload(self, n: int):
        """Pop n cells' worth of payload frames (host side), mirroring
        SSTableWriter._take's slicing."""
        outs, got = [], 0
        while got < n:
            payload, off, val_start = self.payloads[0]
            avail = len(off) - 1
            need = n - got
            if avail <= need:
                outs.append((payload, off, val_start))
                self.payloads.pop(0)
                got += avail
            else:
                base = int(off[need])
                outs.append((payload[:base], off[:need + 1],
                             val_start[:need]))
                self.payloads[0] = (payload[base:], off[need:] - base,
                                    val_start[need:] - base)
                got = n
        self.payload_cells -= n
        if len(outs) == 1:
            payload, off, _vs = outs[0]
            return np.ascontiguousarray(payload[:int(off[-1])])
        return np.concatenate([payload[:int(off[-1])]
                               for payload, off, _vs in outs])

    def _cut(self, n: int) -> None:
        import time as _time
        w = self.writer
        t0 = _time.perf_counter()
        seg = {k: self.cols[k][:n] for k in RESIDENT_COLS}
        self.cols = {k: self.cols[k][n:] for k in RESIDENT_COLS}
        self.pending -= n
        lanes_np = np.ascontiguousarray(_u32_np(seg["lanes"]))
        dc_state = None
        dc_compress_s = 0.0
        if n == self.seg_cells:
            # full segment: K4 serializes + reduces stats on the device;
            # the host sees finished bytes
            meta_d, st = meta_block_kernel(
                seg["ts_h"], seg["ts_l"], seg["ldt"], seg["ttl"],
                seg["flags8"], seg["fl"], seg["vr"])
            t_k = _time.perf_counter()
            meta = meta_d.cpu().numpy()
            stats = meta_stats(st)
            _kprof.record_execute("write.meta_block",
                                  _time.perf_counter() - t_k)
            if w._device_compress_now():
                # K5: lane shuffle + order check + the policy match scans
                # on the card; the host keeps only the LZ4 wire emission
                # (O(sequences)) and the pwrite pump
                t_c = _time.perf_counter()
                planes_d, mbl, mbd, lbl, lbd, ok_d = \
                    device_compress.segment_scan(meta_d, seg["lanes"])
                t_e = _time.perf_counter()
                ok, planes_np, mbl, mbd, lbl, lbd = _pull(
                    [ok_d.reshape(1), planes_d, mbl, mbd, lbl, lbd])
                t_d = _time.perf_counter()
                _kprof.record_execute("write.segment_scan", t_d - t_e)
                w._acct("scan_d2h", t_d - t_e)
                if not bool(ok[0]):
                    raise ValueError("appended cells out of order")
                dc_state = (planes_np, ((mbl, mbd), (lbl, lbd)))
                dc_compress_s = t_d - t_c
        else:
            # final partial segment: host assembly through the one
            # shared META builder (byte-identical layout by definition)
            from ..storage.sstable.writer import build_meta_block
            h = _u32_np(seg["ts_h"]).astype(np.uint64)
            lo = _u32_np(seg["ts_l"]).astype(np.uint64)
            ts = ((h << np.uint64(32)) | lo) ^ np.uint64(1 << 63)
            ts = ts.astype(np.int64)
            ldt = seg["ldt"].cpu().numpy()
            ttl = seg["ttl"].cpu().numpy()
            flags = seg["flags8"].cpu().numpy()
            meta = build_meta_block(ts, ldt, ttl, flags,
                                    _u32_np(seg["fl"]).astype("<u4"),
                                    _u32_np(seg["vr"]).astype("<u4"))
            stats = (int(ts.min()), int(ts.max()),
                     int(ldt.min()), int(ldt.max()),
                     int(((flags & DEATH_FLAGS) != 0).sum()))
        payload_np = self._take_payload(n)
        w._acct("serialize", _time.perf_counter() - t0 - dc_compress_s)
        if dc_compress_s:
            w._acct("compress", dc_compress_s)
        device_pack = None
        if dc_state is not None:
            planes_np, scans = dc_state

            def device_pack(attempt, maxlen, _m=meta, _p=planes_np,
                            _s=scans, _pl=payload_np):
                # LZ4 emission of META and planes from the device scans
                # (+ the host scan of the payload block when attempted);
                # the writer's metrics count the attempted and the
                # compressed blocks of each stream
                t_p = _time.perf_counter()
                out = device_compress.pack_device_segment(
                    _m, _p, _s, _pl, attempt, maxlen,
                    acct=lambda k, dt: w._acct(f"device_pack.{k}", dt))
                w._acct("device_pack", _time.perf_counter() - t_p)
                if w._metrics is not None:
                    raws = (_m.size, _p.size, _pl.size)
                    for name, att, stored, raw in zip(
                            PACK_BLOCKS, attempt, out[1], raws):
                        if att:
                            w._metrics.incr(f"device_pack.tried.{name}")
                            if stored < raw:
                                w._metrics.incr(
                                    f"device_pack.compressed.{name}")
                return out
        w._emit_segment(n, meta, lanes_np, payload_np, self.pk_map,
                        stats, device_pack=device_pack)
