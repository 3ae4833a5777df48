"""Device-side LZ4 block compression for the compaction write path
(counterpart of cassandra_tpu/ops/device_compress.py).

The native encoder (ops/native/codec.cpp `lz4_compress`) is a fixed
POLICY: at each visited position take the longest forward run over the
DISTANCES candidate set (ties -> smallest distance), accept iff >=
MINMATCH, else advance one byte. The policy's argmax is order-free, so
the scan maps to one shifted-equality pass per candidate distance on
the card; the LZ4 wire emission (greedy parse + token stream) is
sequential but O(emitted sequences) and stays on the host, fed by the
pulled (best_len, best_d) arrays.

One kernel does the device work, K5 `segment_scan` (csrc/lzscan.cu):
for one full segment, the lane shuffle to byte planes, the
u32-lexicographic order check of the lane rows, and the policy match
scans of the META block and of the planes. Its plain PyTorch version
sits beside it (`segment_scan_plain`, on `policy_scan_plain`); the
wrapper runs it for tensors on the CPU and only then; for CUDA tensors
it launches the kernel or raises. `policy_scan_tiled_plain` mirrors
the kernel's design (word compares, tiles with carried mismatches) for
the tests and chip_smoke.py. The test entry `compress_torch`
scans one block as a segment with no lane rows.

Three implementations, one contract:
  native  lz4_compress (codec.cpp)             — host CompressorPool legs
  numpy   match_scan_np + emit_block           — reference; payload block
  torch   segment_scan (K5) + emit_block       — device META/lane blocks
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .. import device as devmod
from ..service.profiling import GLOBAL as _kprof
from . import costs, cuda_lib
from .merge import _check

MINMATCH = 4

# Must stay identical to LZ4_DIST in ops/native/codec.cpp and to
# lz_dist in csrc/lzscan.cu: all short
# lags 1..64 (columnar 25-byte META strides, shuffled lane byte-planes,
# periodic text) plus power-of-two long lags up to the format's 64KiB
# window. Ascending order is load-bearing: ties resolve to the
# SMALLEST distance.
DISTANCES = tuple(range(1, 65)) + (128, 256, 512, 1024, 2048, 4096,
                                   8192, 16384, 32768)
# csrc/lzscan.cu: bytes a tile of the scan, and the inputs' limit (a
# position's key, run * 128 + 127 - distance index, fits 32 bits)
LZ_TILE = 4096
MAX_SCAN_BYTES = 1 << 25


# ------------------------------------------------------------- scans -----

def match_scan_np(src: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reference policy match scan: for every position, the longest
    forward run over DISTANCES (ties → smallest d). Runs shorter than
    MINMATCH may appear in best_len; the parse ignores them, so the
    native encoder's 4-byte prefilter and this full scan emit the same
    sequences."""
    src = np.asarray(src, dtype=np.uint8).reshape(-1)
    n = src.size
    best_len = np.zeros(n, dtype=np.int64)
    best_d = np.zeros(n, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    for d in DISTANCES:
        if d >= n:
            break
        e = src[d:] == src[:-d]
        nxt = np.where(e, n, idx[d:])
        nxt = np.minimum.accumulate(nxt[::-1])[::-1]
        run = nxt - idx[d:]
        bl = best_len[d:]
        upd = run > bl
        bl[upd] = run[upd]
        best_d[d:][upd] = d
    return best_len, best_d


def policy_scan_plain(src: torch.Tensor):
    """Plain PyTorch K5 match scan (the JAX package's `_policy_scan`):
    per distance one shifted equality, then a reverse running minimum of
    the mismatch positions. The scan works on `torch.flip(src)`, where
    the reverse minimum is a forward `cummin`, and flips its results
    back. (best_len, best_d) as int32[n]; distances >= n are skipped, as
    there."""
    n = src.shape[0]
    dev = src.device
    r = src.flip(0)                   # r[k] = src[n - 1 - k]
    pos = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=dev)
    best_len = torch.zeros(n, dtype=torch.int32, device=dev)
    best_d = torch.zeros(n, dtype=torch.int32, device=dev)
    for d in DISTANCES:
        if d >= n:
            break
        # the mismatch position i (i < d or src[i] != src[i - d]), else n
        mis = pos.clone()
        mis[:n - d].masked_fill_(r[:n - d] == r[d:], n)
        run = torch.cummin(mis, 0).values - pos
        best_d.masked_fill_(run > best_len, d)      # strict: ties keep d
        torch.maximum(best_len, run, out=best_len)
    return best_len.flip(0), best_d.flip(0)


_ALL = 0x80808080           # 0x80 in each byte of a word


def _lowest_byte(m: torch.Tensor) -> torch.Tensor:
    """The index of the lowest byte of m (0x80 flags) that is set; 4
    when none is."""
    return torch.where(m & 0x80 != 0, 0, torch.where(
        m & 0x8000 != 0, 1, torch.where(m & 0x800000 != 0, 2,
                                        torch.where(m != 0, 3, 4))))


def policy_scan_tiled_plain(src: torch.Tensor, tile: int = LZ_TILE):
    """K5's design in plain PyTorch (csrc/lzscan.cu), for the tests and
    chip_smoke.py: per distance, each 4-byte word of src against the
    word d bytes back in one xor, whose zero bytes give the word's
    mismatch mask (0x80 a byte; forced below d and from n on); each
    tile's first mismatch, the first mismatch after each tile (the
    kernel's reverse look-back) and after each word inside its tile;
    and one key a position, run * 128 + 127 - distance index, maximised
    over the distances. Equals `policy_scan_plain`. tile: bytes, a
    multiple of 4."""
    n = src.shape[0]
    dev = src.device
    T = -(-n // tile)
    wpt = tile // 4
    # src behind 64 zero bytes (the kernel's staged bytes before a tile)
    buf = torch.zeros(64 + 4 * (T * wpt) + 4, dtype=torch.int64,
                      device=dev)
    buf[64:64 + n] = src.to(torch.int64)
    P = torch.arange(T * wpt, dtype=torch.int64, device=dev) * 4

    def word(pos):            # little-endian; below -64 only where forced
        q = (pos + 64).clamp(min=0)
        return (buf[q] | (buf[q + 1] << 8) | (buf[q + 2] << 16)
                | (buf[q + 3] << 24))

    cur = word(P)
    lim = n - P                              # bytes of the word below n
    tail = torch.where(lim >= 4, 0, torch.where(
        lim > 0, (_ALL << (8 * lim.clamp(0, 3))) & 0xFFFFFFFF, _ALL))
    key = torch.zeros(T * wpt, 4, dtype=torch.int64, device=dev)
    for dk, d in enumerate(DISTANCES):
        if d >= n:
            break
        x = cur ^ word(P - d)
        z = ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x | 0x7F7F7F7F) \
            & 0xFFFFFFFF
        below = (d - P).clamp(0, 4)
        low = torch.where(below >= 4, _ALL,
                          _ALL & ((1 << (8 * below)) - 1))
        mm = (z ^ _ALL) | low | tail
        first = torch.where(mm != 0, P + _lowest_byte(mm), n).clamp(max=n)
        # the first mismatch after each word: inside its tile, else the
        # first mismatch of a later tile
        f = first.view(T, wpt)
        suf = torch.cummin(f.flip(1), 1).values.flip(1)
        after_in = torch.cat([suf[:, 1:], suf.new_full((T, 1), n)], 1)
        tile_first = suf[:, 0]
        tsuf = torch.cummin(tile_first.flip(0), 0).values.flip(0)
        carry = torch.cat([tsuf[1:], tsuf.new_full((1,), n)])
        after = torch.minimum(after_in, carry[:, None]).reshape(-1)
        for j in range(4):
            fj = _lowest_byte(mm >> (8 * j))
            run = torch.where(fj < 4, fj, after - P - j)
            torch.maximum(key[:, j], run * 128 + (127 - dk),
                          out=key[:, j])
    key = key.reshape(-1)[:n]
    best_len = key >> 7
    dist = torch.tensor(DISTANCES, dtype=torch.int64, device=dev)
    best_d = torch.where(best_len > 0, dist[(127 - (key & 127)).clamp(
        max=len(DISTANCES) - 1)], 0)
    return best_len.to(torch.int32), best_d.to(torch.int32)


def segment_scan_plain(meta_u8: torch.Tensor, lanes_i32: torch.Tensor):
    """Plain PyTorch K5 (the JAX package's `segment_scan_kernel`): the LE
    byte planes of the lanes (u32 lanes as int32 bit patterns), the
    meta and plane scans, and the u32-lexicographic order check.
    Returns (planes, meta_best_len, meta_best_d, lane_best_len,
    lane_best_d, order_ok) with order_ok a 0-dim bool tensor."""
    n, k = lanes_i32.shape
    planes = lanes_i32.contiguous().view(torch.uint8).reshape(n, 4 * k) \
        .T.contiguous().reshape(-1)
    a = lanes_i32[:-1].to(torch.int64) & 0xFFFFFFFF
    b = lanes_i32[1:].to(torch.int64) & 0xFFFFFFFF
    neq = a != b
    firstc = neq.to(torch.uint8).argmax(dim=1, keepdim=True)
    bad = neq.any(dim=1) & (b.gather(1, firstc) < a.gather(1, firstc))[:, 0]
    order_ok = ~bad.any()
    mbl, mbd = policy_scan_plain(meta_u8)
    lbl, lbd = policy_scan_plain(planes)
    return planes, mbl, mbd, lbl, lbd, order_ok


def _segment_scan_cuda(meta_u8: torch.Tensor, lanes_i32: torch.Tensor):
    dev = meta_u8.device
    _check(meta_u8, "meta", torch.uint8, (meta_u8.shape[0],), dev)
    if lanes_i32.dim() != 2:
        raise ValueError("lanes must be (n, K)")
    rows, k = lanes_i32.shape
    _check(lanes_i32, "lanes", torch.int32, (rows, k), dev)
    n_meta, n_planes = meta_u8.shape[0], 4 * rows * k
    if max(n_meta, n_planes) >= MAX_SCAN_BYTES:
        raise ValueError(f"K5 scans inputs below {MAX_SCAN_BYTES} bytes, "
                         f"got {n_meta} and {n_planes}")
    if meta_u8.data_ptr() % 4:
        meta_u8 = meta_u8.clone()          # the kernel reads it by words
    lib = cuda_lib.lib()
    with cuda_lib.on_device(dev):
        planes = torch.empty(n_planes, dtype=torch.uint8, device=dev)
        mbl = torch.empty(n_meta, dtype=torch.int32, device=dev)
        mbd = torch.empty_like(mbl)
        lbl = torch.empty(n_planes, dtype=torch.int32, device=dev)
        lbd = torch.empty_like(lbl)
        ok = torch.empty((), dtype=torch.bool, device=dev)
        scratch = torch.empty(
            int(lib.ctpu_lzscan_scratch_bytes(n_meta, n_planes)),
            dtype=torch.uint8, device=dev)
        rc = lib.ctpu_segment_scan(
            meta_u8.data_ptr(), n_meta, lanes_i32.data_ptr(), rows, k,
            planes.data_ptr(), mbl.data_ptr(), mbd.data_ptr(),
            lbl.data_ptr(), lbd.data_ptr(), ok.data_ptr(),
            scratch.data_ptr(), cuda_lib.stream_of(meta_u8))
        cuda_lib.check(rc, "ctpu_segment_scan")
        cuda_lib.count_launch("write.segment_scan", rows)
    return planes, mbl, mbd, lbl, lbd, ok


def segment_scan(meta_u8: torch.Tensor, lanes_i32: torch.Tensor):
    """K5 for one full segment: (planes, meta_best_len, meta_best_d,
    lane_best_len, lane_best_d, order_ok). CUDA tensors launch the
    kernel; CPU tensors run `segment_scan_plain`."""
    if cuda_lib.is_cuda(meta_u8):
        return _segment_scan_cuda(meta_u8, lanes_i32)
    return segment_scan_plain(meta_u8, lanes_i32)


segment_scan = _kprof.wrap("write.segment_scan", segment_scan,
                            cost=costs.of("write.segment_scan"))


# ---------------------------------------------------------- emission -----

def emit_block(src, best_len, best_d, cap: int):
    """LZ4 block-format emission from policy match arrays. Returns the
    compressed bytes, or None when the output would overrun `cap` —
    including the native encoder's slightly conservative per-sequence
    `need` bound, replicated exactly so the compress-vs-raw decision
    lands on the same side at the boundary."""
    src = np.asarray(src, dtype=np.uint8).reshape(-1)
    n = src.size
    if n == 0:
        return b"\x00" if cap >= 1 else None
    mem = src.tobytes()
    out = bytearray()
    pos = 0
    anchor = 0
    mf = n - 12
    if mf > 0:
        bl = np.asarray(best_len, dtype=np.int64)[:mf]
        bd = np.asarray(best_d, dtype=np.int64)[:mf]
        cand = np.flatnonzero(bl >= MINMATCH)
        while True:
            j = int(np.searchsorted(cand, pos))
            if j >= cand.size:
                break
            p = int(cand[j])
            m = int(bl[p])
            # clamp to the literal tail; p < n-12 keeps m >= MINMATCH
            if m > n - 5 - p:
                m = n - 5 - p
            d = int(bd[p])
            lit = p - anchor
            ml = m - MINMATCH
            need = 1 + lit // 255 + 1 + lit + 2 + ml // 255 + 1
            if len(out) + need > cap:
                return None
            out.append(((15 if lit >= 15 else lit) << 4)
                       | (15 if ml >= 15 else ml))
            if lit >= 15:
                l = lit - 15
                while l >= 255:
                    out.append(255)
                    l -= 255
                out.append(l)
            out += mem[anchor:p]
            out.append(d & 0xFF)
            out.append(d >> 8)
            if ml >= 15:
                l = ml - 15
                while l >= 255:
                    out.append(255)
                    l -= 255
                out.append(l)
            pos = p + m
            anchor = pos
    lit = n - anchor
    need = 1 + lit // 255 + 1 + lit
    if len(out) + need > cap:
        return None
    out.append((15 if lit >= 15 else lit) << 4)
    if lit >= 15:
        l = lit - 15
        while l >= 255:
            out.append(255)
            l -= 255
        out.append(l)
    out += mem[anchor:]
    return bytes(out)


def compress_np(data, cap: int | None = None):
    """Full numpy reference: scan + emit. Equals the native
    lz4_compress byte-for-byte (tests pin this)."""
    src = np.frombuffer(bytes(data), dtype=np.uint8)
    if cap is None:
        cap = src.size + src.size // 255 + 16
    bl, bd = match_scan_np(src)
    return emit_block(src, bl, bd, cap)


def compress_torch(data, cap: int | None = None, device=None):
    """Device scan + host emit (test entry; the write path goes through
    `segment_scan` so a segment is one launch). device: default `cuda`;
    `cpu` runs the plain version."""
    src = np.frombuffer(bytes(data), dtype=np.uint8)
    if cap is None:
        cap = src.size + src.size // 255 + 16
    if src.size == 0:
        return emit_block(src, src, src, cap)
    t = torch.from_numpy(src.copy()).to(devmod.resolve(device))
    no_rows = torch.empty((0, 1), dtype=torch.int32, device=t.device)
    _planes, bl, bd, _lbl, _lbd, _ok = segment_scan(t, no_rows)
    return emit_block(src, bl.cpu().numpy(), bd.cpu().numpy(), cap)


# ------------------------------------------------------ segment pack -----

def pack_device_segment(meta, planes, scans, payload, attempt,
                        max_compressed_length: int, acct=None):
    """segment_pack's compress-or-raw placement, replicated from device
    scan results: returns (total, sizes, crcs, parts) where parts are
    the stored bytes of the (META, lanes, payload) blocks in order.
    `planes` is the lane block already shuffled to byte planes (its
    stored form); `scans` carries the device (best_len, best_d) pairs
    for META and planes, and the payload block — host memory — scans
    through the numpy reference on demand. The compress-vs-raw rule is
    segment_pack's verbatim: compressed iff the emission fits
    cap = min(srcLen, max_compressed_length) AND is shorter than both
    bounds. acct(phase, seconds), when given, is billed the host scans
    of the payload block ("payload_scan") and the LZ4 emission of every
    attempted block ("emit") apart."""
    import time
    maxlen = int(max_compressed_length)
    blocks = ((meta, scans[0]), (planes, scans[1]), (payload, None))
    parts, sizes, crcs = [], [], []
    for (blk, scan), att in zip(blocks, attempt):
        raw = np.asarray(blk, dtype=np.uint8).reshape(-1)
        stored = None
        if att:
            cap = min(raw.size, maxlen)
            t0 = time.perf_counter()
            if scan is None:
                scan = match_scan_np(raw)
                if acct is not None:
                    acct("payload_scan", time.perf_counter() - t0)
                    t0 = time.perf_counter()
            c = emit_block(raw, scan[0], scan[1], cap)
            if acct is not None:
                acct("emit", time.perf_counter() - t0)
            if c is not None and len(c) < raw.size and len(c) < maxlen:
                stored = c
        if stored is None:
            stored = raw.tobytes()
        parts.append(stored)
        sizes.append(len(stored))
        crcs.append(zlib.crc32(stored))
    return sum(sizes), sizes, crcs, parts
