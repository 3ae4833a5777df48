"""A reader of the program's on-disk sstable format ("ce" version),
written from its description and not from the program's reader: plain
Python and NumPy, with its own LZ4 block decoder.

Components of one sstable `<version>-<generation>-<name>`:

  Statistics.db  JSON: n_lanes, n_cells, n_partitions, min_ts, max_ts, ...
  Index.db       <III n_segments, K, segment_cells; per segment <QI data
                 offset and cells, three <QQI (stored length, raw length,
                 CRC32 of the stored bytes) for META, LANES and PAYLOAD,
                 then the first and last lane rows (K <u4 each)
  Data.db        per segment its three blocks back to back, each LZ4
                 block format, or raw where the stored length equals the
                 raw length
  Partitions.db  <I count; count x 4 big-endian u32 lanes; count <i8 first
                 cell; count + 1 <i8 key offsets; the key bytes
  Filter.db      <QII bits, k, 0; bits / 64 <u8 words. Key i sets bits
                 (h1 + j * h2) mod bits, j < k, of its murmur3 (h1, h2)
  Digest.crc32   decimal CRC32 chained over the blocks' CRC words (<I)

LANES holds the segment's [n, K] u32 rows as 4K byte planes (byte b of
every row's little-endian row bytes, then byte b + 1). META holds, per
cell, the timestamp as a wrapping delta from the previous cell's (the
first absolute) <i8, then ldt <i4, ttl <i4, flags u1, frame length <u4,
value offset within the frame <u4, each as a column. PAYLOAD is the
cells' frames: vint clustering length, clustering, vint path length,
path, value.
"""
from __future__ import annotations

import json
import os
import re
import struct
import zlib

import numpy as np

_TOC = re.compile(r"^(?P<ver>[a-z]{2})-(?P<gen>\d+)-TOC\.txt$")


class BadBlock(Exception):
    pass


def lz4_block_decode(src: bytes, raw_len: int) -> bytes:
    """One LZ4 block (no frame) to exactly raw_len bytes; raises BadBlock
    on anything the format does not allow."""
    dst = bytearray(raw_len)
    ip, op, end = 0, 0, len(src)
    try:
        while True:
            token = src[ip]
            ip += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = src[ip]
                    ip += 1
                    lit += b
                    if b != 255:
                        break
            if lit:
                if ip + lit > end or op + lit > raw_len:
                    raise BadBlock("literals run past the block")
                dst[op:op + lit] = src[ip:ip + lit]
                ip += lit
                op += lit
            if ip == end:
                break
            dist = src[ip] | (src[ip + 1] << 8)
            ip += 2
            mlen = token & 15
            if mlen == 15:
                while True:
                    b = src[ip]
                    ip += 1
                    mlen += b
                    if b != 255:
                        break
            mlen += 4
            if dist == 0 or dist > op or op + mlen > raw_len:
                raise BadBlock("match out of range")
            start = op - dist
            if dist >= mlen:
                dst[op:op + mlen] = dst[start:start + mlen]
            else:
                period = bytes(dst[start:op])
                dst[op:op + mlen] = (period * (mlen // dist + 1))[:mlen]
            op += mlen
    except IndexError:
        raise BadBlock("block ends inside a sequence") from None
    if op != raw_len:
        raise BadBlock(f"decoded {op} bytes, index says {raw_len}")
    return bytes(dst)


def sstables_in(directory: str) -> list[str]:
    """Path prefixes `<dir>/<version>-<generation>-` of the complete
    sstables in a directory, by generation."""
    found = []
    for fn in os.listdir(directory):
        m = _TOC.match(fn)
        if m:
            found.append((int(m.group("gen")), os.path.join(
                directory, f"{m.group('ver')}-{m.group('gen')}-")))
    return [p for _g, p in sorted(found)]


def _read(prefix: str, comp: str) -> bytes:
    with open(prefix + comp, "rb") as f:
        return f.read()


def decode_block(job: tuple[bytes, int]) -> bytes | None:
    """One LZ4 block (its bytes, its raw length) to its raw bytes, or
    None where it does not decode."""
    try:
        return lz4_block_decode(*job)
    except BadBlock:
        return None


def read_sstable(prefix: str, decode=map) -> dict:
    """Every cell and the read-back metadata of one sstable. `bad` counts
    the faults found on the way: blocks whose CRC, decode or length is
    wrong, and index entries that contradict the data. `decode` maps
    decode_block over the blocks (a process pool's map decodes them side
    by side)."""
    bad = 0
    stats = json.loads(_read(prefix, "Statistics.db"))
    idx = _read(prefix, "Index.db")
    n_seg, K, _seg_cells = struct.unpack_from("<III", idx, 0)
    entry = 12 + 60 + 8 * K
    data = _read(prefix, "Data.db")
    jobs, segs = [], []
    digest = 0
    expect_off = 0
    for s in range(n_seg):
        pos = 12 + s * entry
        off, n = struct.unpack_from("<QI", idx, pos)
        blocks = [struct.unpack_from("<QQI", idx, pos + 12 + 20 * b)
                  for b in range(3)]
        if off != expect_off:
            bad += 1
        p = off
        for stored, raw_len, crc in blocks:
            chunk = data[p:p + stored]
            p += stored
            digest = zlib.crc32(struct.pack("<I", crc), digest)
            if len(chunk) != stored or zlib.crc32(chunk) != crc:
                bad += 1
                chunk = b""
            jobs.append((chunk, raw_len))
        expect_off = p
        segs.append((n, np.frombuffer(idx, "<u4", K, pos + 72),
                     np.frombuffer(idx, "<u4", K, pos + 72 + 4 * K)))
    # raw blocks as they are, the LZ4 blocks through `decode`
    packed = [i for i, (chunk, raw_len) in enumerate(jobs)
              if len(chunk) != raw_len]
    raws = [chunk for chunk, _raw_len in jobs]
    for i, got in zip(packed, decode(decode_block,
                                     [jobs[i] for i in packed])):
        raws[i] = got
    lanes, meta_cols, frames, frame_off = [], [], [], [0]
    for s, (n, first, last) in enumerate(segs):
        raw = []
        for b in range(3):
            got = raws[3 * s + b]
            if got is None:
                bad += 1
                got = bytes(jobs[3 * s + b][1])
            raw.append(got)
        meta, planes, payload = raw
        if len(meta) != 25 * n or len(planes) != 4 * K * n:
            bad += 1
            continue
        rows = np.frombuffer(planes, np.uint8).reshape(4 * K, n).T
        seg_lanes = np.ascontiguousarray(rows).view("<u4").reshape(n, K)
        if n and (not np.array_equal(seg_lanes[0], first)
                  or not np.array_equal(seg_lanes[-1], last)):
            bad += 1
        m = np.frombuffer(meta, np.uint8)
        ts = np.cumsum(m[:8 * n].view("<i8"), dtype=np.int64)
        ldt = m[8 * n:12 * n].view("<i4")
        ttl = m[12 * n:16 * n].view("<i4")
        flags = m[16 * n:17 * n]
        flen = m[17 * n:21 * n].view("<u4").astype(np.int64)
        vrel = m[21 * n:25 * n].view("<u4")
        if int(flen.sum()) != len(payload):
            bad += 1
        lanes.append(seg_lanes)
        meta_cols.append((ts, ldt, ttl, flags, vrel))
        frames.append(np.frombuffer(payload, np.uint8))
        frame_off.append(flen)
    if len(data) != expect_off:
        bad += 1
    with open(prefix + "Digest.crc32") as f:
        if int(f.read().strip() or -1) != digest:
            bad += 1
    cat = (lambda i, dt: np.concatenate([c[i] for c in meta_cols])
           if meta_cols else np.zeros(0, dt))
    offs = np.cumsum(np.concatenate(
        [np.zeros(1, np.int64)] + frame_off[1:]))
    part = _read(prefix, "Partitions.db")
    (n_part,) = struct.unpack_from("<I", part, 0)
    o = 4
    lane4 = np.frombuffer(part, ">u4", 4 * n_part, o).reshape(n_part, 4)
    o += 16 * n_part
    cell0 = np.frombuffer(part, "<i8", n_part, o)
    o += 8 * n_part
    pk_off = np.frombuffer(part, "<i8", n_part + 1, o)
    o += 8 * (n_part + 1)
    bloom = _read(prefix, "Filter.db")
    bits, k, _ = struct.unpack_from("<QII", bloom, 0)
    return {
        "stats": stats, "bad": bad,
        "lanes": np.concatenate(lanes) if lanes else np.zeros((0, K),
                                                              np.uint32),
        "ts": cat(0, np.int64), "ldt": cat(1, np.int32),
        "ttl": cat(2, np.int32), "flags": cat(3, np.uint8),
        "val_rel": cat(4, np.uint32),
        "payload": np.concatenate(frames) if frames else np.zeros(
            0, np.uint8),
        "frame_off": offs,
        "part_lane4": lane4.astype(np.uint32), "part_cell0": cell0,
        "pk_off": pk_off, "pk_blob": part[o:],
        "bloom_bits": bits, "bloom_k": k,
        "bloom_words": np.frombuffer(bloom, "<u8", offset=16),
    }
