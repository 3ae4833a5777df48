"""Per-sstable attached index components — the SAI storage model.

Reference counterpart: index/sai/ (StorageAttachedIndex: every sstable
carries its own index component, built at flush/compaction time or on
first use, dropped with the sstable). No global rebuild ever happens: a
restart reopens components from disk, and an sstable that appears through
any path (flush, compaction, anticompaction, streaming, bulk load) gets
its component built once from that sstable alone.

Formats (little-endian, CRC-trailed, 4-byte magic = format version; a
component with an older/unknown magic or any parse error loads as None
and is simply rebuilt from its sstable — the worst case of format
evolution is one re-scan):
  equality  "EQI1" [u32 n][records: vint vlen, v, vint pklen, pk,
            vint cklen, ck]
  vector    "VEC2" [u32 n][u32 dim][f32 matrix n*dim][i64 ts]*n
            [locators: vint pklen, pk, vint cklen, ck]*n
  zonemap   "ZMP1" [u32 n_segments][u32 n_columns]
            [u32 col_id, u8 kind]*n_columns, then per column
            [u64 kmin]*nseg [u64 kmax]*nseg [u32 live]*nseg
            [u32 dead]*nseg — keys are the monotone u64 scan keys of
            ops/device_scan.py; an empty segment is (U64_MAX, 0)
All end with [u32 crc32(body)].
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..schema import TableMetadata
from ..utils import varint as vi


def component_path(desc, column_id: int) -> str:
    return os.path.join(desc.directory,
                        f"{desc.version}-{desc.generation}"
                        f"-Index_{column_id}.db")


def iter_column_cells(batch, column_id: int):
    """(value, pk, ck) for every LIVE cell of the column in a CellBatch
    (dead cells carry no value worth indexing; stale entries are filtered
    at read time by re-checking the base row). Shared by the sstable
    component builders and the memtable query path."""
    from ..storage.cellbatch import DEATH_FLAGS
    C = batch.n_lanes - 9
    cols = batch.lanes[:, 6 + C]
    hits = np.flatnonzero((cols == column_id)
                          & ((batch.flags & DEATH_FLAGS) == 0))
    for i in hits:
        ck, _path, value = batch.cell_payload(int(i))
        if value:
            yield value, batch.partition_key(int(i)), ck, \
                int(batch.ts[int(i)])


def _scan_column(reader, table: TableMetadata, column_id: int):
    for seg in reader.scanner():
        yield from iter_column_cells(seg, column_id)


def _write(path: str, body: bytes) -> None:
    import threading
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(body)
        f.write(struct.pack("<I", zlib.crc32(body)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return None
    if len(data) < 4:
        return None
    body, crc = data[:-4], struct.unpack("<I", data[-4:])[0]
    if zlib.crc32(body) != crc:
        return None   # torn write: caller rebuilds
    return body


# ---------------------------------------------------------------- equality --

def build_equality(reader, table: TableMetadata, column_id: int) -> str:
    path = component_path(reader.desc, column_id)
    out = bytearray()
    n = 0
    recs = bytearray()
    for value, pk, ck, _ts in _scan_column(reader, table, column_id):
        vi.write_unsigned_vint(len(value), recs)
        recs += value
        vi.write_unsigned_vint(len(pk), recs)
        recs += pk
        vi.write_unsigned_vint(len(ck), recs)
        recs += ck
        n += 1
    out += b"EQI1"
    out += struct.pack("<I", n)
    out += recs
    _write(path, bytes(out))
    return path


def load_equality(path: str) -> dict[bytes, list] | None:
    body = _read(path)
    if body is None or body[:4] != b"EQI1":
        return None
    try:
        return _parse_equality(body)
    except (ValueError, IndexError, struct.error):
        return None   # malformed: rebuild


def _parse_equality(body: bytes) -> dict[bytes, list]:
    (n,) = struct.unpack_from("<I", body, 4)
    pos = 8
    out: dict[bytes, list] = {}
    for _ in range(n):
        ln, pos = vi.read_unsigned_vint(body, pos)
        v = bytes(body[pos:pos + ln])
        pos += ln
        ln, pos = vi.read_unsigned_vint(body, pos)
        pk = bytes(body[pos:pos + ln])
        pos += ln
        ln, pos = vi.read_unsigned_vint(body, pos)
        ck = bytes(body[pos:pos + ln])
        pos += ln
        out.setdefault(v, []).append((pk, ck))
    return out


# ------------------------------------------------------------------ vector --

def build_vector(reader, table: TableMetadata, column_id: int,
                 dim: int) -> str:
    path = component_path(reader.desc, column_id)
    rows = []
    tss = []
    locs = bytearray()
    for value, pk, ck, ts in _scan_column(reader, table, column_id):
        rows.append(np.frombuffer(value, dtype=">f4").astype(np.float32))
        tss.append(ts)
        vi.write_unsigned_vint(len(pk), locs)
        locs += pk
        vi.write_unsigned_vint(len(ck), locs)
        locs += ck
    mat = np.stack(rows) if rows else np.zeros((0, dim), np.float32)
    out = bytearray()
    out += b"VEC2"
    out += struct.pack("<II", len(rows), dim)
    out += mat.astype("<f4").tobytes()
    out += np.asarray(tss, dtype="<i8").tobytes()
    out += locs
    _write(path, bytes(out))
    return path


def load_vector(path: str):
    """(matrix float32 [n, dim], ts int64 [n], [(pk, ck)] locators)."""
    body = _read(path)
    if body is None or body[:4] != b"VEC2":
        return None
    try:
        return _parse_vector(body)
    except (ValueError, IndexError, struct.error):
        return None   # malformed: rebuild


def _parse_vector(body: bytes):
    n, dim = struct.unpack_from("<II", body, 4)
    pos = 12
    mat = np.frombuffer(body, dtype="<f4", count=n * dim,
                        offset=pos).reshape(n, dim).astype(np.float32)
    pos += 4 * n * dim
    tss = np.frombuffer(body, dtype="<i8", count=n, offset=pos).copy()
    pos += 8 * n
    keys = []
    for _ in range(n):
        ln, pos = vi.read_unsigned_vint(body, pos)
        pk = bytes(body[pos:pos + ln])
        pos += ln
        ln, pos = vi.read_unsigned_vint(body, pos)
        ck = bytes(body[pos:pos + ln])
        pos += ln
        keys.append((pk, ck))
    return mat, tss, keys


# -------------------------------------------------------------------- text --
# SASI role (index/sasi): analyzed text terms -> locators, one CRC-trailed
# component per sstable like the equality/vector components. The analyzer
# is the SASI StandardAnalyzer subset: lowercase, split on
# non-alphanumeric runs. PREFIX mode indexes the whole lowercased value
# instead (SASI's non-tokenizing analyzer) for LIKE 'abc%'.

_TOKEN_RE = None


def analyze(value: bytes, mode: str) -> set[bytes]:
    global _TOKEN_RE
    if _TOKEN_RE is None:
        import re
        _TOKEN_RE = re.compile(r"[0-9a-z]+")
    text = value.decode("utf-8", "ignore").lower()
    if mode == "PREFIX":
        return {text.encode()} if text else set()
    return {t.encode() for t in _TOKEN_RE.findall(text)}


def text_component_path(desc, column_id: int) -> str:
    return os.path.join(desc.directory,
                        f"{desc.version}-{desc.generation}"
                        f"-Text_{column_id}.db")


def build_text(reader, table: TableMetadata, column_id: int,
               mode: str) -> str:
    path = text_component_path(reader.desc, column_id)
    recs = bytearray()
    n = 0
    for value, pk, ck, _ts in _scan_column(reader, table, column_id):
        for term in analyze(value, mode):
            vi.write_unsigned_vint(len(term), recs)
            recs += term
            vi.write_unsigned_vint(len(pk), recs)
            recs += pk
            vi.write_unsigned_vint(len(ck), recs)
            recs += ck
            n += 1
    out = bytearray()
    out += b"TXI1"
    out += struct.pack("<I", n)
    out += recs
    _write(path, bytes(out))
    return path


def load_text(path: str) -> dict[bytes, list] | None:
    body = _read(path)
    if body is None or body[:4] != b"TXI1":
        return None
    try:
        return _parse_equality(body)   # identical record layout
    except (ValueError, IndexError, struct.error):
        return None


# ---------------------------------------------------------------- zone map --
# One component per sstable bounding every segment's live cells per
# supported column in the u64 scan-key space (ops/device_scan.py), so
# analytical scans prune segments — or the whole sstable — without
# decoding them. Built in the writer tail at flush/compaction; the EQI1
# rebuild contract applies (parse error / stale segment count -> rebuilt
# from the sstable once). Encrypted sstables never get one: plaintext
# min/max keys would leak TDE-protected values.

_KIND_CODES = {"i64": 0, "f64": 1, "bool": 2, "prefix": 3}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}


def zonemap_path(desc) -> str:
    return os.path.join(desc.directory,
                        f"{desc.version}-{desc.generation}-ZoneMap.db")


class ZoneMap:
    """Per-segment (min key, max key, live, dead) bounds per column."""

    __slots__ = ("n_segments", "cols")

    def __init__(self, n_segments: int, cols: dict):
        self.n_segments = n_segments
        #: col_id -> (kind, kmin u64[nseg], kmax u64[nseg],
        #:            live u32[nseg], dead u32[nseg])
        self.cols = cols

    @staticmethod
    def from_entries(zone_cols, per_segment) -> "ZoneMap":
        """zone_cols: [(col_id, kind, width)]; per_segment: one
        [(kmin, kmax, live, dead)] row per segment, zone_cols order."""
        n_seg = len(per_segment)
        cols = {}
        for j, (cid, kind, _w) in enumerate(zone_cols):
            cols[cid] = (
                kind,
                np.array([per_segment[s][j][0] for s in range(n_seg)],
                         dtype=np.uint64),
                np.array([per_segment[s][j][1] for s in range(n_seg)],
                         dtype=np.uint64),
                np.array([per_segment[s][j][2] for s in range(n_seg)],
                         dtype=np.uint32),
                np.array([per_segment[s][j][3] for s in range(n_seg)],
                         dtype=np.uint32),
            )
        return ZoneMap(n_seg, cols)

    def keep_mask(self, pred) -> np.ndarray:
        """bool[n_segments]: segments that may match pred and must be
        decoded. A column the map does not cover (or whose stored kind
        no longer matches the schema) keeps everything."""
        ent = self.cols.get(pred.col_id)
        if ent is None or ent[0] != pred.kind:
            return np.ones(self.n_segments, dtype=bool)
        from ..ops import device_scan as ds
        return ds.prune_keep_mask(ent[1], ent[2], ent[3], pred)


def write_zonemap(path: str, zone_cols, per_segment) -> str:
    n_seg = len(per_segment)
    out = bytearray()
    out += b"ZMP1"
    out += struct.pack("<II", n_seg, len(zone_cols))
    for cid, kind, _w in zone_cols:
        out += struct.pack("<IB", cid, _KIND_CODES[kind])
    zm = ZoneMap.from_entries(zone_cols, per_segment)
    for cid, _kind, _w in zone_cols:
        _k, kmin, kmax, live, dead = zm.cols[cid]
        out += kmin.astype("<u8").tobytes()
        out += kmax.astype("<u8").tobytes()
        out += live.astype("<u4").tobytes()
        out += dead.astype("<u4").tobytes()
    _write(path, bytes(out))
    return path


def load_zonemap(path: str,
                 expected_segments: int | None = None) -> ZoneMap | None:
    body = _read(path)
    if body is None or body[:4] != b"ZMP1":
        return None
    try:
        n_seg, n_cols = struct.unpack_from("<II", body, 4)
        if expected_segments is not None and n_seg != expected_segments:
            return None   # stale (format evolution / partial copy): rebuild
        pos = 12
        hdr = []
        for _ in range(n_cols):
            cid, code = struct.unpack_from("<IB", body, pos)
            pos += 5
            hdr.append((cid, _KIND_NAMES[code]))
        cols = {}
        for cid, kind in hdr:
            kmin = np.frombuffer(body, "<u8", n_seg, pos).astype(np.uint64)
            pos += 8 * n_seg
            kmax = np.frombuffer(body, "<u8", n_seg, pos).astype(np.uint64)
            pos += 8 * n_seg
            live = np.frombuffer(body, "<u4", n_seg, pos).astype(np.uint32)
            pos += 4 * n_seg
            dead = np.frombuffer(body, "<u4", n_seg, pos).astype(np.uint32)
            pos += 4 * n_seg
            cols[cid] = (kind, kmin, kmax, live, dead)
        return ZoneMap(n_seg, cols)
    except (ValueError, KeyError, IndexError, struct.error):
        return None   # malformed: rebuild


def build_zonemap(reader, table: TableMetadata, write: bool = True) -> ZoneMap:
    """Rebuild a sstable's zone map from its decoded segments (the slow
    path a missing/torn/stale component falls back to — one re-scan,
    like the EQI1 contract)."""
    from ..ops import device_scan as ds
    zone_cols = ds.zonemap_columns(table)
    per_seg = []
    for s in range(reader.n_segments):
        b = reader._read_segment(s)
        C = b.n_lanes - 9
        per_seg.append(ds.segment_zone_entries(
            zone_cols, b.lanes[:, 6 + C], b.flags,
            np.asarray(b.val_start), np.asarray(b.off[1:]),
            np.asarray(b.payload)))
    zm = ZoneMap.from_entries(zone_cols, per_seg)
    if write and not reader.released:
        try:
            write_zonemap(zonemap_path(reader.desc), zone_cols, per_seg)
        except OSError:
            pass   # read-only media: serve the in-memory map
    return zm


def zonemap_for(reader, table: TableMetadata) -> ZoneMap | None:
    """The reader's zone map, cached on the reader: disk component if
    fresh, else rebuilt once (counted). None for encrypted sstables."""
    if getattr(reader, "_enc", None) is not None:
        return None
    cached = getattr(reader, "_zonemap_cache", None)
    if cached is not None:
        return cached or None          # False = negative cache
    zm = load_zonemap(zonemap_path(reader.desc), reader.n_segments)
    if zm is None:
        from ..service.metrics import GLOBAL as _M
        _M.incr("scan.zonemap_rebuilds")
        try:
            zm = build_zonemap(reader, table)
        except Exception:
            zm = None   # corrupt sstable surfaces through the scan itself
    reader._zonemap_cache = zm if zm is not None else False
    return zm
