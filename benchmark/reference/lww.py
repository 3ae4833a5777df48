"""The plain reference of the stress-stcs configurations: what a major
compaction of cassandra-stress `standard1` writes must hold, and the
comparison of an output on disk with it (plain NumPy; imports nothing
of the program).

Semantics (Cassandra's): an INSERT writes the row's primary-key liveness
and each column at the write's timestamp; a major compaction keeps, of
every cell, the version with the highest timestamp (last write wins),
and nothing expires or is deleted in these mixes. Output order is the
program's identity-lane order: partitions by (token + 2^63, murmur3 h2),
in a partition the liveness cell (column 2) and then the regular columns
by id, which the program hands out from 8 in the order of the columns'
names.
"""
from __future__ import annotations

import numpy as np

from . import ctpu_format, murmur3

K = 13                      # 4 partition + 4 clustering prefix + 2 ck
#                             hash + column + 2 path lanes
COL_LIVENESS = 2
COL_FIRST = 8
FLAG_ROW_LIVENESS = 16
NO_DELETION_TIME = 0x7FFFFFFF

# every number compared, each with its limit: an exact comparison, so 0
LIMITS = {"cells_wrong": 0, "blocks_bad": 0, "index_wrong": 0,
          "outputs_unlike": 0}


def expected(mix) -> dict:
    """The cells a major compaction of `mix`'s sstables must write, in
    output order, and its partition directory."""
    keys = mix.keys()
    h1, h2 = murmur3.hash128(keys)
    tok = murmur3.biased_tokens(h1)
    order = np.lexsort((h2, tok))
    # the newest write of each key: every pass writes every key, and a
    # later write carries a higher timestamp
    newest_ts = np.full(mix.n, np.iinfo(np.int64).min, dtype=np.int64)
    newest_pass = np.zeros(mix.n, dtype=np.int64)
    for p in range(mix.passes):
        ts = mix.timestamps(p, 0, mix.n)
        newer = ts > newest_ts
        newest_ts[newer] = ts[newer]
        newest_pass[newer] = p
    values = np.empty((mix.n, mix.columns, mix.column_size), np.uint8)
    for p in range(mix.passes):
        rows = np.flatnonzero(newest_pass == p)
        if len(rows):
            values[rows] = mix.values(p, 0, mix.n)[rows]

    per = 1 + mix.columns
    n_part = mix.n
    lanes = np.zeros((n_part, per, K), dtype=np.uint32)
    t, h = tok[order], h2[order]
    lanes[:, :, 0] = (t >> np.uint64(32))[:, None]
    lanes[:, :, 1] = (t & np.uint64(0xFFFFFFFF))[:, None]
    lanes[:, :, 2] = (h >> np.uint64(32))[:, None]
    lanes[:, :, 3] = (h & np.uint64(0xFFFFFFFF))[:, None]
    lanes[:, 0, 10] = COL_LIVENESS
    lanes[:, 1:, 10] = COL_FIRST + np.arange(mix.columns)[None, :]
    flags = np.zeros((n_part, per), np.uint8)
    flags[:, 0] = FLAG_ROW_LIVENESS
    flen = np.full((n_part, per), 2 + mix.column_size, np.int64)
    flen[:, 0] = 2
    frames = np.zeros((n_part, per, 2 + mix.column_size), np.uint8)
    cols = values[order][:, np.argsort(mix.column_names())]
    frames[:, 1:, 2:] = cols
    n = n_part * per
    payload = frames.reshape(n, -1)[
        np.arange(2 + mix.column_size)[None, :]
        < flen.reshape(n, 1)]
    return {
        "lanes": lanes.reshape(n, K),
        "ts": np.repeat(newest_ts[order], per),
        "ldt": np.full(n, NO_DELETION_TIME, np.int32),
        "ttl": np.zeros(n, np.int32),
        "flags": flags.reshape(n),
        "val_rel": np.full(n, 2, np.uint32),
        "frame_off": np.concatenate([[0], np.cumsum(flen.reshape(n))]),
        "payload": payload,
        "part_lane4": lanes[:, 0, :4].copy(),
        "part_cell0": np.arange(n_part, dtype=np.int64) * per,
        "keys": keys[order],
        "h1": h1[order], "h2": h2[order],
    }


def _frames(payload: np.ndarray, off: np.ndarray, width: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """Each frame padded to `width` bytes, and the frames' lengths."""
    lens = np.diff(off)
    idx = off[:-1, None] + np.arange(width)[None, :]
    inside = np.arange(width)[None, :] < lens[:, None]
    out = np.zeros((len(lens), width), np.uint8)
    if len(payload):
        out[inside] = payload[np.minimum(idx, len(payload) - 1)][inside]
    return out, lens


def cells_wrong(got: dict, exp: dict) -> int:
    """Cells missing, extra, or differing in any lane, the timestamp,
    ldt, ttl, flags or frame (clustering, path and value bytes)."""
    n, m = len(exp["ts"]), len(got["ts"])
    k = min(n, m)
    bad = np.zeros(k, dtype=bool)
    if got["lanes"].shape[1] != exp["lanes"].shape[1]:
        return max(n, m)
    bad |= (got["lanes"][:k] != exp["lanes"][:k]).any(axis=1)
    for col in ("ts", "ldt", "ttl", "flags", "val_rel"):
        bad |= got[col][:k] != exp[col][:k]
    go, eo = got["frame_off"][:k + 1], exp["frame_off"][:k + 1]
    end = int(eo[-1])
    if np.array_equal(go, eo) and len(got["payload"]) >= end:
        # the frames lie alike: the cells holding a differing byte
        at = np.flatnonzero(got["payload"][:end] != exp["payload"][:end])
        bad[np.searchsorted(eo, at, side="right") - 1] = True
    else:
        width = int(max(np.diff(exp["frame_off"]).max(initial=0),
                        np.diff(got["frame_off"]).max(initial=0)))
        gf, gl = _frames(got["payload"], go, width)
        ef, el = _frames(exp["payload"], eo, width)
        bad |= (gl != el) | (gf != ef).any(axis=1)
    return int(bad.sum()) + abs(n - m)


def index_wrong(got: dict, exp: dict, stats: dict) -> int:
    """Faults in what reads the cells back: partition directory entries
    (lanes, first cell, key bytes) missing or wrong, keys the bloom
    filter would turn away, and statistics that disagree."""
    n, m = len(exp["part_cell0"]), len(got["part_cell0"])
    k = min(n, m)
    bad = (got["part_lane4"][:k] != exp["part_lane4"][:k]).any(axis=1)
    bad |= got["part_cell0"][:k] != exp["part_cell0"][:k]
    pk_len = np.diff(got["pk_off"])[:k]
    key_size = exp["keys"].shape[1]
    bad |= pk_len != key_size
    blob = np.frombuffer(got["pk_blob"], np.uint8)
    if len(blob) >= key_size * k and not bad.all():
        at = got["pk_off"][:k, None] + np.arange(key_size)[None, :]
        bad |= (blob[np.minimum(at, len(blob) - 1)]
                != exp["keys"][:k]).any(axis=1)
    wrong = int(bad.sum()) + abs(n - m)
    bits, words = got["bloom_bits"], got["bloom_words"]
    if bits == 0 or len(words) * 64 != bits:
        wrong += n
    else:
        with np.errstate(over="ignore"):
            j = np.arange(got["bloom_k"], dtype=np.uint64)
            at = (exp["h1"][:, None] + j[None, :] * exp["h2"][:, None]) \
                % np.uint64(bits)
        hit = (words[(at >> np.uint64(6)).astype(np.int64)]
               >> (at & np.uint64(63))) & np.uint64(1)
        wrong += int((hit == 0).any(axis=1).sum())
    want = {"n_cells": len(exp["ts"]), "n_partitions": n,
            "n_lanes": K, "min_ts": int(exp["ts"].min()),
            "max_ts": int(exp["ts"].max()), "tombstones": 0}
    wrong += sum(1 for key, v in want.items() if stats.get(key) != v)
    return wrong


def compare(directory: str, exp: dict, decode=map) -> dict:
    """The numbers compared for one compaction's output directory. A
    major compaction without a size limit writes one sstable; any other
    count is a fault and fails every number. `decode`: as
    ctpu_format.read_sstable's."""
    outputs = ctpu_format.sstables_in(directory)
    if len(outputs) != 1:
        return {"cells_wrong": len(exp["ts"]), "blocks_bad": 1,
                "index_wrong": len(exp["part_cell0"])}
    got = ctpu_format.read_sstable(outputs[0], decode)
    return {"cells_wrong": cells_wrong(got, exp), "blocks_bad": got["bad"],
            "index_wrong": index_wrong(got, exp, got["stats"])}


def control(mix) -> dict:
    """The control: this reference put in the program's place with one
    guarantee broken, the microsecond precision of client timestamps.
    It reconciles and stores each write's timestamp in milliseconds (the
    unit of CQL's toTimestamp() and of clients that stamp in ms), as a
    compaction that narrowed its timestamp lanes would."""
    out = dict(expected(mix))
    out["ts"] = out["ts"] // 1000 * 1000
    return out
