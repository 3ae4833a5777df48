"""harry — seeded operation-stream fuzzer with a model checker.

Reference counterpart: test/harry (deterministic data generator +
QuiescentChecker: ops are generated reproducibly from a seed, applied to
the system under test AND to a pure model; reads are verified against
the model's computed expectation —
test/harry/main/org/apache/cassandra/harry/model/QuiescentChecker.java).

The model implements the full deletion algebra the storage engine must
honor: newest-timestamp-wins cells with the CASSANDRA-14592
equal-timestamp ranking (expiring-or-tombstone beats live, PURE
tombstone beats expiring, larger localDeletionTime, larger value
bytes), TTL expiry against a virtual clock (`advance` ops move it, so
expiry is deterministic and replayable from the seed), expiration-
overflow capping (db/ExpirationDateOverflowHandling.java), row liveness
(INSERT creates a row; UPDATE alone leaves it dependent on live cells),
static rows, multicell collections with complex deletions
(db/rows/ComplexColumnData), column/row/partition tombstones,
clustering range tombstones, and flush/compaction as visibility no-ops.
Any mismatch reports the seed + op index that reproduce it.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..utils.timeutil import NO_DELETION_TIME, expiration_time

# ---------------------------------------------------------------- ops --


@dataclass
class Op:
    index: int
    kind: str
    pk: int
    ck: int | None = None
    cols: dict | None = None       # col -> value for writes
    ts: int = 0
    ttl: int = 0                   # 0 = no TTL
    lo: int | None = None          # range delete bounds [lo, hi)
    hi: int | None = None
    col: str | None = None         # single-column delete
    key: str | None = None         # map element key
    val: int | None = None         # map element value
    items: dict | None = None      # map literal for overwrite/append
    seconds: int = 0               # virtual-clock advance
    cond: tuple | None = None      # LWT: (col, expected_value)

    def _using(self) -> str:
        u = f"USING TIMESTAMP {self.ts}"
        if self.ttl:
            u += f" AND TTL {self.ttl}"
        return u

    def cql(self, table: str) -> str | None:
        """The CQL statement for this op (None for flush/compact/advance)."""
        k = self.kind
        if k == "insert":
            v, w = self.cols["v"], self.cols["w"]
            return (f"INSERT INTO {table} (k, c, v, w) VALUES "
                    f"({self.pk}, {self.ck}, '{v}', {w}) {self._using()}")
        if k == "update":
            sets = ", ".join(
                f"{c} = " + (f"'{x}'" if c == "v" else str(x))
                for c, x in self.cols.items())
            return (f"UPDATE {table} {self._using()} "
                    f"SET {sets} WHERE k = {self.pk} AND c = {self.ck}")
        if k == "del_row":
            return (f"DELETE FROM {table} USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        if k == "del_col":
            return (f"DELETE {self.col} FROM {table} "
                    f"USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        if k == "del_part":
            return (f"DELETE FROM {table} USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk}")
        if k == "del_range":
            return (f"DELETE FROM {table} USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk} AND c >= {self.lo} "
                    f"AND c < {self.hi}")
        if k == "set_static":
            return (f"UPDATE {table} {self._using()} "
                    f"SET st = '{self.val}' WHERE k = {self.pk}")
        if k == "del_static":
            return (f"DELETE st FROM {table} USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk}")
        if k == "map_set":
            return (f"UPDATE {table} {self._using()} "
                    f"SET m['{self.key}'] = {self.val} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        if k == "map_del_elem":
            return (f"DELETE m['{self.key}'] FROM {table} "
                    f"USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        if k == "map_overwrite":
            lit = "{" + ", ".join(f"'{mk}': {mv}"
                                  for mk, mv in self.items.items()) + "}"
            return (f"UPDATE {table} {self._using()} SET m = {lit} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        if k == "map_append":
            lit = "{" + ", ".join(f"'{mk}': {mv}"
                                  for mk, mv in self.items.items()) + "}"
            return (f"UPDATE {table} {self._using()} SET m = m + {lit} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        if k == "del_map":
            return (f"DELETE m FROM {table} USING TIMESTAMP {self.ts} "
                    f"WHERE k = {self.pk} AND c = {self.ck}")
        return None


class OpGenerator:
    """Reproducible op stream from a seed (harry's generators role).
    Small key universe on purpose: collisions between writes, deletes
    and range tombstones are where reconcile bugs live. Timestamps
    collide on purpose too — the equal-ts ranking is a reconcile
    corner. TTLs are drawn against the VIRTUAL clock the `advance`
    ops move, so some cells expire mid-stream deterministically."""

    KINDS = [("insert", 26), ("update", 14), ("del_row", 8),
             ("del_col", 5), ("del_part", 2), ("del_range", 6),
             ("map_set", 8), ("map_del_elem", 3), ("map_overwrite", 3),
             ("map_append", 3), ("del_map", 2),
             ("set_static", 5), ("del_static", 2),
             ("advance", 5), ("flush", 9), ("compact", 4)]

    # TTL palette: 0 = none; short ones expire as the clock advances;
    # MAX_TTL exercises the expiration-overflow cap
    TTLS = (0, 0, 0, 0, 3, 8, 30, 86400, 20 * 365 * 24 * 3600)
    MAP_KEYS = ("a", "b", "cc")

    def __init__(self, seed: int, n_pks: int = 8, n_cks: int = 16,
                 features: bool = True):
        self.rng = random.Random(seed)
        self.seed = seed
        self.n_pks = n_pks
        self.n_cks = n_cks
        self._i = 0
        kinds = self.KINDS if features else [
            (k, w) for k, w in self.KINDS
            if not k.startswith(("map_", "set_static", "del_static"))
            and k not in ("del_map", "advance")]
        self._kinds = [k for k, w in kinds for _ in range(w)]

    def __iter__(self):
        return self

    def _ttl(self) -> int:
        return self.rng.choice(self.TTLS)

    def __next__(self) -> Op:
        rng = self.rng
        i = self._i
        self._i += 1
        kind = rng.choice(self._kinds)
        pk = rng.randrange(self.n_pks)
        # timestamps collide on purpose (same-ts tie-breaks are a
        # reconcile corner): draw from a window ~= op count
        ts = rng.randrange(1, max(2, self._i * 2))
        op = Op(i, kind, pk, ts=ts)
        if kind in ("insert", "update", "del_row", "del_col", "map_set",
                    "map_del_elem", "map_overwrite", "map_append",
                    "del_map"):
            op.ck = rng.randrange(self.n_cks)
        if kind == "insert":
            op.cols = {"v": f"s{self.seed}i{i}", "w": i}
            op.ttl = self._ttl()
        elif kind == "update":
            which = rng.randrange(3)
            op.cols = {}
            if which in (0, 2):
                op.cols["v"] = f"s{self.seed}u{i}"
            if which in (1, 2):
                op.cols["w"] = i
            op.ttl = self._ttl()
        elif kind == "del_col":
            op.col = rng.choice(["v", "w"])
        elif kind == "del_range":
            lo = rng.randrange(self.n_cks)
            op.lo, op.hi = lo, lo + rng.randrange(1, self.n_cks // 2)
        elif kind == "set_static":
            op.val = f"st{i}"
            op.ttl = self._ttl()
        elif kind == "map_set":
            op.key = rng.choice(self.MAP_KEYS)
            op.val = i
            op.ttl = self._ttl()
        elif kind == "map_del_elem":
            op.key = rng.choice(self.MAP_KEYS)
        elif kind in ("map_overwrite", "map_append"):
            nk = rng.randrange(1, len(self.MAP_KEYS) + 1)
            op.items = {mk: i * 10 + j for j, mk in
                        enumerate(rng.sample(self.MAP_KEYS, nk))}
            op.ttl = self._ttl()
        elif kind == "advance":
            op.seconds = rng.randrange(1, 12)
        return op


# -------------------------------------------------------------- model --


def _enc(col: str, value) -> bytes:
    """Serialized bytes of a value, as the engine compares them in
    equal-timestamp tie-breaks (text -> utf8, int -> 4-byte BE)."""
    if col in ("v", "st"):
        return str(value).encode()
    return int(value).to_bytes(4, "big", signed=True)


class _Cell:
    """(ts, value, ldt): value None = tombstone (pure, no ttl);
    ldt = NO_DELETION_TIME for non-expiring data, the delete's
    now-seconds for tombstones, the capped expiry for TTL'd cells."""
    __slots__ = ("ts", "value", "ldt", "enc")

    def __init__(self, ts, value, ldt, enc=b""):
        self.ts, self.value, self.ldt, self.enc = ts, value, ldt, enc

    @property
    def death(self) -> bool:
        return self.value is None

    def rank(self):
        """The engine's equal-ts ranking (CellBatch.sort_permutation,
        merge.cpp beats(), CASSANDRA-14592): ts, then eot, then PURE
        tombstone (model tombstones are always pure — no TTL), then
        ldt, then value bytes."""
        eot = self.death or self.ldt != NO_DELETION_TIME
        return (self.ts, eot, self.death, self.ldt, self.enc)

    def visible(self, shadow_ts: int, now: int) -> bool:
        return (not self.death) and self.ts > shadow_ts \
            and self.ldt > now


def _put(slot: dict, key, cell: _Cell) -> None:
    old = slot.get(key)
    if old is None or cell.rank() > old.rank():
        slot[key] = cell


def _data_cell(col, value, ts, ttl, now_s) -> _Cell:
    ldt = expiration_time(now_s, ttl) if ttl else NO_DELETION_TIME
    return _Cell(ts, value, ldt, _enc(col, value))


@dataclass
class _RowState:
    liveness: _Cell | None = None               # INSERT's row marker
    cells: dict = field(default_factory=dict)   # col -> _Cell
    row_del_ts: int = -1
    map_del_ts: int = -1                        # complex deletion of m
    map_elems: dict = field(default_factory=dict)   # key -> _Cell


class Model:
    """Pure-python oracle of CQL read results (QuiescentChecker model).
    apply()/reads take the VIRTUAL now (seconds) so TTL expiry is
    deterministic; the harness drives the engine with the same clock
    (utils/timeutil.CLOCK)."""

    COLS = ("v", "w")

    def __init__(self):
        self.parts: dict = {}
        # pk -> {"del_ts", "ranges", "rows", "statics"}

    def _part(self, pk):
        return self.parts.setdefault(
            pk, {"del_ts": -1, "ranges": [], "rows": {}, "statics": {}})

    def _row(self, pk, ck) -> _RowState:
        return self._part(pk)["rows"].setdefault(ck, _RowState())

    def apply(self, op: Op, now_s: int = 0) -> None:
        k = op.kind
        if k in ("flush", "compact", "advance"):
            return
        p = self._part(op.pk)
        if k == "insert":
            row = self._row(op.pk, op.ck)
            lv = _Cell(op.ts, b"", expiration_time(now_s, op.ttl)
                       if op.ttl else NO_DELETION_TIME)
            if row.liveness is None or lv.rank() > row.liveness.rank():
                row.liveness = lv
            for c, val in op.cols.items():
                _put(row.cells, c, _data_cell(c, val, op.ts, op.ttl,
                                              now_s))
        elif k == "update":
            row = self._row(op.pk, op.ck)
            for c, val in op.cols.items():
                _put(row.cells, c, _data_cell(c, val, op.ts, op.ttl,
                                              now_s))
        elif k == "del_row":
            row = self._row(op.pk, op.ck)
            row.row_del_ts = max(row.row_del_ts, op.ts)
        elif k == "del_col":
            row = self._row(op.pk, op.ck)
            _put(row.cells, op.col, _Cell(op.ts, None, now_s))
        elif k == "del_part":
            p["del_ts"] = max(p["del_ts"], op.ts)
        elif k == "del_range":
            p["ranges"].append((op.lo, op.hi, op.ts))
        elif k == "set_static":
            _put(p["statics"], "st",
                 _data_cell("st", op.val, op.ts, op.ttl, now_s))
        elif k == "del_static":
            _put(p["statics"], "st", _Cell(op.ts, None, now_s))
        elif k == "map_set":
            row = self._row(op.pk, op.ck)
            _put(row.map_elems, op.key,
                 _data_cell("m", op.val, op.ts, op.ttl, now_s))
        elif k == "map_del_elem":
            row = self._row(op.pk, op.ck)
            _put(row.map_elems, op.key, _Cell(op.ts, None, now_s))
        elif k == "map_overwrite":
            # engine: complex deletion at ts-1, then element cells at ts
            # (cql/execution.py _add_cell_ops overwrite_collection)
            row = self._row(op.pk, op.ck)
            row.map_del_ts = max(row.map_del_ts, op.ts - 1)
            for mk, mv in op.items.items():
                _put(row.map_elems, mk,
                     _data_cell("m", mv, op.ts, op.ttl, now_s))
        elif k == "map_append":
            row = self._row(op.pk, op.ck)
            for mk, mv in op.items.items():
                _put(row.map_elems, mk,
                     _data_cell("m", mv, op.ts, op.ttl, now_s))
        elif k == "del_map":
            row = self._row(op.pk, op.ck)
            row.map_del_ts = max(row.map_del_ts, op.ts)

    # ------------------------------------------------------------ reads --

    def _eff_del(self, pk, ck) -> int:
        p = self.parts.get(pk)
        if p is None:
            return -1
        d = p["del_ts"]
        for lo, hi, ts in p["ranges"]:
            if lo <= ck < hi:
                d = max(d, ts)
        row = p["rows"].get(ck)
        if row is not None:
            d = max(d, row.row_del_ts)
        return d

    def static_value(self, pk, now: int):
        """Visible static value of the partition (shadowed only by the
        partition deletion — statics have no clustering, so range and
        row tombstones never cover them)."""
        p = self.parts.get(pk)
        if p is None:
            return None
        cell = p["statics"].get("st")
        if cell is not None and cell.visible(p["del_ts"], now):
            return cell.value
        return None

    def read_partition(self, pk, now: int = 0) -> dict:
        """ck -> {col: value} for visible rows (missing col = null;
        'm' maps to a dict of visible elements; 'st' joins the
        partition's static value onto every visible row)."""
        p = self.parts.get(pk)
        if p is None:
            return {}
        st = self.static_value(pk, now)
        out = {}
        for ck, row in p["rows"].items():
            d = self._eff_del(pk, ck)
            cols = {}
            for c, cell in row.cells.items():
                if cell.visible(d, now):
                    cols[c] = cell.value
            melems = {}
            for mk, cell in row.map_elems.items():
                if cell.visible(max(d, row.map_del_ts), now):
                    melems[mk] = cell.value
            if melems:
                cols["m"] = melems
            live = bool(cols) or (
                row.liveness is not None
                and row.liveness.ts > d and row.liveness.ldt > now)
            if live:
                if st is not None:
                    cols["st"] = st
                out[ck] = cols
        if not out and st is not None:
            # a partition whose only live content is its static row
            # still yields ONE row with null clusterings (reference
            # SelectStatement static semantics; engine matches)
            out[None] = {"st": st}
        return out


def check_partition(session, model: Model, table: str, pk: int,
                    seed: int, upto: int, now: int | None = None) -> None:
    """Compare a SELECT against the model (QuiescentChecker.validate)."""
    if now is None:
        from ..utils import timeutil
        now = timeutil.now_seconds()
    rows = session.execute(
        f"SELECT c, v, w, st, m FROM {table} WHERE k = {pk}").rows
    got = {}
    for c, v, w, st, m in rows:
        cols = {}
        if v is not None:
            cols["v"] = v
        if w is not None:
            cols["w"] = w
        if st is not None:
            cols["st"] = st
        if m:
            cols["m"] = dict(m)
        got[c] = cols
    expected = model.read_partition(pk, now)
    assert got == expected, (
        f"MISMATCH seed={seed} after op {upto} pk={pk}:\n"
        f"  engine: {got}\n  model:  {expected}\n"
        f"reproduce: CTPU_FUZZ_SEED={seed}")
