"""Secondary indexes: equality 2i + TPU vector ANN, storage-attached.

Reference counterpart: index/Index.java SPI + SecondaryIndexManager; the
storage-attached model is SAI's (index/sai/): every sstable carries its
own index component (sstable_index.py), built once from that sstable and
dropped with it — no global rebuild, no unbounded in-memory map, restart
reopens components from disk. The memtable portion is served by scanning
the memtable's sorted cache at query time (small, always fresh; the
reference keeps a trie memtable index for the same role).

The vector index does exact brute-force top-k on the index's torch
device: kernel K10 (ops/ann.py, csrc/ann.cu) scores every row and
selects the k best in one call. The gathered matrix stays on the device
under `_gather`'s cache key, so a repeat query copies nothing.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..schema import TableMetadata
from . import sstable_index as ssi


class _AttachedIndex:
    """Shared machinery: per-sstable component cache keyed by generation,
    lazily built+loaded; memtable served live."""

    def __init__(self, backend, table: TableMetadata, column: str):
        self.backend = backend
        self.table = table
        self.column = column
        self.col_id = table.columns[column].column_id
        self._cache: dict = {}          # generation -> loaded component
        self._lock = threading.Lock()

    def _cfs(self):
        return self.backend.store(self.table.keyspace, self.table.name)

    def _path(self, desc) -> str:
        return ssi.component_path(desc, self.col_id)

    def _component(self, reader):
        """Load (or build-once, then load) this sstable's component.
        Serialized under the index lock: concurrent first-touch queries
        must not race the build, and a failed load must NEVER cache None
        (that would silently drop the sstable from every future lookup)."""
        gen = reader.desc.generation
        if getattr(reader, "released", False):
            # compaction removed this sstable mid-query (its fd is still
            # open): serve this one query from memory — writing a
            # component for a dead generation would orphan a file
            return self._fresh(reader)
        with self._lock:
            if gen in self._cache:
                return self._cache[gen]
            path = self._path(reader.desc)
            loaded = self._load(path)
            if loaded is None:
                # first-use build: only sstables that predate the index
                # (or lost a component to corruption) land here — new
                # sstables are covered eagerly by ensure_component in
                # the writer tail. The counter pair proves it.
                from ..service.metrics import GLOBAL as _M
                _M.incr("index.lazy_builds")
                self._build(reader)
                loaded = self._load(path)
            if loaded is None:   # disk refused twice: serve from memory
                loaded = self._fresh(reader)
            self._cache[gen] = loaded
            # drop cache entries for dead sstables
            live = {r.desc.generation for r in self._cfs().live_sstables()}
            for g in [g for g in self._cache if g not in live
                      and g != gen]:
                del self._cache[g]
            return loaded

    def _memtable_entries(self):
        """(value, pk, ck) for live cells of the column in the memtable."""
        mem = self._cfs().memtable.scan()
        if len(mem):
            yield from ssi.iter_column_cells(mem, self.col_id)

    def ensure_component(self, reader) -> bool:
        """Eagerly build+cache this sstable's component (writer tail at
        flush/compaction) so the first query after a restart — or after
        any flush — never pays the build storm. True if a build ran."""
        gen = reader.desc.generation
        if getattr(reader, "released", False):
            return False
        with self._lock:
            if gen in self._cache:
                return False
            path = self._path(reader.desc)
            loaded = self._load(path)
            built = False
            if loaded is None:
                from ..service.metrics import GLOBAL as _M
                _M.incr("index.builds")
                self._build(reader)
                loaded = self._load(path)
                built = True
            if loaded is None:
                loaded = self._fresh(reader)
            self._cache[gen] = loaded
            return built


class EqualityIndex(_AttachedIndex):
    """Storage-attached 2i: value -> (pk, ck) locators, one component per
    sstable (index/internal hidden-table role, SAI storage model)."""

    def _build(self, reader):
        ssi.build_equality(reader, self.table, self.col_id)

    def _load(self, path):
        return ssi.load_equality(path)

    def _fresh(self, reader):
        out: dict = {}
        for seg in reader.scanner():
            for v, pk, ck, _ts in ssi.iter_column_cells(seg, self.col_id):
                out.setdefault(v, []).append((pk, ck))
        return out

    def lookup(self, value: bytes) -> list:
        out = set()
        for v, pk, ck, _ts in self._memtable_entries():
            if v == value:
                out.add((pk, ck))
        for reader in self._cfs().live_sstables():
            comp = self._component(reader)
            if comp:
                out.update(comp.get(value, ()))
        return sorted(out)


class TextIndex(_AttachedIndex):
    """SASI role: analyzed-term index serving LIKE queries. Candidate
    generation is case-insensitive over ANALYZED terms (CONTAINS mode:
    tokens; PREFIX mode: whole lowercased values); the executor
    re-verifies every candidate against the live row with the
    case-sensitive LIKE predicate, so false positives drop. Token-
    boundary behavior matches SASI: a CONTAINS pattern spanning two
    tokens ('%foo bar%') cannot be served from token terms."""

    def __init__(self, backend, table: TableMetadata, column: str,
                 mode: str = "CONTAINS"):
        super().__init__(backend, table, column)
        self.mode = "PREFIX" if str(mode).upper() == "PREFIX" \
            else "CONTAINS"

    def _path(self, desc):
        return ssi.text_component_path(desc, self.col_id)

    def _build(self, reader):
        ssi.build_text(reader, self.table, self.col_id, self.mode)

    def _load(self, path):
        return ssi.load_text(path)

    def _fresh(self, reader):
        out: dict = {}
        for seg in reader.scanner():
            for v, pk, ck, _ts in ssi.iter_column_cells(seg, self.col_id):
                for term in ssi.analyze(v, self.mode):
                    out.setdefault(term, []).append((pk, ck))
        return out

    def search(self, pattern: str) -> list | None:
        """Locators whose analyzed terms can match the LIKE pattern —
        a SUPERSET; the executor re-verifies with the case-sensitive
        predicate. Returns None when the pattern cannot be served from
        this index (the executor then demands ALLOW FILTERING)."""
        hits = self._term_predicate(pattern)
        if hits is None:
            return None
        out = set()
        for v, pk, ck, _ts in self._memtable_entries():
            if any(hits(t) for t in ssi.analyze(v, self.mode)):
                out.add((pk, ck))
        for reader in self._cfs().live_sstables():
            comp = self._component(reader)
            if comp:
                for term, locs in comp.items():
                    if hits(term):
                        out.update(locs)
        return sorted(out)

    def _term_predicate(self, pattern: str):
        """term -> bool candidate test, or None if unservable. In
        PREFIX mode terms ARE whole lowercased values, so the full
        (lowercased) LIKE pattern applies exactly. In CONTAINS mode a
        value matches only if every token-pure literal piece sits
        inside some token; probing the LONGEST such piece yields a
        correct superset — a pattern with no token-pure piece (e.g.
        '%foo bar%', spanning tokens) cannot be served."""
        low = pattern.lower()
        if self.mode == "PREFIX":
            from ..cql.execution import _like_match
            return lambda term: _like_match(term.decode("utf-8",
                                                        "ignore"), low)
        import re
        pieces = [p for p in low.split("%")
                  if p and re.fullmatch(r"[0-9a-z]+", p)]
        if not pieces:
            return None
        probe = max(pieces, key=len).encode()
        return lambda term: probe in term


class VectorIndex(_AttachedIndex):
    """Exact ANN over vector<float, d> columns via K10 on the device,
    matrices persisted per sstable (index/sai/disk/v1/vector role)."""

    def __init__(self, backend, table: TableMetadata, column: str,
                 device=None):
        super().__init__(backend, table, column)
        self.dim = table.columns[column].cql_type.dimension
        # None resolves to `cuda` at the first query
        self.device = device
        self._device_cache = None   # (gathered matrix, its device copy)

    def _build(self, reader):
        ssi.build_vector(reader, self.table, self.col_id, self.dim)

    def _load(self, path):
        return ssi.load_vector(path)

    def _fresh(self, reader):
        rows, tss, keys = [], [], []
        for seg in reader.scanner():
            for v, pk, ck, ts in ssi.iter_column_cells(seg, self.col_id):
                rows.append(np.frombuffer(v, dtype=">f4")
                            .astype(np.float32))
                tss.append(ts)
                keys.append((pk, ck))
        mat = np.stack(rows) if rows \
            else np.zeros((0, self.dim), np.float32)
        return mat, np.asarray(tss, dtype=np.int64), keys

    def _gather(self):
        """(matrix, keys): memtable vectors + every live sstable's
        persisted matrix, newest-first so duplicate locators keep the
        freshest embedding. Cached until the live set or memtable
        changes (repeat ANN queries pay one matmul, not re-assembly)."""
        cfs = self._cfs()
        mem = cfs.memtable
        ver = (tuple(sorted(r.desc.generation
                            for r in cfs.live_sstables())),
               id(mem), mem.ops)
        cached = getattr(self, "_gather_cache", None)
        if cached is not None and cached[0] == ver:
            return cached[1]
        # newest CELL TIMESTAMP wins per (pk, ck): generation order is
        # not write order (USING TIMESTAMP), and a stale embedding must
        # not rank the row
        # rank key: (cell ts, source recency) — ties on USING TIMESTAMP
        # resolve to the newer source like the read path's reconcile
        best: dict = {}     # (pk, ck) -> ((ts, src), vector)
        MEM_SRC = 1 << 62   # memtable outranks any generation on ties
        for value, pk, ck, ts in self._memtable_entries():
            k = (pk, ck)
            rank = (ts, MEM_SRC)
            if k not in best or rank > best[k][0]:
                best[k] = (rank, np.frombuffer(value, dtype=">f4")
                           .astype(np.float32))
        for reader in self._cfs().live_sstables():
            comp = self._component(reader)
            if comp is None:
                continue
            mat, tss, locs = comp
            gen = reader.desc.generation
            for i, k in enumerate(locs):
                rank = (int(tss[i]), gen)
                if k not in best or rank > best[k][0]:
                    best[k] = (rank, mat[i])
        if not best:
            result = (np.zeros((0, self.dim), np.float32), [])
        else:
            keys = list(best)
            result = (np.stack([best[k][1] for k in keys]), keys)
        self._gather_cache = (ver, result)
        return result

    def _device_matrix(self, m: np.ndarray, dev) -> torch.Tensor:
        """`m` on `dev`, copied once per gathered matrix: the cache
        holds the numpy matrix itself, so a new gather (a new array)
        replaces the copy."""
        cached = self._device_cache
        if cached is not None and cached[0] is m \
                and cached[1].device == dev:
            return cached[1]
        t = torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32)
                             ).to(dev)
        self._device_cache = (m, t)
        return t

    def ann(self, query: np.ndarray, k: int,
            similarity: str = "cosine") -> list:
        """Top-k (pk, ck, score): the scores and the top k of kernel
        K10 on the index's device (index/sai vector search role)."""
        from .. import device as devmod
        from ..ops.ann import ann_topk

        m, keys = self._gather()
        if len(m) == 0 or k <= 0:
            # LIMIT 0 (or below) asks for no row: `lax.top_k` gives an
            # empty answer for k = 0, and the kernel needs 1 <= k <= n
            return []
        dev = devmod.resolve(self.device)
        q = np.asarray(query, dtype=np.float32)
        if similarity == "cosine":
            q = q / max(float(np.linalg.norm(q)), 1e-9)
        k = min(k, len(m))
        vals, idx = ann_topk(self._device_matrix(m, dev),
                             torch.from_numpy(np.ascontiguousarray(
                                 q, dtype=np.float32)).to(dev),
                             k, similarity)
        return [(keys[i][0], keys[i][1], v)
                for v, i in zip(vals.tolist(), idx.tolist())]


class IndexManager:
    """Registry (SecondaryIndexManager role). No write-path hook: the
    memtable is scanned at query time and sstable components attach to
    the sstables themselves."""

    def __init__(self, backend, device=None):
        self.backend = backend
        # the torch device of vector search (K10); None resolves to
        # `cuda` at the first query
        self.device = device
        # (keyspace, table, column) -> index
        self.indexes: dict[tuple, object] = {}
        self.by_name: dict[tuple, tuple] = {}
        self.meta: dict[tuple, dict] = {}   # key -> {custom_class, options}

    def create(self, table: TableMetadata, column: str,
               name: str | None = None, custom_class: str | None = None,
               options: dict | None = None,
               if_not_exists: bool = False):
        from ..types.marshal import VectorType
        key = (table.keyspace, table.name, column)
        if key in self.indexes:
            if if_not_exists:
                return self.indexes[key]
            # silently returning the EXISTING index would hand back the
            # wrong kind (e.g. a 2i where SASI was asked for) and never
            # register the new name — fail like the reference does
            raise ValueError(
                f"an index already exists on "
                f"{table.keyspace}.{table.name}({column})")
        col = table.columns[column]
        options = options or {}
        if custom_class and "sasi" in custom_class.lower():
            # CREATE CUSTOM INDEX ... USING 'SASIIndex'
            # WITH OPTIONS = {'mode': 'CONTAINS'|'PREFIX'}
            idx = TextIndex(self.backend, table, column,
                            mode=options.get("mode", "PREFIX"))
        elif isinstance(col.cql_type, VectorType):
            idx = VectorIndex(self.backend, table, column,
                              device=self.device)
        else:
            idx = EqualityIndex(self.backend, table, column)
        nm = (table.keyspace, name or f"{table.name}_{column}_idx")
        if nm in self.by_name and self.by_name[nm] != key:
            # a silent overwrite would orphan the shadowed index (it
            # stays live but unreachable by name AND vanishes from the
            # persisted schema, which iterates by_name)
            raise ValueError(f"index name {nm[1]!r} already in use")
        self.indexes[key] = idx
        self.by_name[nm] = key
        self.meta[key] = {"custom_class": custom_class,
                          "options": dict(options)}
        return idx

    def drop(self, keyspace: str, name: str):
        key = self.by_name.pop((keyspace, name), None)
        if key is None:
            raise KeyError(name)
        self.indexes.pop(key, None)
        self.meta.pop(key, None)

    def get(self, keyspace: str, table: str, column: str):
        return self.indexes.get((keyspace, table, column))

    def build_eager(self, table: TableMetadata, reader) -> int:
        """Writer-tail hook: build components for every index on
        `table` against a NEW sstable (flush/compaction/rewrite), so
        the lazy first-use path only ever covers pre-existing sstables.
        Returns how many components were built. Never raises — index
        build failure must not fail the flush that created the data."""
        n = 0
        for (ks, tb, _col), idx in list(self.indexes.items()):
            if ks != table.keyspace or tb != table.name:
                continue
            try:
                if idx.ensure_component(reader):
                    n += 1
            except Exception:
                pass   # first query rebuilds lazily (counted)
        return n
