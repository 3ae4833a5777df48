"""AutoSavingCache: key/row/counter caches persisted across restarts.

Reference counterpart: cache/AutoSavingCache.java:55 +
CacheService.java — caches write their KEYS to the saved_caches
directory periodically (cache_save_period) and on drain/close; startup
reloads the keys and re-warms through the normal read path, so a
restarted node doesn't serve its first minutes from a cold cache.

Only KEYS are persisted, never values (reference behavior): the warm
pass re-reads current on-disk truth, so a stale save file can never
resurrect stale data — at worst it warms keys that no longer matter.
"""
from __future__ import annotations

import json
import os
import threading


class AutoSavingCache:
    ROW_FILE = "row_cache_keys.json"
    KEY_FILE = "key_cache_keys.json"
    COUNTER_FILE = "counter_cache_keys.json"
    MAX_KEYS = 10_000    # per cache per save (bounds warm time)

    def __init__(self, engine, directory: str | None = None,
                 period: float = 0.0):
        self.engine = engine
        self.directory = directory or os.path.join(engine.data_dir,
                                                   "saved_caches")
        os.makedirs(self.directory, exist_ok=True)
        self.counters = None     # set by Node for the counter cache
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if period and period > 0:
            self._thread = threading.Thread(
                target=self._loop, args=(period,), daemon=True,
                name="cache-saver")
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.save()

    def _loop(self, period: float) -> None:
        while not self._stop.wait(period):
            try:
                self.save()
            except Exception:
                pass   # a failed periodic save must not kill the saver

    # ---------------------------------------------------------------- save

    def _write(self, name: str, payload) -> None:
        tmp = os.path.join(self.directory, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.directory, name))

    def save(self) -> dict:
        counts = {}
        # row cache: per-table pk lists
        rows = {}
        for cfs in list(self.engine.stores.values()):
            rc = cfs.row_cache
            if rc is None:
                continue
            pks = rc.keys()[-self.MAX_KEYS:]
            if pks:
                rows[cfs.table.full_name()] = [pk.hex() for pk in pks]
        self._write(self.ROW_FILE, rows)
        counts["row"] = sum(len(v) for v in rows.values())

        # key cache: (table dir relative to data_dir, generation, pk)
        from .key_cache import GLOBAL as key_cache
        root = os.path.realpath(self.engine.data_dir)
        keys = []
        for d, gen, pk in key_cache.keys()[-self.MAX_KEYS:]:
            rd = os.path.relpath(os.path.realpath(d), root)
            if not rd.startswith(".."):
                keys.append([rd, gen, pk.hex()])
        self._write(self.KEY_FILE, keys)
        counts["key"] = len(keys)

        # counter cache: (table_id, pk, ck, column)
        if self.counters is not None:
            ckeys = [[str(tid), pk.hex(), ck.hex(), col]
                     for (tid, pk, ck, col)
                     in self.counters.cache_keys()[-self.MAX_KEYS:]]
            self._write(self.COUNTER_FILE, ckeys)
            counts["counter"] = len(ckeys)
        return counts

    # ---------------------------------------------------------------- warm

    def _read(self, name: str):
        p = os.path.join(self.directory, name)
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def warm(self) -> dict:
        """Re-warm caches from the saved key files through the normal
        read path. Called once at startup, after stores are open."""
        counts = {"row": 0, "key": 0, "counter": 0}
        rows = self._read(self.ROW_FILE) or {}
        for full_name, pks in rows.items():
            ks, _, name = full_name.partition(".")
            try:
                cfs = self.engine.store(ks, name)
            except Exception:
                continue
            if cfs.row_cache is None:
                continue
            for pk_hex in pks:
                try:
                    cfs.read_partition(bytes.fromhex(pk_hex))
                    counts["row"] += 1
                except Exception:
                    continue

        from .key_cache import GLOBAL as key_cache   # noqa: F401
        by_dir: dict[tuple, list] = {}
        for rd, gen, pk_hex in (self._read(self.KEY_FILE) or []):
            by_dir.setdefault((rd, int(gen)), []).append(
                bytes.fromhex(pk_hex))
        if by_dir:
            live = {}
            for cfs in self.engine.stores.values():
                for sst in cfs.live_sstables():
                    rd = os.path.relpath(
                        os.path.realpath(sst.desc.directory),
                        os.path.realpath(self.engine.data_dir))
                    live[(rd, sst.desc.generation)] = sst
            for key, pks in by_dir.items():
                sst = live.get(key)
                if sst is None:
                    continue   # compacted away since the save
                for pk in pks:
                    if sst.warm_key(pk):
                        counts["key"] += 1

        if self.counters is not None:
            saved = self._read(self.COUNTER_FILE) or []
            counts["counter"] = self.counters.warm_keys(saved)
        return counts
