"""The one traffic generator: cassandra-stress `write` runs over the
`standard1` table, as row writes grouped into flushed sstables (plain
NumPy; imports nothing of the program).

A configuration gives the table's shape and scale (`n` keys, `key_size`,
`columns` of `column_size` bytes); a traffic mix gives how they are
written: `passes` runs of `write n=N` over `-pop seq=1..N`, where N is
the configuration's n times the mix's `pop_share` (1 where it states
none), each cut into `flushes_per_pass` equal flushes of consecutive
keys. Keys and values are uniform random bytes drawn from the seed; one
key keeps its bytes in every pass, and every pass draws new values.
Each row write carries one client timestamp in microseconds, rising by
`ts_step_us` per write in write order, so a later pass always holds the
newer version.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TS_BASE_US = 1_700_000_000_000_000   # 2023-11-14, in microseconds
MASK64 = (1 << 64) - 1


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed & MASK64, *stream]))


@dataclass(frozen=True)
class Mix:
    """One cell's writes: the configuration's sizes and the traffic's
    pattern, with the seed."""
    n: int
    key_size: int
    columns: int
    column_size: int
    passes: int
    flushes_per_pass: int
    ts_step_us: int
    seed: int

    @classmethod
    def of(cls, config: dict, traffic: dict, seed: int,
           n: int | None = None) -> "Mix":
        if n is None:
            n = round(int(config["n"]) * float(traffic.get("pop_share", 1)))
        return cls(n=int(n),
                   key_size=int(config["key_size"]),
                   columns=int(config["columns"]),
                   column_size=int(config["column_size"]),
                   passes=int(traffic["passes"]),
                   flushes_per_pass=int(traffic["flushes_per_pass"]),
                   ts_step_us=int(traffic["ts_step_us"]),
                   seed=int(seed))

    @property
    def sstables(self) -> int:
        return self.passes * self.flushes_per_pass

    def column_names(self) -> list[str]:
        return [f"C{c}" for c in range(self.columns)]

    def keys(self) -> np.ndarray:
        """(n, key_size) uint8: the key of each seq position. Distinct:
        a repeat among 80-bit random keys is refused, not repaired."""
        raw = _rng(self.seed, 0).bytes(self.n * self.key_size)
        keys = np.frombuffer(raw, dtype=np.uint8).reshape(
            self.n, self.key_size)
        if len(np.unique(keys.view(f"V{self.key_size}"))) != self.n:
            raise ValueError(f"seed {self.seed} draws a repeated key")
        return keys

    def ts0(self) -> int:
        return TS_BASE_US + int(_rng(self.seed, 1).integers(0, 1 << 30))

    def rows(self, sstable: int) -> tuple[int, int, int]:
        """(pass, first seq, end seq) of the rows flushed into sstable
        number `sstable` (write order)."""
        p, f = divmod(sstable, self.flushes_per_pass)
        lo = self.n * f // self.flushes_per_pass
        hi = self.n * (f + 1) // self.flushes_per_pass
        return p, lo, hi

    def timestamps(self, p: int, lo: int, hi: int) -> np.ndarray:
        """Client timestamps (us) of pass p's writes of seq lo..hi-1."""
        order = p * self.n + np.arange(lo, hi, dtype=np.int64)
        return self.ts0() + order * self.ts_step_us

    def values(self, p: int, lo: int, hi: int) -> np.ndarray:
        """(hi - lo, columns, column_size) uint8: pass p's values of seq
        lo..hi-1 (drawn per pass, so any slice is reproducible)."""
        width = self.columns * self.column_size
        rng = _rng(self.seed, 2, p)
        if lo:
            rng.bytes(lo * width)   # the stream up to seq lo
        raw = rng.bytes((hi - lo) * width)
        return np.frombuffer(raw, dtype=np.uint8).reshape(
            hi - lo, self.columns, self.column_size)
