"""Range tombstones: clustering-range deletion markers.

Reference counterpart: db/RangeTombstone.java + db/RangeTombstoneList.java
(normalized slice list, newest-wins on overlap), db/ClusteringBound.java
(inclusive/exclusive prefix bounds), db/rows/RangeTombstoneMarker.java
(merge participation).

Columnar formulation: a range tombstone is ONE cell — column sentinel
COL_RANGE_TOMB, ck frame = the start bound's composite (so its identity
lanes position it inside its partition), cell path = the encoded
(start-kind, end bound, end-kind) suffix (so distinct ranges are distinct
cells and an identical re-write reconciles newest-wins through the
ordinary cell machinery). Coverage is evaluated per partition against the
full byte-comparable clustering composites, which the cells already carry
in their payload frames — the marker's position in the sorted stream is
NOT load-bearing, so prefix-lane hash ordering cannot corrupt range
semantics.

Bound semantics on composites (composites are self-terminating, so a
byte-prefix relationship == a clustering-prefix relationship):
  start (P, inclusive): covers rows R == P, R extending P, and R > P
  start (P, exclusive): covers only R > P that do NOT extend P
  end   (P, inclusive): covers rows R == P, R extending P, and R < P
  end   (P, exclusive): covers only R < P that do NOT extend P
An open bound is P = b"" inclusive. Static cells (ck frame == b"") are
never covered — range tombstones do not delete the static row
(reference: Clustering.STATIC_CLUSTERING sorts outside all bounds).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..utils import varint as vi


@dataclass(frozen=True)
class Slice:
    start: bytes          # composite of the start bound (b"" = open)
    start_incl: bool
    end: bytes            # composite of the end bound (b"" = open)
    end_incl: bool
    ts: int               # deletion timestamp (markedForDeleteAt)
    ldt: int              # local deletion time (purge clock)

    # ---------------------------------------------------------- encoding --

    def encode_path(self) -> bytes:
        """The cell-path payload: kinds byte + end bound."""
        kinds = (1 if self.start_incl else 0) | \
            (2 if self.end_incl else 0)
        out = bytearray([kinds])
        vi.write_unsigned_vint(len(self.end), out)
        out += self.end
        return bytes(out)

    @classmethod
    def from_cell(cls, ck: bytes, path: bytes, ts: int,
                  ldt: int) -> "Slice":
        kinds = path[0]
        n, pos = vi.read_unsigned_vint(path, 1)
        end = bytes(path[pos:pos + n])
        return cls(ck, bool(kinds & 1), end, bool(kinds & 2), ts, ldt)

    # ---------------------------------------------------------- coverage --

    @staticmethod
    def _start_covers(p: bytes, incl: bool, r: bytes) -> bool:
        if r.startswith(p):           # equal or clustering-prefix extension
            return incl
        return r > p

    @staticmethod
    def _end_covers(p: bytes, incl: bool, r: bytes) -> bool:
        if not p:                     # open end
            return True
        if r.startswith(p):
            return incl
        return r < p

    def covers_row(self, r: bytes) -> bool:
        """Does this slice delete row with full clustering composite r?
        (r == b'' — the static row — is never covered.)"""
        if not r:
            return False
        return self._start_covers(self.start, self.start_incl, r) and \
            self._end_covers(self.end, self.end_incl, r)

    # start_a positioned at-or-before start_b?
    @staticmethod
    def _start_le(pa: bytes, ia: bool, pb: bytes, ib: bool) -> bool:
        if pa == pb:
            return ia or not ib
        if pb.startswith(pa):   # a's bound is a prefix of b's
            return ia           # inclusive prefix start precedes extensions
        if pa.startswith(pb):
            return not ib       # b inclusive -> b precedes everything a-ish
        return pa < pb

    @staticmethod
    def _end_ge(pa: bytes, ia: bool, pb: bytes, ib: bool) -> bool:
        if pa == b"" != pb:
            return True
        if pb == b"" != pa:
            return False
        if pa == pb:
            return ia or not ib
        if pb.startswith(pa):
            return ia           # inclusive prefix end follows extensions
        if pa.startswith(pb):
            return not ib
        return pa > pb

    def contains(self, other: "Slice") -> bool:
        """Does this slice's range fully cover other's range?"""
        return self._start_le(self.start, self.start_incl,
                              other.start, other.start_incl) and \
            self._end_ge(self.end, self.end_incl,
                         other.end, other.end_incl)


def covering_ts(slices: list[Slice], r: bytes) -> int:
    """Max deletion timestamp over the slices covering row r;
    NO_TIMESTAMP (int64 min) when none do."""
    best = -(1 << 63)
    for s in slices:
        if s.ts > best and s.covers_row(r):
            best = s.ts
    return best
