"""Query paging: bounded-memory full scans with resumable page state.

Reference counterpart: service/pager/QueryPagers.java +
PartitionRangeQueryPager (page state = last partition key + last
clustering), AggregationQueryPager (aggregates consume pages internally).

The pager walks the token space window by window (each window = the next
`window_parts` partition tokens, discovered from the partition
directories without reading data), merges each window across
memtable + sstables, and yields assembled rows. A page break can land
INSIDE a partition: the state records (token, pk, last clustering frame)
and resumption skips rows at-or-before that position.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..utils import varint as vi
from .cellbatch import pk_lane_key
from .rows import rows_from_batch

MIN_TOKEN = -(1 << 63)


@dataclass(frozen=True)
class PagingState:
    """Position of the LAST row already returned, plus the counters that
    must survive page boundaries: the user LIMIT remaining after this
    page (reference pagers decrement the user limit in the state) and
    how many rows of the current partition were already returned (PER
    PARTITION LIMIT continuity)."""
    token: int
    pk: bytes
    ck: bytes            # serialized clustering frame ('' for static)
    remaining: int = -1  # user-LIMIT rows still owed; -1 = no limit
    ppl_seen: int = 0    # rows of `pk` already returned

    def serialize(self) -> bytes:
        out = bytearray()
        vi.write_signed_vint(self.token, out)
        vi.write_unsigned_vint(len(self.pk), out)
        out += self.pk
        vi.write_unsigned_vint(len(self.ck), out)
        out += self.ck
        vi.write_signed_vint(self.remaining, out)
        vi.write_unsigned_vint(self.ppl_seen, out)
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "PagingState":
        token, pos = vi.read_signed_vint(data, 0)
        n, pos = vi.read_unsigned_vint(data, pos)
        pk = bytes(data[pos:pos + n])
        pos += n
        n, pos = vi.read_unsigned_vint(data, pos)
        ck = bytes(data[pos:pos + n])
        pos += n
        remaining, pos = vi.read_signed_vint(data, pos)
        ppl_seen, pos = vi.read_unsigned_vint(data, pos)
        return cls(token, pk, ck, remaining, ppl_seen)


def paged_rows(store, table, now: int | None = None,
               state: PagingState | None = None, window_parts: int = 64,
               on_batch=None, limits=None):
    """Yield RowData in token order, starting strictly after `state`.
    `store` provides iter_scan(now, after, window_parts) — the local
    ColumnFamilyStore or the coordinator's distributed store. on_batch
    (optional) observes each raw window batch (guardrail hooks)."""
    after = MIN_TOKEN
    skip_key = None
    if state is not None:
        # resume INSIDE the last partition: restart the window at the
        # position's token (inclusive) and skip rows <= the position
        after = state.token - 1 if state.token > MIN_TOKEN else MIN_TOKEN
        comp = table.clustering_comp
        skip_key = (state.token, pk_lane_key(state.pk),
                    comp(state.ck) if state.ck else b"")
    from ..utils import murmur3, partitioners
    for batch in store.iter_scan(now=now, after=after,
                                 window_parts=window_parts,
                                 limits=limits):
        if on_batch is not None:
            on_batch(batch)
        for row in rows_from_batch(table, batch):
            if skip_key is not None:
                tok = partitioners.token_of(row.pk)
                pos = (tok, pk_lane_key(row.pk),
                       table.clustering_comp(row.ck_frame)
                       if row.ck_frame else b"")
                if pos <= skip_key:
                    continue
                skip_key = None   # storage order: everything after passes
            yield row


def position_of(table, row, remaining: int = -1,
                ppl_seen: int = 0) -> PagingState:
    """PagingState pointing AT this row (resume returns rows after it)."""
    from ..utils import murmur3, partitioners
    return PagingState(partitioners.token_of(row.pk), row.pk,
                       row.ck_frame,
                       remaining, ppl_seen)
