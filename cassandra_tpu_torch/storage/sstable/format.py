"""The 'ctpu' SSTable format: columnar, segment-chunked, device-friendly.

Reference counterpart: io/sstable/format/SSTableFormat.java:45 (the format
SPI), Component.java:38, Descriptor.java. The reference's formats (big,
bti) serialize rows; ctpu stores the CellBatch lane arrays directly so
compaction and reads decode straight into device-ready columns:

  Data.db        sequence of segments; each segment = 3 compressed+CRC32
                 blocks: META (ts/ldt/ttl/flags/off/val_start arrays),
                 LANES (uint32[n,K]), PAYLOAD (the variable-length blob)
  Index.db       fixed-width segment entries: data offset, per-block
                 (compressed len, uncompressed len, crc), cell count,
                 first/last identity lanes  (role of big-format Index.db +
                 CompressionInfo.db, io/compress/CompressionMetadata.java)
  Partitions.db  partition directory: (lane4 key, first global cell index,
                 pk bytes) sorted by lane4 — binary-searchable
                 (role of bti Partitions.db)
  Filter.db      bloom filter over partition keys (utils/BloomFilter.java)
  Statistics.db  JSON stats (io/sstable/metadata/StatsMetadata.java)
  Digest.crc32   CRC32 of Data.db
  TOC.txt        component list
"""
from __future__ import annotations

import os
import re

SEGMENT_CELLS = 65536  # cells per segment (device batch granularity)
# bumped on layout changes; "cb": Digest.crc32 holds crc32 over the
# per-block crc words instead of the raw Data.db byte stream; "cc": the
# LANES block is stored byte-plane SHUFFLED (blosc-style filter over the
# u32 lane matrix — measured better ratio AND 1.2-3x faster codec passes
# on lz4 and zstd both; readers transpose back); "cd": the meta block's
# absolute i64 off/val_start pair (16 B/cell) is replaced by u32
# frame-length deltas + u32 value offsets (8 B/cell) — readers rebuild
# the absolute offsets with one cumsum; "ce": the meta block's ts lane
# is stored as per-segment wraparound deltas (first cell absolute) —
# a delta pre-transform ahead of the codec, the meta-lane analog of the
# lanes shuffle: identity-sorted neighbours share timestamp locality on
# real workloads (time-series especially), and mod-2^64 arithmetic
# makes the cumsum rebuild exact for any i64 values. Both the host
# serializer and the device fused-serialize kernel (ops/device_write.py)
# emit the identical transform.
FORMAT_VERSION = "ce"


class Component:
    DATA = "Data.db"
    INDEX = "Index.db"
    PARTITIONS = "Partitions.db"
    FILTER = "Filter.db"
    STATS = "Statistics.db"
    DIGEST = "Digest.crc32"
    TOC = "TOC.txt"
    # optional: present only on encrypted tables (TDE envelope: key id +
    # per-component nonces — security/EncryptionContext role)
    ENCRYPTION = "Encryption.db"
    # optional: per-segment zone maps for analytical scans (absent on
    # encrypted tables — plaintext bounds would leak through TDE)
    ZONEMAP = "ZoneMap.db"
    ALL = [DATA, INDEX, PARTITIONS, FILTER, STATS, DIGEST, TOC]
    OPTIONAL = [ENCRYPTION, ZONEMAP]


_NAME_RE = re.compile(r"^(?P<version>[a-z]{2})-(?P<gen>\d+)-(?P<comp>.+)$")


class Descriptor:
    """Identifies one sstable: directory + version + generation.
    File naming: `<version>-<generation>-<Component>` inside the table dir
    (reference naming: Descriptor.java `<version>-<id>-<format>-<component>`)."""

    def __init__(self, directory: str, generation: int,
                 version: str = FORMAT_VERSION):
        self.directory = directory
        self.generation = generation
        self.version = version

    def path(self, component: str) -> str:
        return os.path.join(self.directory,
                            f"{self.version}-{self.generation}-{component}")

    def tmp_path(self, component: str) -> str:
        return os.path.join(self.directory,
                            f"tmp-{self.version}-{self.generation}-{component}")

    def all_paths(self) -> list[str]:
        return [self.path(c) for c in Component.ALL + Component.OPTIONAL]

    def exists(self) -> bool:
        return os.path.exists(self.path(Component.TOC))

    @classmethod
    def list_in(cls, directory: str) -> list["Descriptor"]:
        """Discover complete sstables (TOC present) in a table directory."""
        out = []
        if not os.path.isdir(directory):
            return out
        for fn in os.listdir(directory):
            m = _NAME_RE.match(fn)
            if m and m.group("comp") == Component.TOC:
                out.append(cls(directory, int(m.group("gen")),
                               m.group("version")))
        out.sort(key=lambda d: d.generation)
        return out

    @classmethod
    def next_generation(cls, directory: str) -> int:
        gens = [0]
        if os.path.isdir(directory):
            for fn in os.listdir(directory):
                m = _NAME_RE.match(fn.removeprefix("tmp-"))
                if m:
                    gens.append(int(m.group("gen")))
        return max(gens) + 1

    def __repr__(self):
        return f"Descriptor({self.directory}, gen={self.generation})"

    def __eq__(self, other):
        return (isinstance(other, Descriptor)
                and self.directory == other.directory
                and self.generation == other.generation)

    def __hash__(self):
        return hash((self.directory, self.generation))
