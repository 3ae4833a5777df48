"""Offline sstable tools for the ctpu format.

Reference counterpart: tools/SSTableExport (sstabledump),
SSTableMetadataViewer (sstablemetadata), StandaloneVerifier
(sstableverify). These operate on sstable files directly — no engine,
no commitlog — which is why SSTableReader tolerates a missing table
(schema-dependent decoding degrades to raw cell output).

Usage:
  python -m cassandra_tpu_torch.tools.sstabletools dump --data <dir> \
      --keyspace ks --table t [--generation N]
  python -m cassandra_tpu_torch.tools.sstabletools metadata ... | verify ...
"""
from __future__ import annotations

import argparse
import json
import sys


def _descriptors(engine_dir: str, keyspace: str, table: str):
    import glob
    import os

    from ..storage.sstable.format import Descriptor
    pattern = os.path.join(engine_dir, keyspace, f"{table}-*")
    dirs = glob.glob(pattern)
    if not dirs:
        raise SystemExit(f"no table directory matches {pattern}")
    out = []
    for d in dirs:
        out.extend(Descriptor.list_in(d))
    return sorted(out, key=lambda d: d.generation)


def _load_table(engine_dir: str, keyspace: str, table: str):
    """Schema from the engine's persisted schema.json (best effort)."""
    import os

    from ..schema import Schema, load_schema_dict
    path = os.path.join(engine_dir, "schema.json")
    if not os.path.exists(path):
        return None
    schema = Schema()
    with open(path) as f:
        load_schema_dict(schema, json.load(f))
    try:
        return schema.get_table(keyspace, table)
    except KeyError:
        return None


def dump(engine_dir: str, keyspace: str, table: str,
         generation: int | None = None) -> list[dict]:
    """sstabledump: rows as JSON (typed when the schema is available,
    raw cell tuples otherwise)."""
    from ..storage.rows import row_to_dict, rows_from_batch
    from ..storage.sstable import SSTableReader

    t = _load_table(engine_dir, keyspace, table)
    out = []
    for desc in _descriptors(engine_dir, keyspace, table):
        if generation is not None and desc.generation != generation:
            continue
        r = SSTableReader(desc, t)
        entry: dict = {"generation": desc.generation, "rows": []}
        if t is not None:
            for seg in r.scanner():
                for row in rows_from_batch(t, seg):
                    entry["rows"].append(row_to_dict(t, row))
        else:
            for seg in r.scanner():
                for i in range(len(seg)):
                    ck, path, value = seg.cell_payload(i)
                    entry["rows"].append({
                        "pk": seg.partition_key(i).hex(),
                        "ck": ck.hex(), "path": path.hex(),
                        "value": value.hex(), "ts": int(seg.ts[i]),
                        "flags": int(seg.flags[i])})
        r.close()
        out.append(entry)
    return out


def metadata(engine_dir: str, keyspace: str, table: str,
             generation: int | None = None) -> list[dict]:
    """sstablemetadata: the Statistics.db view per sstable."""
    from ..storage.sstable import SSTableReader
    out = []
    for desc in _descriptors(engine_dir, keyspace, table):
        if generation is not None and desc.generation != generation:
            continue
        r = SSTableReader(desc)
        out.append({
            "generation": desc.generation,
            "cells": r.n_cells, "partitions": r.n_partitions,
            "min_ts": r.min_ts, "max_ts": r.max_ts,
            "tombstones": r.n_tombstones, "level": r.level,
            "repaired_at": r.repaired_at,
            "min_token": r.min_token(), "max_token": r.max_token(),
            "data_bytes": r.data_size, "total_bytes": r.size_bytes,
        })
        r.close()
    return out


def verify(engine_dir: str, keyspace: str, table: str,
           generation: int | None = None,
           quarantine: bool = False) -> list[dict]:
    """sstableverify: full-file digest check + segment CRC walk.
    quarantine=True moves every failing sstable's components into the
    table directory's quarantine/ set (storage/failures.py layout) so a
    failed verify never leaves a known-corrupt file live for the next
    engine open to trip over."""
    from ..storage.failures import quarantine_descriptor_files
    from ..storage.sstable import SSTableReader
    from ..storage.sstable.reader import CorruptSSTableError
    out = []
    for desc in _descriptors(engine_dir, keyspace, table):
        if generation is not None and desc.generation != generation:
            continue
        status = "ok"
        try:
            r = SSTableReader(desc)
            try:
                if not r.verify_digest():
                    status = "digest mismatch"
                else:
                    for _ in r.scanner():   # every segment, CRC-checked
                        pass
            finally:
                r.close()
        except (CorruptSSTableError, OSError) as e:
            status = f"corrupt: {e}"
        entry = {"generation": desc.generation, "status": status}
        if status != "ok" and quarantine:
            entry["quarantined"] = quarantine_descriptor_files(
                desc, reason=status)["path"]
        out.append(entry)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="sstabletools")
    p.add_argument("command", choices=["dump", "metadata", "verify"])
    p.add_argument("--data", required=True)
    p.add_argument("--keyspace", required=True)
    p.add_argument("--table", required=True)
    p.add_argument("--generation", type=int)
    p.add_argument("--quarantine", action="store_true",
                   help="verify only: move failing sstables into the "
                        "table's quarantine/ set")
    args = p.parse_args(argv)
    fn = {"dump": dump, "metadata": metadata, "verify": verify}[args.command]
    kw = {"quarantine": args.quarantine} if args.command == "verify" else {}
    print(json.dumps(fn(args.data, args.keyspace, args.table,
                        args.generation, **kw), indent=2, default=str))


if __name__ == "__main__":
    main()
