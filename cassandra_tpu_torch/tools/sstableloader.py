"""sstableloader — ring-aware bulk loading of externally-written ctpu
sstables into a live cluster.

Reference counterpart: tools/BulkLoader.java — open the sstables in a
directory, discover the ring, and stream each partition's data to ALL
of its natural replicas (a loaded row must be readable at QUORUM
immediately, so every replica in the set gets its copy). Durability is
ack-based per mutation batch (the repair/decommission streaming
contract, cluster/repair.py apply_batch_to_owners).

Entry points:
  load(directory, node, keyspace, table_name) — in-process against a
      live Node (the jvm-dtest shape; tools/noded deployments reach the
      same code through `nodetool bulkload`).
  nodetool: run_command("bulkload", node=..., directory=...,
      keyspace=..., table=...).
"""
from __future__ import annotations

import os


def load(directory: str, node, keyspace: str, table_name: str,
         batch_cells: int = 65_536, timeout: float = 30.0) -> dict:
    """Stream every sstable in `directory` to the cluster's natural
    replicas. The files are opened with the CLUSTER's schema for the
    target table (like BulkLoader reading the client-provided schema),
    so offline writers must have used a compatible layout. Returns
    {"sstables": n, "cells": n, "partitions": n}."""
    from ..storage import cellbatch as cb
    from ..storage.sstable import Descriptor, SSTableReader

    table = node.schema.get_table(keyspace, table_name)
    descs = Descriptor.list_in(directory)
    if not descs:
        raise FileNotFoundError(f"no sstables under {directory}")
    n_cells = 0
    parts = set()
    for desc in descs:
        reader = SSTableReader(desc, table)
        try:
            pending: list = []
            held = 0
            for seg in reader.scanner():
                pending.append(seg)
                held += len(seg)
                if held >= batch_cells:
                    n_cells += _ship(node, keyspace, table, pending,
                                     parts, timeout)
                    pending, held = [], 0
            if pending:
                n_cells += _ship(node, keyspace, table, pending, parts,
                                 timeout)
        finally:
            reader.close()
    return {"sstables": len(descs), "cells": n_cells,
            "partitions": len(parts)}


def _ship(node, keyspace, table, segs, parts, timeout) -> int:
    """One acked ring-routed push of the buffered segments."""
    from ..storage import cellbatch as cb
    cat = cb.CellBatch.concat(segs) if len(segs) > 1 else segs[0]
    cat.sorted = True
    # local segments are already reconciled per sstable; merging here
    # keeps cross-segment partition runs contiguous for routing
    merged = cb.merge_sorted([cat])
    toks = cb.batch_tokens(merged)
    if len(toks):
        import numpy as np
        parts.update(np.unique(toks).tolist())
    node.repair.apply_batch_to_owners(keyspace, table, merged,
                                      timeout=timeout)
    return len(merged)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="sstableloader",
        description="Bulk load a directory of ctpu sstables into a "
                    "running cluster via its admin endpoint "
                    "(tools/BulkLoader.java role).")
    p.add_argument("directory")
    p.add_argument("--keyspace", required=True)
    p.add_argument("--table", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True,
                   help="admin port of any cluster node")
    p.add_argument("--secret", default=None)
    args = p.parse_args(argv)
    from ..service.admin import admin_call
    out = admin_call(args.host, args.port, "bulkload",
                     {"directory": os.path.abspath(args.directory),
                      "keyspace": args.keyspace, "table": args.table},
                     secret=args.secret
                     or os.environ.get("CTPU_ADMIN_SECRET"))
    import json
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
