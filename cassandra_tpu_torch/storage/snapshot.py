"""Snapshots: hardlinked, point-in-time copies of a table's sstables.

Reference counterpart: service/snapshot/ (SnapshotManager — hardlink-based
snapshots with a manifest, TTL optional) and nodetool snapshot /
listsnapshots / clearsnapshot.
"""
from __future__ import annotations

import json
import os
import shutil
import time


def snapshot(cfs, tag: str | None = None) -> str:
    """Hardlink every live sstable component into
    <table_dir>/snapshots/<tag>/ with a manifest. Returns the tag."""
    tag = tag or time.strftime("%Y%m%d-%H%M%S")
    snap_dir = os.path.join(cfs.directory, "snapshots", tag)
    if os.path.exists(snap_dir):
        raise ValueError(f"snapshot {tag} already exists")
    os.makedirs(snap_dir)
    files = []
    for sst in cfs.live_sstables():
        for path in sst.desc.all_paths():
            if os.path.exists(path):
                dst = os.path.join(snap_dir, os.path.basename(path))
                os.link(path, dst)   # hardlink: zero-copy, crash-safe
                files.append(os.path.basename(path))
    manifest = {
        "tag": tag,
        "created_at": time.time(),
        "keyspace": cfs.table.keyspace,
        "table": cfs.table.name,
        "files": files,
    }
    with open(os.path.join(snap_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return tag


def list_snapshots(cfs) -> list[dict]:
    base = os.path.join(cfs.directory, "snapshots")
    out = []
    if not os.path.isdir(base):
        return out
    for tag in sorted(os.listdir(base)):
        mpath = os.path.join(base, tag, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                out.append(json.load(f))
    return out


def clear_snapshot(cfs, tag: str | None = None) -> int:
    """Remove one snapshot (or all)."""
    base = os.path.join(cfs.directory, "snapshots")
    if not os.path.isdir(base):
        return 0
    tags = [tag] if tag else os.listdir(base)
    n = 0
    for t in tags:
        p = os.path.join(base, t)
        if os.path.isdir(p):
            shutil.rmtree(p)
            n += 1
    return n


def restore_snapshot(cfs, tag: str) -> int:
    """Copy a snapshot's sstables back into the live set (offline-restore
    role of the reference's refresh + sstableloader flow). Existing data
    stays; restored sstables merge by timestamp as usual."""
    snap_dir = os.path.join(cfs.directory, "snapshots", tag)
    with open(os.path.join(snap_dir, "manifest.json")) as f:
        manifest = json.load(f)
    restored = set()
    for fn in manifest["files"]:
        src = os.path.join(snap_dir, fn)
        dst = os.path.join(cfs.directory, fn)
        if not os.path.exists(dst):
            os.link(src, dst)
            restored.add(fn.split("-")[1])
    cfs.reload_sstables()
    return len(restored)
