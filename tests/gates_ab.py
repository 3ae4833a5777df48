"""Helpers shared by the tests that hold the port's tier-2 gates
(`cassandra_tpu_torch.scripts`) to the JAX package's (`scripts/`).

The JAX gates are loaded by path (`scripts/` is not a package), under
names of their own, so they never collide with a top-level module of
the same name another test put on `sys.path`. Both packages' runs see
one virtual clock and one sequence of uuid4s, so the sstables they
write (which record write timestamps, deletion times and the table id)
compare by sha256.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import time
import types
import uuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = 1_790_000_000.25
HASHED = ("Data.db", "Index.db", "Partitions.db", "Filter.db",
          "Statistics.db", "Digest.crc32")

_LOADED: dict = {}


def jax_gate(name: str):
    """scripts/<name>.py of the JAX package, loaded once per process."""
    mod = _LOADED.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"jax_scripts_{name}", os.path.join(REPO, "scripts",
                                                f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[name] = mod
    return mod


def uuid_sequence(seed: int):
    """A uuid4 stand-in that yields the same version-4 UUIDs, in the
    same order, for every call of uuid_sequence(seed)."""
    state = {"n": 0}

    def uuid4():
        state["n"] += 1
        h = hashlib.sha256(b"%d-%d" % (seed, state["n"])).digest()[:16]
        return uuid.UUID(bytes=h, version=4)
    return uuid4


def virtual_time(clock: dict):
    """A stand-in for a gate module's `time`: sleep advances `clock`
    instead of waiting; everything else is the real module."""
    ns = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                  if not k.startswith("__")})

    def sleep(s):
        clock["now"] += float(s)
    ns.sleep = sleep
    return ns


def freeze(monkeypatch, timeutils, clock: dict, seed: int) -> None:
    """Every wall-clock read of both packages at `clock["now"]`, write
    timestamps counting up from it, uuid4 from a fixed sequence."""
    clock["now"] = FROZEN
    monkeypatch.setattr(time, "time", lambda: clock["now"])
    monkeypatch.setattr(time, "time_ns", lambda: int(clock["now"] * 1e9))
    for tu in timeutils:
        monkeypatch.setattr(tu, "CLOCK", lambda: clock["now"])
        monkeypatch.setattr(tu, "_last_micros", 0)
    monkeypatch.setattr(uuid, "uuid4", uuid_sequence(seed))


def component_hashes(base: str) -> dict:
    """{path under base: sha256} of every hashed sstable component."""
    out = {}
    for dirpath, _dirs, files in os.walk(base):
        for fn in sorted(files):
            if fn.endswith(HASHED):
                p = os.path.join(dirpath, fn)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, base)] = \
                        hashlib.sha256(f.read()).hexdigest()
    return out


def tree_bytes(base: str) -> int:
    """Bytes of every file under base."""
    total = 0
    for dirpath, _dirs, files in os.walk(base):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                pass
    return total


# ------------------------------------------------- the compaction gate --

COMPACTION_CELLS = 30_000
# the JAX gate's keyword arguments of the legs tier-1 runs (its legs
# are a local of check_compaction)
JAX_COMPACTION_LEGS = {
    "serial": dict(pipelined_io=False, compress_pool=0,
                   decode_ahead=False),
    "device": dict(pipelined_io=True, compress_pool=0, decode_ahead=False,
                   engine="device", use_device=True,
                   device_compress=False),
    "device_compress": dict(pipelined_io=True, compress_pool=0,
                            decode_ahead=False, engine="device",
                            use_device=True, device_compress=True),
    "mesh2": dict(pipelined_io=True, compress_pool=0, decode_ahead=False,
                  mesh_devices=2),
}


def compaction_legs_both(base: str, monkeypatch, tags: list,
                         seed: int) -> tuple:
    """The compaction gate's fixture at 3 x COMPACTION_CELLS, built by
    each package's own `_mixed_batch`, then each package's
    `_compaction_leg` for `tags`: (jax results, port results, the
    port's table); results map tag -> (component hashes, digest)."""
    from cassandra_tpu.storage.sstable import Descriptor, SSTableWriter
    from cassandra_tpu.storage.table import ColumnFamilyStore
    from cassandra_tpu.utils import timeutil as j_timeutil
    from cassandra_tpu_torch.scripts import check_compaction_ab as port
    from cassandra_tpu_torch.utils import timeutil as t_timeutil

    clock: dict = {}
    jdir, tdir = os.path.join(base, "jax"), os.path.join(base, "port")
    jg = jax_gate("check_compaction_ab")

    freeze(monkeypatch, (j_timeutil, t_timeutil), clock, seed)
    jtable = jg._mk_table("compact")
    cfs = ColumnFamilyStore(jtable, os.path.join(jdir, "pristine"),
                            commitlog=None)
    for gen in range(1, 4):
        w = SSTableWriter(Descriptor(cfs.directory, gen), jtable,
                          estimated_partitions=256)
        w.append(jg._mixed_batch(jtable, seed=gen, n=COMPACTION_CELLS))
        w.finish()
    j_res = {tag: jg._compaction_leg(jdir, os.path.join(jdir, "pristine"),
                                     jtable, tag,
                                     **JAX_COMPACTION_LEGS[tag])
             for tag in tags}

    freeze(monkeypatch, (j_timeutil, t_timeutil), clock, seed)
    ttable = port._mk_table("compact")
    assert ttable.id == jtable.id
    port._write_pristine(os.path.join(tdir, "pristine"), ttable,
                         COMPACTION_CELLS)
    legs = port.compaction_legs("cpu")
    try:
        t_res = {tag: port._compaction_leg(
            tdir, os.path.join(tdir, "pristine"), ttable, tag,
            **legs[tag]) for tag in tags}
    finally:
        port.shutdown_pools(legs)
    return j_res, t_res, ttable
