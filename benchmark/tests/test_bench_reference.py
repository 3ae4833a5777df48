"""The plain reference against hand-worked cases and against the program:
its murmur3, its LZ4 block decoder, its sstable reader, what a major
compaction must write, and the comparison's numbers."""
import os
import struct

import numpy as np
import pytest

import _paths  # noqa: F401
from harness import sut
from harness.stress import Mix
from reference import ctpu_format, lww, murmur3

CFG = {"n": 40, "key_size": 10, "columns": 5, "column_size": 34,
       "compression": "LZ4Compressor", "chunk_length_in_kb": 16,
       "compaction": "SizeTieredCompactionStrategy",
       "compaction_throughput": 0, "compaction_device_compress": False}
MAJOR = {"passes": 1, "flushes_per_pass": 4, "ts_step_us": 10}
OVERWRITE = {"passes": 4, "flushes_per_pass": 1, "ts_step_us": 10}


@pytest.mark.parametrize("length", [1, 7, 8, 9, 10, 15, 16, 17, 31, 40])
def test_murmur3_matches_cassandras_hash(length):
    from cassandra_tpu_torch.utils import murmur3 as port
    rng = np.random.default_rng(length)
    keys = rng.integers(0, 256, (64, length), dtype=np.uint8)
    keys[0] = 0xFF                      # every tail byte sign-extended
    h1, h2 = murmur3.hash128(keys)
    for i, k in enumerate(keys):
        want = port.hash128(k.tobytes())
        assert (int(h1[i]), int(h2[i])) == want
        tok = int(murmur3.biased_tokens(h1[i:i + 1])[0]) - (1 << 63)
        assert tok == port.token_of(k.tobytes())


def test_murmur3_token_normalises_min():
    h1 = np.array([1 << 63], dtype=np.uint64)
    assert int(murmur3.biased_tokens(h1)[0]) == (1 << 64) - 1


@pytest.mark.parametrize("block, raw", [
    (bytes([0x50]) + b"hello", b"hello"),                   # literals only
    (bytes([0x1F, ord("a"), 1, 0, 5, 0x00]),                # run, dist 1
     b"a" * 25),
    (bytes([0x24]) + b"ab" + bytes([2, 0]) + bytes([0x10]) + b"c",
     b"ab" + b"abababab" + b"c"),                           # period 2
])
def test_lz4_decoder_hand_worked(block, raw):
    assert ctpu_format.lz4_block_decode(block, len(raw)) == raw


@pytest.mark.parametrize("block, n", [
    (bytes([0x14]) + b"a" + bytes([0, 0]), 6),               # distance 0
    (bytes([0x14]) + b"a" + bytes([2, 0]), 6),               # before start
    (bytes([0xF0, 10]) + b"x" * 5, 25),                      # short input
    (bytes([0x50]) + b"hello", 9),                           # length off
])
def test_lz4_decoder_refuses_malformed(block, n):
    with pytest.raises(ctpu_format.BadBlock):
        ctpu_format.lz4_block_decode(block, n)


@pytest.mark.parametrize("kind", ["random", "runs", "columns"])
def test_lz4_decoder_reads_the_programs_blocks(kind):
    from cassandra_tpu_torch.ops.codec import get_compressor
    rng = np.random.default_rng(7)
    raw = {"random": rng.bytes(70_000),
           "runs": bytes(rng.integers(0, 3, 70_000, dtype=np.uint8)),
           "columns": np.repeat(rng.integers(0, 1 << 30, 7_000),
                                10).astype("<i8").tobytes()}[kind]
    block = get_compressor("LZ4Compressor").compress(raw)
    assert ctpu_format.lz4_block_decode(block, len(raw)) == raw


def _brute_force(mix):
    """Last write wins by a loop over every write: {key: (ts, values)}."""
    keys = mix.keys()
    newest = {}
    for s in range(mix.sstables):
        p, lo, hi = mix.rows(s)
        ts, vals = mix.timestamps(p, lo, hi), mix.values(p, lo, hi)
        for j, i in enumerate(range(lo, hi)):
            k = keys[i].tobytes()
            if k not in newest or ts[j] > newest[k][0]:
                newest[k] = (int(ts[j]), vals[j].copy())
    return newest


@pytest.mark.parametrize("traffic", [MAJOR, OVERWRITE])
def test_expected_is_last_write_wins(traffic):
    mix = Mix.of(CFG, traffic, 2**31 + 77)
    exp = lww.expected(mix)
    newest = _brute_force(mix)
    per = 1 + mix.columns
    assert len(exp["ts"]) == per * len(newest)
    for p, key in enumerate(exp["keys"]):
        ts, vals = newest[key.tobytes()]
        cells = slice(per * p, per * p + per)
        assert (exp["ts"][cells] == ts).all()
        assert exp["lanes"][cells, 10].tolist() == [2, 8, 9, 10, 11, 12]
        off = exp["frame_off"]
        for c in range(mix.columns):
            i = per * p + 1 + c
            frame = exp["payload"][off[i]:off[i + 1]]
            assert frame[:2].tolist() == [0, 0]
            assert (frame[2:] == vals[c]).all()
    tok = (exp["part_lane4"][:, 0].astype(np.uint64) << np.uint64(32)) \
        | exp["part_lane4"][:, 1]
    assert (np.diff(tok.astype(np.float64)) >= 0).all()


def test_overwrite_keeps_the_fourth_version():
    mix = Mix.of(CFG, OVERWRITE, 5)
    exp = lww.expected(mix)
    order = np.argsort(exp["keys"].view("V10").ravel())
    keys = mix.keys()
    pos = np.argsort(keys.view("V10").ravel())
    want = mix.timestamps(3, 0, mix.n)[pos]
    assert (exp["ts"][::1 + mix.columns][order] == want).all()


def test_build_batch_equals_the_programs_builder():
    from cassandra_tpu_torch.storage.cellbatch import (CellBatchBuilder,
                                                       merge_sorted)
    mix = Mix.of(CFG, MAJOR, 123)
    table = sut.make_table(CFG, mix, 123)
    p, lo, hi = mix.rows(2)
    b = CellBatchBuilder(table)
    keys, vals = mix.keys(), mix.values(p, lo, hi)
    for j, i in enumerate(range(lo, hi)):
        ts = int(mix.timestamps(p, lo, hi)[j])
        b.add_row_liveness(keys[i].tobytes(), b"", ts)
        for c, name in enumerate(mix.column_names()):
            b.add_cell(keys[i].tobytes(), b"", table.columns[name].column_id,
                       vals[j, c].tobytes(), ts)
    want = merge_sorted([b.seal()])
    got = sut.build_batch(table, mix, 2)
    for f in ("lanes", "ts", "ldt", "ttl", "flags", "off", "val_start",
              "payload"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f
    assert want.pk_map == got.pk_map


@pytest.fixture
def written(tmp_path):
    """One compaction's worth of inputs written by the program."""
    mix = Mix.of({**CFG, "n": 2000}, OVERWRITE, 99)
    table = sut.make_table(CFG, mix, 99)
    pool = sut.make_pool(2)
    try:
        files = sut.write_inputs(str(tmp_path / "in"), table, mix, pool)
    finally:
        pool.shutdown()
    return mix, table, files


def test_reader_agrees_with_the_programs_reader(written):
    from cassandra_tpu_torch.storage.sstable import SSTableReader
    mix, table, files = written
    prefix = files[0].rsplit("-", 1)[0] + "-"
    got = ctpu_format.read_sstable(prefix)
    assert got["bad"] == 0
    r = SSTableReader(ctpu_format_descriptor(prefix), table)
    try:
        batch = next(iter(r.scanner()))
    finally:
        r.close()
    n = len(batch)
    for f in ("lanes", "ts", "ldt", "ttl", "flags"):
        assert np.array_equal(got[f][:n], getattr(batch, f)), f
    assert np.array_equal(got["frame_off"][:n + 1], batch.off)


def ctpu_format_descriptor(prefix):
    from cassandra_tpu_torch.storage.sstable import Descriptor
    d, name = os.path.split(prefix)
    ver, gen, _ = name.split("-")
    return Descriptor(d, int(gen), ver)


def _compacted(mix, table, files, root):
    import torch
    sut.link_inputs(files, root, table)
    pool = sut.make_pool(2)
    try:
        sut.compact(root, table, torch.device("cpu"), CFG, pool,
                    device_compress=False)
    finally:
        pool.shutdown()
    return sut.store_dir(root, table)


def test_compare_reads_zero_on_a_sound_output(written, tmp_path):
    mix, table, files = written
    out = _compacted(mix, table, files, str(tmp_path / "c"))
    numbers = lww.compare(out, lww.expected(mix))
    assert numbers == {"cells_wrong": 0, "blocks_bad": 0, "index_wrong": 0}


@pytest.mark.parametrize("fault", ["value", "ts", "drop", "bloom", "data",
                                   "partition"])
def test_compare_counts_each_fault(written, tmp_path, fault):
    mix, table, files = written
    out = _compacted(mix, table, files, str(tmp_path / "c"))
    exp = lww.expected(mix)
    prefix = ctpu_format.sstables_in(out)[0]
    if fault in ("bloom", "data", "partition"):
        comp = {"bloom": "Filter.db", "data": "Data.db",
                "partition": "Partitions.db"}[fault]
        with open(prefix + comp, "r+b") as f:
            raw = bytearray(f.read())
            at = {"bloom": 16, "data": len(raw) // 2,
                  "partition": 4 + 3}[fault]
            if fault == "bloom":
                raw[16:] = bytes(len(raw) - 16)
            else:
                raw[at] ^= 0x40
            f.seek(0)
            f.write(raw)
        numbers = lww.compare(out, exp)
        key = {"bloom": "index_wrong", "data": "blocks_bad",
               "partition": "index_wrong"}[fault]
        assert numbers[key] > 0
        return
    got = ctpu_format.read_sstable(prefix)
    if fault == "value":
        got["payload"] = got["payload"].copy()
        got["payload"][got["frame_off"][5] + 3] ^= 1
    elif fault == "ts":
        got["ts"] = got["ts"].copy()
        got["ts"][7] -= 1
    else:
        for col in ("lanes", "ts", "ldt", "ttl", "flags", "val_rel"):
            got[col] = got[col][:-6]
        got["frame_off"] = got["frame_off"][:-6]
    assert lww.cells_wrong(got, exp) > 0


def test_index_header_layout(written):
    mix, table, files = written
    prefix = files[0].rsplit("-", 1)[0] + "-"
    with open(prefix + "Index.db", "rb") as f:
        n_seg, k, seg_cells = struct.unpack_from("<III", f.read(12))
    assert (k, seg_cells) == (lww.K, 65536)


def test_compact_runs_the_configurations_throttle_and_strategy(
        written, tmp_path, monkeypatch):
    """`compaction_throughput` reaches the task as its limiter (0: none),
    and a strategy the harness does not run is refused."""
    import torch
    from cassandra_tpu_torch.compaction import task
    mix, table, files = written
    seen = []
    init = task.CompactionTask.__init__

    def spy(self, *a, **kw):
        seen.append(kw["limiter"])
        init(self, *a, **kw)
    monkeypatch.setattr(task.CompactionTask, "__init__", spy)
    pool = sut.make_pool(2)
    try:
        for i, rate in enumerate((0, 512)):
            root = str(tmp_path / f"c{i}")
            sut.link_inputs(files, root, table)
            sut.compact(root, table, torch.device("cpu"),
                        {**CFG, "compaction_throughput": rate}, pool)
        with pytest.raises(ValueError):
            sut.compact(root, table, torch.device("cpu"),
                        {**CFG, "compaction": "LeveledCompactionStrategy"},
                        pool)
    finally:
        pool.shutdown()
    assert seen[0] is None
    assert seen[1].mib_per_s == 512
    assert len(seen) == 2


def test_inputs_are_the_bytes_a_flush_writes(tmp_path):
    """One input sstable as write_inputs writes it equals, file by file,
    the sstable the program's own write path (mutations applied to the
    store, then a flush) writes from the same rows."""
    from cassandra_tpu_torch.storage.mutation import Mutation
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore
    mix = Mix.of({**CFG, "n": 600}, {**MAJOR, "flushes_per_pass": 1}, 31)
    table = sut.make_table(CFG, mix, 31)
    pool = sut.make_pool(2)
    try:
        files = sut.write_inputs(str(tmp_path / "in"), table, mix, pool)
    finally:
        pool.shutdown()
    p, lo, hi = mix.rows(0)
    keys, vals = mix.keys(), mix.values(p, lo, hi)
    stamps = mix.timestamps(p, lo, hi)
    muts = []
    for j, i in enumerate(range(lo, hi)):
        m = Mutation(table.id, keys[i].tobytes())
        m.add(b"", lww.COL_LIVENESS, b"", b"", int(stamps[j]),
              flags=lww.FLAG_ROW_LIVENESS)
        for c, name in enumerate(mix.column_names()):
            m.add(b"", table.columns[name].column_id, b"",
                  vals[j, c].tobytes(), int(stamps[j]))
        muts.append(m)
    cfs = ColumnFamilyStore(table, str(tmp_path / "flush"), commitlog=None)
    cfs.apply_batch(muts)
    reader = cfs.flush()
    reader.close()
    flushed = sut.store_dir(str(tmp_path / "flush"), table)
    assert cfs.directory == flushed
    names = sorted(os.path.basename(f) for f in files)
    assert names == sorted(os.listdir(flushed))
    for f in files:
        with open(f, "rb") as a, open(os.path.join(
                flushed, os.path.basename(f)), "rb") as b:
            assert a.read() == b.read(), os.path.basename(f)
