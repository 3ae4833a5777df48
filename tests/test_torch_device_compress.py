"""K5 (the LZ4 policy match scan, ops/device_compress.py) of the
PyTorch/CUDA port against the JAX package's `segment_scan_kernel`,
`match_scan_np` and the native encoder, and the device-compress write
path of the port (CompactionTask(engine="device") with the knob at its
default) against the JAX package's. Every comparison is exact: the
port's wrappers get CPU tensors here and run the plain PyTorch versions;
the CUDA kernel is held against them on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from cassandra_tpu.compaction.task import CompactionTask as JTask
from cassandra_tpu.ops import device_compress as jdc
from cassandra_tpu.storage.table import ColumnFamilyStore as JStore
from test_device_compress import _build_inputs, _fixtures, _hashes, \
    _sorted_lanes, _table

from cassandra_tpu_torch.compaction.task import CompactionTask as TTask
from cassandra_tpu_torch.ops import device_compress as tdc
from cassandra_tpu_torch.ops.codec import CompressionParams as TCP
from cassandra_tpu_torch.ops.codec import SegmentPacker, get_compressor
from cassandra_tpu_torch.schema import TableParams as TParams
from cassandra_tpu_torch.schema import make_table as t_make_table
from cassandra_tpu_torch.service.metrics import GLOBAL as TMETRICS
from cassandra_tpu_torch.service.profiling import GLOBAL as TPROF
from cassandra_tpu_torch.storage.table import ColumnFamilyStore as TStore
from torch_tmp import tmp_path  # noqa: F401


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.copy())


def _same(port, jax_out) -> None:
    assert np.array_equal(port.numpy(), np.asarray(jax_out))


def test_distances_match_native_table():
    assert tdc.DISTANCES == jdc.DISTANCES
    assert tdc.MINMATCH == jdc.MINMATCH
    with open(os.path.join(os.path.dirname(tdc.__file__), "native",
                           "codec.cpp")) as f:
        src = f.read()
    table = src[src.index("LZ4_DIST[LZ4_NDIST] = {"):]
    table = table[table.index("{") + 1:table.index("}")]
    assert tuple(int(x) for x in table.replace("\n", "").split(",")) \
        == tdc.DISTANCES


# the fixtures of tests/test_device_compress.py:120-200: a sorted lane
# matrix with META-like bytes, the same with an order violation, and
# the 800-row pack fixture
def _scan_fixtures():
    rng = np.random.default_rng(3)
    lanes = _sorted_lanes(rng)
    yield "sorted", rng.integers(0, 8, 25 * 200, dtype=np.uint8), lanes
    rng = np.random.default_rng(4)
    lanes = _sorted_lanes(rng)
    lanes[[10, 400]] = lanes[[400, 10]]
    yield "violation", rng.integers(0, 8, 100, dtype=np.uint8), lanes
    rng = np.random.default_rng(5)
    lanes = _sorted_lanes(rng, n=800)
    meta = np.zeros(25 * 800, dtype=np.uint8)
    meta[::25] = rng.integers(0, 4, 800)
    yield "pack", meta, lanes
    yield "one-row", np.zeros(30, dtype=np.uint8), lanes[:1]


SCAN_CASES = list(_scan_fixtures())


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_segment_scan_matches_jax(case):
    name, meta, lanes = case
    jout = jdc.segment_scan_kernel(meta, lanes)
    tout = tdc.segment_scan(_t(meta), _t(lanes))
    assert len(tout) == 6
    for port, ref in zip(tout[:5], jout[:5]):
        _same(port, ref)
    assert tout[0].dtype == torch.uint8 and tout[1].dtype == torch.int32
    assert bool(tout[5]) == bool(jout[5]) == (name != "violation")


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_policy_scan_matches_numpy_and_native(name):
    data = _fixtures()[name]
    src = np.frombuffer(data, dtype=np.uint8)
    bl, bd = tdc.policy_scan_plain(_t(src))
    rbl, rbd = jdc.match_scan_np(src)
    assert np.array_equal(bl.numpy(), rbl)
    assert np.array_equal(bd.numpy(), rbd)
    assert tdc.compress_torch(data, device="cpu") \
        == get_compressor("LZ4Compressor").compress(data)


@pytest.mark.parametrize("n", [1, 2, 5, 13, 63, 64, 65, 129, 100_000])
def test_policy_scan_short_and_constant(n):
    """n < 64 skips the distances >= n (the `if d >= n: break` edge);
    a long constant run matches at d = 1 to the end of the block."""
    rng = np.random.default_rng(n)
    for src in (rng.integers(0, 3, n, dtype=np.uint8),
                np.full(n, 7, dtype=np.uint8)):
        bl, bd = tdc.policy_scan_plain(_t(src))
        rbl, rbd = jdc.match_scan_np(src)
        assert np.array_equal(bl.numpy(), rbl)
        assert np.array_equal(bd.numpy(), rbd)
    bl, bd = tdc.policy_scan_plain(_t(np.full(n, 7, dtype=np.uint8)))
    assert bl.numpy().tolist() == [0] + list(range(n - 1, 0, -1))
    assert bd.numpy().tolist() == [0] + [1] * (n - 1)


def _pieces(seed: int) -> np.ndarray:
    """For every distance d = 1..64 a stretch of period d (a random
    head of d bytes repeated), between random bytes; then a block
    repeated 128 and 1,024 bytes on (two long distances); then a
    constant run to the end."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(1, 65):
        out.append(rng.integers(0, 256, 3 + d % 5, dtype=np.uint8))
        out.append(np.tile(rng.integers(0, 4, d, dtype=np.uint8),
                           4 + 40 // d)[:3 * d + 7])
    blk = rng.integers(0, 256, 128, dtype=np.uint8)
    out += [blk, blk, rng.integers(0, 256, 768, dtype=np.uint8), blk,
            blk[:50], np.full(301, 9, dtype=np.uint8)]
    return np.concatenate(out)


@pytest.mark.parametrize("tile", [16, 64, tdc.LZ_TILE])
def test_tiled_scan_matches_numpy(tile):
    """K5's word-wide design (policy_scan_tiled_plain) against the
    numpy reference: runs of every short distance across tile edges,
    runs to the end of the input, long distances, and inputs shorter
    than a distance, whatever the length's remainder by 4."""
    src = _pieces(tile)
    cases = [src, src[:-1], src[:-2], src[:-3]]
    rng = np.random.default_rng(tile)
    for n in (1, 2, 3, 4, 5, 63, 64, 65, 66, 127, 128, 129, 131):
        cases += [rng.integers(0, 2, n, dtype=np.uint8),
                  np.full(n, 5, dtype=np.uint8)]
    for c in cases:
        bl, bd = tdc.policy_scan_tiled_plain(_t(c), tile)
        rbl, rbd = jdc.match_scan_np(c)
        assert np.array_equal(bl.numpy(), rbl), c.size
        assert np.array_equal(bd.numpy(), rbd), c.size
    bl, bd = tdc.policy_scan_tiled_plain(_t(src), tile)
    assert set(bd.numpy().tolist()) >= set(range(1, 65)) | {128}
    assert int(bl[-300]) == 300          # the constant run to the end


def test_tie_break_smallest_distance():
    src = np.frombuffer(b"ab" * 64, dtype=np.uint8)
    bl, bd = tdc.policy_scan_plain(_t(src))
    assert int(bd[2]) == 2 and int(bl[2]) >= tdc.MINMATCH
    jbl, jbd = jdc._scan_kernel(src)
    _same(bl, jbl)
    _same(bd, jbd)


def test_order_violation_flag():
    rng = np.random.default_rng(6)
    lanes = _sorted_lanes(rng)
    assert bool(tdc.segment_scan(_t(np.zeros(50, np.uint8)), _t(lanes))[5])
    # equal rows are in order; a swap below is not
    lanes[1] = lanes[0]
    assert bool(tdc.segment_scan(_t(np.zeros(50, np.uint8)), _t(lanes))[5])
    lanes[[0, 100]] = lanes[[100, 0]]
    assert not bool(tdc.segment_scan(_t(np.zeros(50, np.uint8)),
                                     _t(lanes))[5])


def test_pack_device_segment_matches_segment_pack():
    """pack_device_segment fed the port's scans equals the port's native
    SegmentPacker for every attempt combination and with the maxlen
    clamp engaged."""
    _name, meta, lanes = SCAN_CASES[2]
    rng = np.random.default_rng(5)
    payload = rng.integers(97, 122, 6000, dtype=np.uint8)
    packer = SegmentPacker.create(get_compressor("LZ4Compressor"))
    assert packer is not None and packer._cid == 1
    planes, mbl, mbd, lbl, lbd, ok = tdc.segment_scan(_t(meta), _t(lanes))
    assert bool(ok)
    scans = ((mbl.numpy(), mbd.numpy()), (lbl.numpy(), lbd.numpy()))
    for maxlen in (1 << 62, 1200):
        for att in ((True,) * 3, (True, True, False), (False, True, True),
                    (True, False, False), (False,) * 3):
            total, sizes, crcs, parts = tdc.pack_device_segment(
                meta, planes.numpy(), scans, payload, att, maxlen)
            out = np.zeros(meta.size + lanes.nbytes + payload.size + 64,
                           dtype=np.uint8)
            rtotal, rsizes, _raws, rcrcs = packer.pack(
                [meta, lanes, payload], list(att), maxlen, shuffle_block=1,
                lane_width=lanes.shape[1], out=out)
            assert total == rtotal, (maxlen, att)
            assert sizes == list(rsizes), (maxlen, att)
            assert crcs == list(rcrcs), (maxlen, att)
            assert b"".join(parts) == out[:rtotal].tobytes(), (maxlen, att)


@pytest.mark.parametrize("att", [(True,) * 3, (True, True, False),
                                 (False, False, True), (False,) * 3])
def test_pack_device_segment_bills_emission_and_payload_scan_apart(att):
    """acct is billed one "emit" per attempted block and one
    "payload_scan" only when the payload block is attempted; the stored
    bytes are those of the call without acct."""
    _name, meta, lanes = SCAN_CASES[2]
    payload = np.random.default_rng(6).integers(97, 122, 6000,
                                                dtype=np.uint8)
    planes, mbl, mbd, lbl, lbd, _ok = tdc.segment_scan(_t(meta), _t(lanes))
    scans = ((mbl.numpy(), mbd.numpy()), (lbl.numpy(), lbd.numpy()))
    billed = []
    out = tdc.pack_device_segment(meta, planes.numpy(), scans, payload, att,
                                  1 << 62, acct=lambda k, dt: billed.append(
                                      (k, dt)))
    assert out == tdc.pack_device_segment(meta, planes.numpy(), scans,
                                          payload, att, 1 << 62)
    keys = [k for k, _dt in billed]
    assert keys.count("emit") == sum(att)
    assert keys.count("payload_scan") == int(att[2])
    assert all(dt >= 0 for _k, dt in billed)


# ------------------------------------------------- the write path, whole --

def _port_table(jt):
    t = t_make_table(
        jt.keyspace, jt.name, pk=["id"], ck=["c"],
        cols={"id": "int", "c": "int", "v": "blob"},
        params=TParams(compression=TCP("LZ4Compressor",
                                       chunk_length=16 * 1024)))
    t.id = jt.id
    return t


def _inputs(tmp_path, name: str, n_per: int, legs: tuple):
    """Inputs built once by the JAX package, copied for every leg."""
    jt = _table(name)
    base = tmp_path / "base"
    jcfs = JStore(jt, str(base), commitlog=None)
    _build_inputs(jcfs, jt, n_ssts=2, n_per=n_per)
    rel = os.path.relpath(jcfs.directory, str(base))
    for leg in legs:
        shutil.copytree(jcfs.directory, str(tmp_path / leg / rel))
    return jt


def _run(task_cls, store_cls, table, root, **kw) -> dict:
    cfs = store_cls(table, root, commitlog=None)
    cfs.reload_sstables()
    gate = kw.pop("gate", None)
    if gate is not None:
        cfs.device_compress_fn = gate
    task_cls(cfs, cfs.tracker.view(), **kw).execute()
    h = _hashes(cfs.directory)
    for r in cfs.live_sstables():
        r.close()
    return h


def _calls(name: str) -> int:
    return TPROF.snapshot()["kernels"].get(name, {}).get("calls", 0)


def test_default_device_compress_matches_jax_and_native(tmp_path):
    """The device engine with the knob at its default compresses full
    segments through K5: sha256-equal to the JAX package's
    device-compress compaction and to the port's native engine."""
    jt = _inputs(tmp_path, "dcdefault", 40_000, ("jax", "port", "native"))
    jh = _run(JTask, JStore, jt, str(tmp_path / "jax"), engine="device",
              device_compress=True, compress_pool=0)
    tt = _port_table(jt)
    before = _calls("write.segment_scan")
    tried0 = TMETRICS.counter("compaction.device_pack.tried.meta")
    th = _run(TTask, TStore, tt, str(tmp_path / "port"), engine="device",
              device="cpu", compress_pool=0)
    assert _calls("write.segment_scan") == before + 1   # 1 full segment
    assert TMETRICS.counter("compaction.device_pack.tried.meta") \
        == tried0 + 1
    nh = _run(TTask, TStore, tt, str(tmp_path / "native"), engine="native")
    assert th == jh == nh and len(th) == 4


def test_device_compress_knob_flip_mid_compaction(tmp_path):
    """The gate is re-read per segment: device for the first full
    segment, host for the next; bytes equal the pinned-off leg."""
    jt = _inputs(tmp_path, "dcflip", 70_000, ("flip", "pinned"))
    tt = _port_table(jt)
    calls = [0]

    def knob():
        calls[0] += 1
        return calls[0] <= 1

    before = _calls("write.segment_scan")
    flipped = _run(TTask, TStore, tt, str(tmp_path / "flip"),
                   engine="device", device="cpu", compress_pool=0,
                   gate=knob)
    assert calls[0] >= 2
    assert _calls("write.segment_scan") == before + 1
    pinned = _run(TTask, TStore, tt, str(tmp_path / "pinned"),
                  engine="device", device="cpu", device_compress=False)
    assert flipped == pinned


@pytest.mark.parametrize("where", ["segment_scan", "pack_device_segment"])
def test_device_compress_failure_raises(tmp_path, monkeypatch, where):
    """The opposite of the JAX package's per-segment fallback: a failing
    device scan or device pack fails the compaction, and no fallback is
    counted."""
    jt = _inputs(tmp_path, f"dcfail{where[:4]}", 40_000, ("port",))

    def boom(*a, **k):
        raise RuntimeError("injected device-compress failure")

    monkeypatch.setattr(tdc, where, boom)
    before = TMETRICS.counter("compaction.device_compress_fallback")
    with pytest.raises(RuntimeError, match="injected"):
        _run(TTask, TStore, _port_table(jt), str(tmp_path / "port"),
             engine="device", device="cpu", device_compress=True)
    assert TMETRICS.counter("compaction.device_compress_fallback") == before
