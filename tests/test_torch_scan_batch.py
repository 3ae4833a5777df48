"""Phase A of the port's filtered scan masks a run of device-gated
segments with one K9 call (`device_scan.mask_run`, at most RUN_KEYS
keys): the counterpart of tests/test_scan_pushdown.py's
`test_mid_scan_gate_flip` on sstables cut into small segments, with a
cap small enough that a source spans several runs and a run spans
several segments. On the CPU (the plain versions), against the JAX
package's engine on the same sstables:

- the candidates equal the JAX package's, whatever the gate does;
- the device and host segment counts are the JAX package's when the
  gate flips mid-scan, and equal the gate's answers;
- the mask calls (`device_scan.scan_mask`, counted here) are the runs
  that the cap and the gate give: a run ends at a host-gated segment,
  at the end of a source, or before a segment that would take it past
  the cap; their sizes are the runs' key counts."""
from __future__ import annotations

import numpy as np
import pytest

from cassandra_tpu.cql import Session as JSession
from cassandra_tpu.ops import device_scan as jds
from cassandra_tpu.schema import Schema as JSchema
from cassandra_tpu.storage import cellbatch as jcb
from cassandra_tpu.storage.engine import StorageEngine as JEngine
from cassandra_tpu.storage.sstable import Descriptor as JDescriptor
from cassandra_tpu.storage.sstable import SSTableWriter as JWriter
from cassandra_tpu.tools import bulk as jbulk

from cassandra_tpu_torch.cql import Session as TSession
from cassandra_tpu_torch.index import sstable_index as ssi
from cassandra_tpu_torch.ops import device_scan as tds
from cassandra_tpu_torch.schema import Schema as TSchema
from cassandra_tpu_torch.storage import cellbatch as tcb
from cassandra_tpu_torch.storage.engine import StorageEngine as TEngine
from cassandra_tpu_torch.storage.sstable import Descriptor as TDescriptor
from cassandra_tpu_torch.storage.sstable import SSTableWriter as TWriter
from cassandra_tpu_torch.tools import bulk as tbulk
from scan_runs import CAP, SEGMENT, SOURCES, runs, segment_keys
from scan_runs import write_sources
from torch_tmp import tmp_path  # noqa: F401

JPKG = (jcb, jbulk, JDescriptor, JWriter)
TPKG = (tcb, tbulk, TDescriptor, TWriter)


@pytest.fixture
def stores(tmp_path):
    je = JEngine(str(tmp_path / "jax"), JSchema(), commitlog_sync="batch")
    te = TEngine(str(tmp_path / "torch"), TSchema(), commitlog_sync="batch",
                 device="cpu")
    try:
        jcfs = write_sources(je, JSession(je), JPKG, 5)
        tcfs = write_sources(te, TSession(te), TPKG, 5)
        yield jcfs, tcfs
    finally:
        je.close()
        te.close()


def _gate(pattern):
    """A gate answering `pattern` in turn (then True); records calls."""
    calls = []

    def gate():
        calls.append(pattern[len(calls)] if len(calls) < len(pattern)
                     else True)
        return calls[-1]
    return gate, calls


# answers per gated segment (21: three sources of seven): the first two
# on the host, then a flip mid-source; the second source all on the
# host; the third flips back and forth
PATTERNS = {
    "flip_mid_source": [False, False] + [True] * 5 + [False] * 7
                       + [True, True, False] + [True] * 4,
    "all_device": [True] * 21,
    "all_host": [False] * 21,
    "alternating": [True, False] * 11,
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("op,bound", [("<", 0), ("=", 7), ("!=", 3)])
def test_runs_match_jax_and_the_cap(stores, monkeypatch, name, op, bound):
    jcfs, tcfs = stores
    pattern = PATTERNS[name]
    jp = jds.compile_predicate(jcfs.table,
                               [(jcfs.table.columns["v"], op, bound)])
    tp = tds.compile_predicate(tcfs.table,
                               [(tcfs.table.columns["v"], op, bound)])
    monkeypatch.setattr(tds, "RUN_KEYS", CAP)
    sizes = []
    real = tds.scan_mask

    def counted(keys, kop, qkeys):
        sizes.append(int(keys.shape[0]))
        return real(keys, kop, qkeys)

    monkeypatch.setattr(tds, "scan_mask", counted)
    jgate, jcalls = _gate(pattern)
    tgate, tcalls = _gate(pattern)
    jout, jinfo = jcfs.scan_filtered(jp, use_device=jgate)
    tout, tinfo = tcfs.scan_filtered(tp, use_device=tgate)
    assert [pk for pk, _ in tout] == [pk for pk, _ in jout]
    assert tinfo == jinfo
    assert tcalls == jcalls
    assert tinfo["device_segments"] == sum(tcalls)
    assert tinfo["host_segments"] == len(tcalls) - sum(tcalls)
    segments = segment_keys(tcfs, tp, ssi, tds)
    assert len(segments) == len(tcalls)
    assert sizes == runs(segments, tcalls, CAP)
    assert len(sizes) <= tinfo["device_segments"]
    # the runs reach across segments: fewer calls than device segments
    if name == "all_device":
        assert len(sizes) < tinfo["device_segments"]
        assert max(sizes) > SEGMENT
    if name == "all_host":
        assert sizes == []


def test_pinned_gate_and_mesh_lanes_match_jax(stores, monkeypatch):
    """Two mesh lanes, each masking its own runs (the gate pinned on):
    the same candidates as the JAX package, and fewer mask calls than
    device segments."""
    jcfs, tcfs = stores
    monkeypatch.setattr(tds, "RUN_KEYS", CAP)
    calls = []
    real = tds.scan_mask

    def counted(keys, kop, qkeys):
        calls.append(int(keys.shape[0]))
        return real(keys, kop, qkeys)

    monkeypatch.setattr(tds, "scan_mask", counted)
    jp = jds.compile_predicate(jcfs.table,
                               [(jcfs.table.columns["v"], "<", 100)])
    tp = tds.compile_predicate(tcfs.table,
                               [(tcfs.table.columns["v"], "<", 100)])
    want, _ = jcfs.scan_filtered(jp, use_device=True)
    serial, sinfo = tcfs.scan_filtered(tp, use_device=True)
    for cfs in (jcfs, tcfs):
        cfs.mesh_devices_fn = lambda: 2
    del calls[:]
    meshed, minfo = tcfs.scan_filtered(tp, use_device=True)
    jmeshed, _ = jcfs.scan_filtered(jp, use_device=True)
    assert [pk for pk, _ in serial] == [pk for pk, _ in want]
    assert [pk for pk, _ in meshed] == [pk for pk, _ in want]
    assert [pk for pk, _ in jmeshed] == [pk for pk, _ in want]
    assert 0 < len(calls) < minfo["device_segments"]
    assert max(calls) <= CAP
