"""The port's tier-2 drills and checks (`cassandra_tpu_torch.scripts`)
on the CPU: the storage and streaming chaos drills, the flight
recorder, SLO, adaptive-controller and observatory checks each exit 0
with `--device cpu` and leave no fault point armed, and without a card
each raises; the wire stress smoke, timing-dependent on a loaded host,
is marked slow."""
from __future__ import annotations

import tempfile

import pytest
import torch

from cassandra_tpu_torch.scripts import (chaos_storage, chaos_streaming,
                                         check_controller,
                                         check_diagnostics,
                                         check_observatory, check_slo,
                                         stress)
from torch_tmp import tmp_path  # noqa: F401

DRILLS = [("chaos_storage", chaos_storage),
          ("chaos_streaming", chaos_streaming),
          ("check_diagnostics", check_diagnostics),
          ("check_slo", check_slo),
          ("check_controller", check_controller),
          ("check_observatory", check_observatory)]
IDS = [d[0] for d in DRILLS]


@pytest.mark.parametrize("name,mod", DRILLS, ids=IDS)
def test_drill_exits_zero_on_the_cpu(name, mod, tmp_path, monkeypatch):
    from cassandra_tpu_torch.utils import faultfs

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert mod.main(["--device", "cpu"]) == 0
    assert not faultfs.GLOBAL.active


def test_streaming_drill_puts_its_settings_back(tmp_path):
    from cassandra_tpu_torch.cluster.stream_session import StreamManager

    before = {k: getattr(StreamManager, k)
              for k in chaos_streaming.DRILL_STREAMING}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_streaming.run_drill(str(tmp_path))
    assert {k: getattr(StreamManager, k) for k in before} == before


@pytest.mark.slow
def test_stress_smoke_exits_zero_on_the_cpu(tmp_path, monkeypatch):
    """The wire drill's overload leg needs 16 client threads to overlap
    in flight against a cap of one; on a host loaded by other test
    workers they may not, and the drill then reports no shedding. It
    runs on the card in the smoke's phase 11."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert stress.main(["--smoke", "--device", "cpu"]) == 0


@pytest.mark.parametrize("name,mod", DRILLS, ids=IDS)
def test_drill_raises_without_a_card(name, mod, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
