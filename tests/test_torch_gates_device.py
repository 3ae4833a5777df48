"""The port's device tools (`cassandra_tpu_torch.scripts.
device_accounting`, `prof_device`): each raises without a card and runs
at a tiny size on the CPU, where no byte crosses a link."""
from __future__ import annotations

import json
import tempfile

import pytest
import torch

from cassandra_tpu_torch.ops import cuda_lib
from cassandra_tpu_torch.scripts import device_accounting, prof_device
from torch_tmp import tmp_path  # noqa: F401


@pytest.mark.parametrize("mod", [device_accounting, prof_device],
                         ids=["device_accounting", "prof_device"])
def test_raises_without_a_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_device_accounting_tiny_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert device_accounting.main(["--device", "cpu",
                                   "--cells-per-run", "2048"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["cells_per_run"] == 2048
    assert out["link"] is None            # no link on the CPU
    assert out["native_mib_s"] > 0 and out["device_mib_s"] > 0
    # the device engine's round ran its phases
    assert "device" in out["device_phases"]


def test_transfer_points_count_nothing_on_the_cpu():
    """The counters move only for copies to and from a card."""
    from cassandra_tpu_torch.ops import merge as dmerge
    import numpy as np

    cuda_lib.reset_transfers()
    t = dmerge.host_to_device(np.arange(8, dtype=np.int32), "cpu")
    dmerge.device_to_host(t)
    assert cuda_lib.transfers() == {"h2d": {"copies": 0, "bytes": 0},
                                    "d2h": {"copies": 0, "bytes": 0}}


def test_prof_device_tiny_on_the_cpu(capsys):
    rows = prof_device.run("cpu", cells=2048, rounds=2)
    assert [r["device_ms"] for r in rows] == [None, None]
    assert all(r["mode"] in ("fast", "v2") for r in rows)
    assert rows[0]["kept"] == rows[1]["kept"] > 0
    assert prof_device.main(["--device", "cpu", "--cells", "1024"]) == 0
    assert "merge.plane_" in capsys.readouterr().out
