"""The frozen cost copy against hand-worked shapes, and against the
program's own arithmetic at the commit it was copied from."""
import pytest

import _paths  # noqa: F401
from harness import costs

K = 13


def test_hand_worked_bytes():
    # K1 at 1,024 rows: (13 lanes + valid + ts_h + ts_l) * 4 B read,
    # a 4 B permutation entry written
    assert costs.sort_perm(1024, K) == (1024 * 68, 0)
    # K2: 13 lanes, 9 columns, the permutation, one packed byte
    assert costs.reconcile(1024, K) == (1024 * (52 + 36 + 4 + 1), 0)
    # K4 on a full segment: 25 B a cell in, 25 B out, 40 B of stats
    assert costs.meta_block(65536, K) == (65536 * 50 + 40, 0)
    # K5: META 25 B and 52 B of lanes a row scanned, 73 distances
    n = 65536
    scanned = 77 * n
    assert costs.segment_scan(n, K) == (25 * n + 2 * 52 * n + 8 * scanned,
                                        4 * 73 * scanned)


@pytest.mark.parametrize("kernel, rows", [
    ("merge.sort_perm", 1 << 19), ("merge.reconcile", 1 << 19),
    ("write.compact_gather", 1 << 19), ("write.meta_block", 65536),
    ("write.segment_scan", 65536)])
def test_copy_matches_the_programs_arithmetic(kernel, rows):
    from cassandra_tpu_torch.ops import costs as port
    want = {"merge.sort_perm": lambda: port.sort_perm(rows, K),
            "merge.reconcile": lambda: port.reconcile(rows, K),
            "write.compact_gather": lambda: port.compact_gather(rows, K),
            "write.meta_block": lambda: port.meta_block(rows),
            "write.segment_scan": lambda: port.segment_scan(
                25 * rows, 4 * K * rows, 73)}[kernel]()
    assert costs.KERNELS[kernel](rows, K) == want


def test_least_seconds_takes_the_binding_roof():
    t, bound = costs.least_seconds("merge.sort_perm", 1 << 20, K)
    assert bound == "bytes"
    assert t == pytest.approx((1 << 20) * 68 / 3.35e12)
    t, bound = costs.least_seconds("write.segment_scan", 65536, K)
    assert bound == "ops"
    assert t == pytest.approx(4 * 73 * 77 * 65536 / 67e12)
