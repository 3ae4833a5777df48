"""K10 (exact vector search: every row's score, then the top k) of the
PyTorch/CUDA port against the JAX package's `VectorIndex.ann` (a matmul
and `lax.top_k` on the CPU), on the same numpy matrix and query from a
seed. The indices (hence the keys) must be identical. The scores agree
within SCORE_TOL: XLA on the CPU and torch sum the products in another
order, and for cosine the JAX package normalises each row before the
product where the port divides the product by the row's norm, so the
last bits of a float32 score differ. The port's wrapper gets CPU
tensors here and runs the plain PyTorch version."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cassandra_tpu.index.manager import VectorIndex as JVectorIndex

from cassandra_tpu_torch.index.manager import VectorIndex as TVectorIndex
from cassandra_tpu_torch.ops import ann as tann

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _index(cls, m: np.ndarray, **attrs):
    """A VectorIndex whose gathered (matrix, keys) is `m` and one key
    per row: the ANN step alone, without a store behind it."""
    idx = object.__new__(cls)
    keys = [(b"pk%d" % i, b"ck%d" % i) for i in range(len(m))]
    idx._gather = lambda: (m, keys)
    idx.__dict__.update(attrs)
    return idx, keys


def _both(m, q, k, sim):
    jidx, keys = _index(JVectorIndex, m)
    tidx, _ = _index(TVectorIndex, m, device="cpu", _device_cache=None)
    return jidx.ann(q, k, sim), tidx.ann(q, k, sim), keys


@pytest.mark.parametrize("sim", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("k", [1, 10, None])
@pytest.mark.parametrize("n,d", [(300, 16), (97, 7)])
def test_ann_matches_jax(sim, k, n, d):
    rng = np.random.default_rng(n * d)
    m = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    k = n if k is None else k
    want, got, _ = _both(m, q, k, sim)
    assert len(got) == len(want) == k
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               **SCORE_TOL)
    scores = [g[2] for g in got]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("sim", ["cosine", "dot", "euclidean"])
def test_equal_scores_keep_the_lower_index_first(sim):
    """Rows repeated exactly give bit-equal scores: both packages put
    the lower index first (lax.top_k's order), also across the k-th
    place, where only some of the tied rows fit."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    m = base[[2, 0, 1, 2, 3, 0, 2, 1, 3, 2]]
    q = base[2] + np.float32(0.25)
    want, got, keys = _both(m, q, 5, sim)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    top = [keys.index(g[:2]) for g in got]
    ties = [i for i in range(len(m)) if (m[i] == m[top[0]]).all()]
    assert top[:len(ties)] == ties           # every copy, in index order


def test_top_k_of_more_than_n_and_of_nothing():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((6, 4)).astype(np.float32)
    q = np.ones(4, dtype=np.float32)
    want, got, _ = _both(m, q, 50, "dot")
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 6
    empty = np.zeros((0, 4), dtype=np.float32)
    assert _both(empty, q, 3, "cosine")[1] == []


@pytest.mark.parametrize("k", [0, -1])
def test_no_row_for_a_limit_below_one(k):
    """LIMIT 0 gives no row, as `lax.top_k(scores, 0)` does in the JAX
    package; a negative k gives none too (`lax.top_k` rejects it). The
    wrapper itself takes only 1 <= k <= n, on the CPU as on the card."""
    rng = np.random.default_rng(4)
    m = rng.standard_normal((20, 5)).astype(np.float32)
    q = rng.standard_normal(5).astype(np.float32)
    tidx, _ = _index(TVectorIndex, m, device="cpu", _device_cache=None)
    assert tidx.ann(q, k, "dot") == []
    if k == 0:
        jidx, _ = _index(JVectorIndex, m)
        assert jidx.ann(q, k, "dot") == []
    for bad in (k, len(m) + 1):
        with pytest.raises(ValueError, match="outside 1..20"):
            tann.ann_topk(torch.from_numpy(m), torch.from_numpy(q), bad,
                          "dot")


def test_plain_version_and_wrapper():
    rng = np.random.default_rng(9)
    m = torch.from_numpy(rng.standard_normal((50, 12)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    for sim in tann.SIMILARITIES:
        s, i = tann.ann_topk(m, q, 7, sim)
        assert i.dtype == torch.int32 and s.dtype == torch.float32
        full = tann.scores_plain(m, q, sim)
        assert torch.equal(s, full[i.long()])
        assert torch.equal(i, torch.topk(full, 7).indices.to(torch.int32))
    with pytest.raises(ValueError, match="unknown similarity"):
        tann.ann_topk(m, q, 3, "manhattan")
    # -0.0 counts as +0.0
    z = tann.scores_plain(torch.zeros(2, 3), torch.ones(3), "dot")
    assert not torch.signbit(z).any()


def test_index_resolves_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device launches")
    m = np.ones((3, 4), dtype=np.float32)
    tidx, _ = _index(TVectorIndex, m, device=None, _device_cache=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidx.ann(np.ones(4, dtype=np.float32), 2)
