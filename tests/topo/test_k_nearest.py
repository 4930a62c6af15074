"""k-nearest extraction (topo/models.py::k_smallest) against a numpy argsort
over a grid of sizes: ascending distances, the lowest index first among
ties, and padding past the last finite distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmdlmc_tpu.topo.models import k_smallest

GRID = [(n, k) for n in (4, 16, 64, 144, 300, 1152) for k in (1, 3, 4, 8, 16)
        if k < n]


def reference(d, k):
    """Stable argsort: equal distances keep the lower index first."""
    idx = np.argsort(d, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(d, idx, axis=-1), idx


@pytest.mark.parametrize("n,k", GRID)
def test_matches_numpy_argsort(n, k):
    rng = np.random.RandomState(n * 100 + k)
    d = rng.uniform(1.0, 9.0, size=(n, n)).astype(np.float32)
    np.fill_diagonal(d, np.inf)
    dist, idx = jax.jit(lambda x: k_smallest(x, k))(jnp.asarray(d))
    want_d, want_i = reference(d, k)
    np.testing.assert_array_equal(np.asarray(dist), want_d)
    np.testing.assert_array_equal(np.asarray(idx), want_i)


def test_ties_take_the_lowest_index():
    """A cubic lattice has many equal distances: the order among them is by
    index, as lax.top_k orders them."""
    g = np.array([[i, j, m] for i in range(4) for j in range(4)
                  for m in range(4)], np.float32)
    d = np.sqrt(((g[:, None] - g[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    dist, idx = k_smallest(jnp.asarray(d), 6)
    want_d, want_i = reference(d, 6)
    np.testing.assert_array_equal(np.asarray(idx), want_i)
    neg, top = jax.lax.top_k(-jnp.asarray(d), 6)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(top))


def test_rows_with_fewer_than_k_finite_entries():
    """Masked (infinite) entries come last with an infinite distance, so a
    caller's ``isfinite`` mask drops exactly them."""
    d = np.full((5, 5), np.inf, np.float32)
    d[0, 1], d[0, 3] = 2.0, 1.0
    d[2, 4] = 3.0
    dist, idx = k_smallest(jnp.asarray(d), 3)
    dist, idx = np.asarray(dist), np.asarray(idx)
    np.testing.assert_array_equal(dist[0], [1.0, 2.0, np.inf])
    np.testing.assert_array_equal(idx[0, :2], [3, 1])
    np.testing.assert_array_equal(np.isfinite(dist).sum(axis=1), [2, 0, 1, 0, 0])


def test_large_k_uses_one_sort():
    rng = np.random.RandomState(1)
    d = rng.uniform(1.0, 9.0, size=(64, 64)).astype(np.float32)
    dist, idx = k_smallest(jnp.asarray(d), 40)
    want_d, want_i = reference(d, 40)
    np.testing.assert_array_equal(np.asarray(dist), want_d)
    np.testing.assert_array_equal(np.asarray(idx), want_i)
