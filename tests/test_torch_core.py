"""The port's core numerics (``repro_torch.core``) against ``repro.core``.

Same numpy inputs through both packages on the CPU: similarity and the
median bandwidth, the Laplacian scaling, Lanczos (single-vector and
block) with the JAX start block injected, k-means++ seeding and Lloyd
k-means with the JAX start centers injected.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (kmeans as jkm, lanczos as jlz, laplacian as jlp,
                        similarity as jsim)
from repro.data import synthetic
from repro.distrib import mesh_utils
from repro_torch.core import (kmeans as km, lanczos as lz, laplacian as lp,
                              seeding, similarity as sim)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _sign_aligned(got, want):
    """Flip each column of ``got`` to the sign of ``want``'s."""
    s = np.sign(np.sum(got * want, axis=0))
    return got * np.where(s == 0, 1.0, s)[None, :]


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------

def test_pairwise_and_rbf_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(30, 4).astype(np.float32)
    y = rng.randn(20, 4).astype(np.float32)
    np.testing.assert_allclose(sim.pairwise_sq_dists(_t(x), _t(y)).numpy(),
                               np.asarray(jsim.pairwise_sq_dists(x, y)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sim.rbf_kernel(_t(x), _t(y), 1.3).numpy(),
                               np.asarray(jsim.rbf_kernel(x, y, 1.3)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1100, 34])
def test_median_sigma_matches_jax(n):
    """1024 sampled points give 523,776 pairs, an even count: the median
    is the mean of the two middle values (34 points: 561 pairs, odd)."""
    x, _ = synthetic.blobs(n, 3, dim=5, spread=0.8, seed=n)
    got = float(sim.median_sigma(_t(x)))
    want = float(jsim.median_sigma(jnp.asarray(x)))
    assert abs(got - want) <= 1e-6 * want


def test_median_sigma_averages_the_middle_pair():
    x = _t([[0.0], [1.0], [3.0], [7.0]])       # 6 pair distances
    d2 = sorted([1.0, 9.0, 49.0, 4.0, 36.0, 16.0])
    want = np.sqrt((d2[2] + d2[3]) / 2 + 1e-12)
    assert abs(float(sim.median_sigma(x)) - want) < 1e-6


# ---------------------------------------------------------------------------
# Laplacian scaling
# ---------------------------------------------------------------------------

def test_masked_inv_sqrt_and_dense_shifted_matrix_match_jax():
    x, _ = synthetic.blobs(40, 3, dim=3, spread=0.8, seed=1)
    S = np.array(jsim.rbf_kernel(x, x, 1.0))
    S[:, -5:] = 0.0
    S[-5:, :] = 0.0                          # five zero-degree rows
    valid = np.ones(40, np.float32)
    valid[-5:] = 0.0
    deg = S @ valid
    got = lp.masked_inv_sqrt(_t(deg)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlp.masked_inv_sqrt(deg)),
                               rtol=1e-6)
    assert np.all(got[-5:] == 0.0)
    np.testing.assert_allclose(
        lp.dense_shifted_matrix(_t(S), _t(valid)).numpy(),
        np.asarray(jlp.dense_shifted_matrix(jnp.asarray(S),
                                            jnp.asarray(valid))),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Lanczos, start block injected: the two recurrences are the same
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shifted():
    """The shifted operator of 120 blobs points at the median-heuristic
    bandwidth: its top eigenvalues are well separated, so the Ritz
    vectors are defined up to sign."""
    x, _ = synthetic.blobs(120, 3, dim=4, spread=0.8, seed=0)
    sigma = jsim.median_sigma(jnp.asarray(x))
    S = np.asarray(jsim.rbf_kernel(x, x, sigma), np.float32)
    valid = np.ones(120, np.float32)
    return np.asarray(jlp.dense_shifted_matrix(jnp.asarray(S),
                                               jnp.asarray(valid)))


@pytest.mark.parametrize("b,steps", [(1, 30), (4, 8)])
def test_block_lanczos_matches_jax(shifted, b, steps):
    n, k = shifted.shape[0], 3
    V0 = np.random.RandomState(b).randn(b, n).astype(np.float32)
    A_j, A_t = jnp.asarray(shifted), _t(shifted)
    key = jax.random.PRNGKey(0)
    st_j = jlz.block_lanczos(lambda V: A_j @ V, n, steps, key,
                             block_size=b, V0=jnp.asarray(V0))
    vals_j, vecs_j = jlz.block_topk_of_shifted(st_j, k)
    st = lz.block_lanczos(lambda V: A_t @ V, n, steps, block_size=b, V0=V0)
    vals, vecs = lz.block_topk_of_shifted(st, k)
    assert st.step == steps and int(st_j.step) == steps
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), atol=1e-4)
    np.testing.assert_allclose(_sign_aligned(vecs.numpy(),
                                             np.asarray(vecs_j)),
                               np.asarray(vecs_j), atol=1e-3)
    # the recurrence's eigenvalues are the operator's
    ev = np.linalg.eigvalsh(shifted.astype(np.float64))[::-1][:k]
    np.testing.assert_allclose(vals.numpy(), 2.0 - ev, atol=1e-4)


def test_single_vector_lanczos_matches_jax(shifted):
    n, k, steps = shifted.shape[0], 3, 30
    v0 = np.random.RandomState(7).randn(n).astype(np.float32)
    A_j, A_t = jnp.asarray(shifted), _t(shifted)
    st_j = jlz.lanczos(lambda v: A_j @ v, n, steps, jax.random.PRNGKey(0),
                       v0=jnp.asarray(v0))
    vals_j, vecs_j = jlz.topk_of_shifted(st_j, k)
    st = lz.lanczos(lambda v: A_t @ v, n, steps, v0=v0)
    vals, vecs = lz.topk_of_shifted(st, k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), atol=1e-4)
    np.testing.assert_allclose(_sign_aligned(vecs.numpy(),
                                             np.asarray(vecs_j)),
                               np.asarray(vecs_j), atol=1e-3)


def test_qr_pos_zeroes_dependent_columns():
    U = torch.randn(10, 3)
    U[:, 2] = 0.0
    Q, R = lz._qr_pos(U)
    assert torch.all(torch.diagonal(R) >= 0)
    assert float(Q[:, 2].abs().max()) == 0.0
    np.testing.assert_allclose((Q.T @ Q)[:2, :2].numpy(), np.eye(2),
                               atol=1e-5)


def test_random_start_needs_a_generator():
    with pytest.raises(ValueError, match="generator"):
        lz.init_block_state(10, 2, 2)
    g = torch.Generator().manual_seed(0)
    st = lz.init_block_state(10, 2, 2, generator=g)
    np.testing.assert_allclose((st.V[:2] @ st.V[:2].T).numpy(), np.eye(2),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _embedding(n=200, k=4, seed=3):
    x, truth = synthetic.blobs(n, k, dim=k, spread=0.3, seed=seed)
    Y = np.asarray(jkm.normalize_rows(jnp.asarray(x)))
    return Y, truth


def test_normalize_rows_matches_jax():
    rng = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    rng[2] = 0.0
    np.testing.assert_allclose(km.normalize_rows(_t(rng)).numpy(),
                               np.asarray(jkm.normalize_rows(rng)),
                               rtol=1e-6)


def test_distributed_kmeans_matches_jax_from_injected_centers():
    Y, _ = _embedding()
    valid = np.ones(Y.shape[0], np.float32)
    valid[-3:] = 0.0
    c0 = Y[[0, 1, 2, 3]] + 0.05
    mesh = mesh_utils.local_mesh("rows")
    labels_j, st_j = jkm.distributed_kmeans(
        jnp.asarray(Y), jnp.asarray(valid), 4, jax.random.PRNGKey(0), mesh,
        iters=50, centers0=jnp.asarray(c0))
    g = torch.Generator().manual_seed(0)
    labels, st = km.distributed_kmeans(_t(Y), _t(valid), 4, g, iters=50,
                                       centers0=c0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_j))
    np.testing.assert_allclose(st.centers.numpy(), np.asarray(st_j.centers),
                               atol=1e-5)
    assert st.it < 50                 # the shift < tol freeze stopped it


def test_kmeans_plusplus_draws_only_weighted_rows():
    Y, _ = _embedding()
    w = np.zeros(Y.shape[0], np.float32)
    w[::10] = 1.0
    g = torch.Generator().manual_seed(5)
    C = seeding.kmeans_plusplus_init(_t(Y), 4, g, weights=_t(w)).numpy()
    allowed = Y[w > 0]
    for c in C:
        assert np.min(np.abs(allowed - c).sum(1)) == 0.0
    assert len({tuple(c) for c in C}) == 4        # D^2 never redraws a center
    # same generator seed -> same centers
    g2 = torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(
        seeding.kmeans_plusplus_init(_t(Y), 4, g2, weights=_t(w)).numpy(), C)


def test_kmeans_plusplus_handles_coincident_points():
    y = torch.zeros(6, 2)
    C = seeding.kmeans_plusplus_init(y, 3, torch.Generator().manual_seed(0))
    assert torch.equal(C, torch.zeros(3, 2))
