"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode (``repro.kernels.ops``, as
``tests/test_fused_rbf.py`` runs them) and the ``repro.kernels.ref``
oracles, on the same numpy inputs, at rtol = atol = 1e-4 in f32
(``rbf_similarity`` at 1e-6 absolute; ``block_matmat`` at
1e-4 * max(1, max |ref|), against the default schedule only).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import (_build, block_matvec as bmv,
                                 flash_attention as fa,
                                 fused_rbf_matmat as frm, kmeans_assign as ka,
                                 ops, rbf_similarity as rbf)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _case(seed, n, m, d, b, zero_scales=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(m, d).astype(np.float32)
    V = rng.randn(m, b).astype(np.float32)
    rs = rng.uniform(0.1, 1.0, n).astype(np.float32)
    cs = rng.uniform(0.1, 1.0, m).astype(np.float32)
    if zero_scales:
        rs[::7] = 0.0
        cs[::5] = 0.0
    return x, y, V, rs, cs


# ---------------------------------------------------------------------------
# fused_rbf_matmat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d,b", [(37, 50, 3, 1), (64, 29, 5, 3),
                                     (100, 77, 4, 8)])
def test_fused_rbf_matches_jax(n, m, d, b):
    """Uneven sizes (no tile multiple anywhere) and zero scales."""
    x, y, V, rs, cs = _case(n + b, n, m, d, b)
    want = np.asarray(jops.fused_rbf_matmat(x, y, V, 0.9, rs, cs, bm=32,
                                            bn=32, interpret=True))
    got = ops.fused_rbf_matmat(_t(x), _t(y), _t(V), 0.9, _t(rs), _t(cs))
    assert got.shape == (n, b) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.fused_rbf_matmat(x, y, V, 0.9, rs, cs)),
        **TOL)


def test_fused_rbf_isolated_point():
    """A point whose off-diagonal similarity underflows contributes only
    its self-similarity (1): its output row is its own V row."""
    x, _, V, _, _ = _case(3, 40, 40, 4, 3, zero_scales=False)
    x[7] = 1e4
    ones = np.ones(40, np.float32)
    want = np.asarray(jops.fused_rbf_matmat(x, x, V, 1.0, ones, ones,
                                            bm=32, bn=32, interpret=True))
    got = ops.fused_rbf_matmat(_t(x), _t(x), _t(V), 1.0).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[7], V[7], **TOL)


def test_fused_rbf_default_scales_are_ones():
    x, y, V, _, _ = _case(4, 20, 30, 3, 2)
    a = ops.fused_rbf_matmat(_t(x), _t(y), _t(V), 1.3)
    b = ops.fused_rbf_matmat(_t(x), _t(y), _t(V), 1.3, torch.ones(20),
                             torch.ones(30))
    assert torch.equal(a, b)


def test_inv_two_sigma_sq_rounds_in_f32():
    s = np.float32(0.7)
    assert frm.inv_two_sigma_sq(0.7) == float(
        np.float32(1.0) / (np.float32(2.0) * s * s))


# ---------------------------------------------------------------------------
# fused_nystrom_matmat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,b", [(50, 137, 3), (128, 128, 1), (1, 200, 8)])
def test_fused_nystrom_matches_jax(m, n, b):
    rng = np.random.RandomState(m + n)
    x = rng.randn(m, 5).astype(np.float32)
    y = rng.randn(n, 5).astype(np.float32)
    V = rng.randn(n, b).astype(np.float32)
    cs = np.abs(rng.randn(n)).astype(np.float32)
    O_j, deg_j = jops.fused_nystrom_matmat(x, y, V, 0.9, cs, interpret=True)
    O, deg = ops.fused_nystrom_matmat(_t(x), _t(y), _t(V), 0.9, _t(cs))
    assert O.shape == (m, b) and deg.shape == (m,)
    np.testing.assert_allclose(O.numpy(), np.asarray(O_j), **TOL)
    np.testing.assert_allclose(deg.numpy(), np.asarray(deg_j), **TOL)


def test_fused_nystrom_masks_product_and_degree_separately():
    """Scale 0 with valid 1 (an isolated training point) still counts
    toward the degree; valid 0 rows count toward neither output."""
    rng = np.random.RandomState(1)
    x = rng.randn(40, 3).astype(np.float32)
    y = rng.randn(96, 3).astype(np.float32)
    V = rng.randn(96, 2).astype(np.float32)
    cs = rng.uniform(0.1, 1.0, 96).astype(np.float32)
    cv = np.ones(96, np.float32)
    cs[::4] = 0.0
    cv[::6] = 0.0
    cs[::6] = 0.0
    O_j, deg_j = jref.fused_nystrom_matmat(x, y, V, 1.0, cs, cv)
    O, deg = ops.fused_nystrom_matmat(_t(x), _t(y), _t(V), 1.0, _t(cs),
                                      _t(cv))
    np.testing.assert_allclose(O.numpy(), np.asarray(O_j), **TOL)
    np.testing.assert_allclose(deg.numpy(), np.asarray(deg_j)[:, 0], **TOL)


# ---------------------------------------------------------------------------
# kmeans_assign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,d", [(1, 3, 2), (300, 8, 8), (513, 5, 3)])
def test_kmeans_assign_matches_jax(n, k, d):
    rng = np.random.RandomState(n)
    p = rng.randn(n, d).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    idx_j, dist_j = jops.kmeans_assign(jnp.asarray(p), jnp.asarray(c),
                                       interpret=True)
    idx, dist = ops.kmeans_assign(_t(p), _t(c))
    assert idx.dtype == torch.int64 and dist.shape == (n,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), **TOL)


def test_kmeans_assign_ties_go_to_lowest_index():
    rng = np.random.RandomState(2)
    p = rng.randn(50, 4).astype(np.float32)
    c = rng.randn(3, 4).astype(np.float32)
    c = np.concatenate([c[:1], c, c]).astype(np.float32)  # dupes of 0,1,2
    idx_j, _ = jref.kmeans_assign(jnp.asarray(p), jnp.asarray(c))
    idx, _ = ops.kmeans_assign(_t(p), _t(c))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert int(idx.max()) <= 3        # never a later duplicate
    zero, _ = ops.kmeans_assign(torch.zeros(5, 4), torch.zeros(6, 4))
    assert zero.tolist() == [0] * 5


# ---------------------------------------------------------------------------
# rbf_similarity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d", [(37, 50, 3), (130, 77, 5), (1, 9, 2),
                                   (128, 128, 33)])
def test_rbf_similarity_matches_jax(n, m, d):
    """Ragged shapes (the JAX wrapper pads to 128-tiles, the port does
    not); the f32-rounded 1 / (2 sigma^2) as in the Pallas kernel."""
    x, y, _, _, _ = _case(n * m + d, n, m, d, 1)
    x[0] = 50.0                             # far point: entries underflow
    want = np.asarray(jops.rbf_similarity(x, y, 1.7, interpret=True))
    got = ops.rbf_similarity(_t(x), _t(y), 1.7)
    assert got.shape == (n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.rbf_similarity(x, y, 1.7)), rtol=0,
        atol=1e-6)


def test_rbf_similarity_diagonal_is_near_one():
    x, _, _, _, _ = _case(5, 64, 1, 8, 1)
    S = ops.rbf_similarity(_t(x), _t(x), 0.5).numpy()
    want = np.asarray(jops.rbf_similarity(x, x, 0.5, interpret=True))
    np.testing.assert_array_equal(np.diag(S) > 0.999, True)
    np.testing.assert_allclose(np.diag(S), np.diag(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# block_matmat / block_matvec
# ---------------------------------------------------------------------------

def _block_tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("n,m,b", [(37, 50, 1), (300, 600, 8),
                                   (129, 513, 64), (20, 7, 70)])
def test_block_matmat_matches_jax(n, m, b):
    rng = np.random.RandomState(n + m + b)
    A = rng.rand(n, m).astype(np.float32)
    V = rng.randn(m, b).astype(np.float32)
    want = np.asarray(jops.block_matmat(A, V, interpret=True))
    ref = np.asarray(jref.block_matmat(A, V))
    got = ops.block_matmat(_t(A), _t(V)).numpy()
    assert got.shape == (n, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=_block_tol(want))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_block_tol(ref))
    v_want = np.asarray(jops.block_matvec(A, V[:, 0], interpret=True))
    v_got = ops.block_matvec(_t(A), _t(V[:, 0])).numpy()
    assert v_got.shape == (n,)
    np.testing.assert_allclose(v_got, v_want, rtol=0,
                               atol=_block_tol(v_want))


def test_wide_blocks_split_into_kernel_widths(monkeypatch):
    """ops splits a block wider than one launch takes into column groups;
    the result is the product of the whole block."""
    widths = []
    plain = bmv.block_matmat

    def spy(A, V):
        widths.append(V.shape[1])
        return plain(A, V)

    monkeypatch.setattr(bmv, "block_matmat", spy)
    A, V = torch.randn(9, 11), torch.randn(11, 150)
    torch.testing.assert_close(ops.block_matmat(A, V), A @ V)
    assert widths == [64, 64, 22]


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_input():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="must be"):
        frm.fused_rbf_matmat(x, torch.zeros(5, 2), torch.zeros(5, 1), 1.0,
                             torch.ones(4), torch.ones(5))
    with pytest.raises(ValueError, match="row_scale"):
        frm.fused_rbf_matmat(x, x, torch.zeros(4, 1), 1.0, torch.ones(3),
                             torch.ones(4))
    with pytest.raises(TypeError, match="float32"):
        frm.fused_rbf_matmat(x.double(), x, torch.zeros(4, 1), 1.0,
                             torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="centers"):
        ka.kmeans_assign(x, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="must be"):
        rbf.rbf_similarity(x, torch.zeros(5, 2), 1.0)
    with pytest.raises(TypeError, match="float32"):
        rbf.rbf_similarity(x.double(), x.double(), 1.0)
    with pytest.raises(ValueError, match="must be"):
        bmv.block_matmat(x, torch.zeros(4, 2))
    with pytest.raises(TypeError, match="float32"):
        bmv.block_matmat(x, torch.zeros(3, 2, dtype=torch.float64))
    q4 = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention(q4, torch.zeros(1, 2, 8, 8),
                           torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q4, torch.zeros(1, 3, 8, 16),
                           torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q4.half(), q4.half(), q4.half())


def test_cpu_calls_run_the_plain_version_and_launch_nothing():
    counters = [frm.fused_rbf_matmat, frm.fused_nystrom_matmat,
                ka.kmeans_assign, rbf.rbf_similarity, bmv.block_matmat,
                fa.flash_attention]
    before = [f.launches for f in counters]
    x = torch.randn(9, 3)
    got = ops.fused_rbf_matmat(x, x, torch.ones(9, 2), 1.0)
    assert torch.equal(got, frm.fused_rbf_matmat_plain(
        x, x, torch.ones(9, 2), 1.0, torch.ones(9), torch.ones(9)))
    ops.fused_nystrom_matmat(x, x, torch.ones(9, 2), 1.0, torch.ones(9))
    ops.kmeans_assign(x, x[:2])
    assert torch.equal(ops.rbf_similarity(x, x, 1.0),
                       rbf.rbf_similarity_plain(x, x, 1.0))
    assert torch.equal(ops.block_matmat(x, x.T), x @ x.T)
    q = torch.randn(1, 2, 9, 64)
    assert torch.equal(ops.flash_attention(q, q, q),
                       fa.flash_attention_plain(q, q, q))
    assert [f.launches for f in counters] == before


def test_every_kernel_source_is_declared():
    """Each C entry point's library has a source, and library names carry
    a digest of source and flags (an edit forces a rebuild)."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and p.name.startswith(name + "-")
        assert p == _build.library_path(name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
