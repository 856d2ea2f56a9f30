"""The port's dense family (``dense``, ``knn-topt``, ``precomputed``), the
``eigh`` oracle and ``save``/``load``, against ``repro`` on the CPU.

* ``sparsify_topt`` exactly, ties included;
* the dense Laplacian pieces and the three affinities' operators by
  ``matmat`` output (1e-5), and ``eigh`` by eigenvalues (1e-5);
* whole fits of the three affinities with ``block-lanczos`` and ``eigh``,
  the JAX start block and the JAX k-means++ picks injected (ARI >= 0.99
  against the JAX fit);
* models saved by either package load in the other and predict the same
  labels; what the port cannot honour raises on ``load``; a
  ``precomputed`` fit refuses ``transform`` and ``save``.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import SpectralClustering as JaxSC
from repro.cluster.affinity import AFFINITIES as JAX_AFFINITIES
from repro.cluster.eigensolvers import eigh_solver as jax_eigh
from repro.core import (laplacian as jlp, seeding as jseed,
                        similarity as jsim)
from repro.data import synthetic
from repro.distrib import mesh_utils
from repro_torch import SpectralClustering, ari
from repro_torch.cluster.affinity import AFFINITIES
from repro_torch.cluster.affinity import build_fused_rbf_operator
from repro_torch.cluster.eigensolvers import eigh_solver
from repro_torch.core import kmeans as km, lanczos as lz, laplacian as lp
from repro_torch.core import similarity as sim
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
AFFINITY_NAMES = ("dense", "knn-topt", "precomputed")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def _points(n=160, k=3, seed=0):
    return synthetic.blobs(n, k, dim=4, spread=0.8, seed=seed)


def _similarity(x, sigma):
    return np.array(jsim.rbf_kernel(x, x, sigma), np.float32)


# ---------------------------------------------------------------------------
# sparsify_topt
# ---------------------------------------------------------------------------

def _tied(n=48, seed=0):
    """A symmetric matrix of a few distinct values: every row has ties
    at its top-t threshold."""
    rng = np.random.RandomState(seed)
    S = rng.randint(0, 4, size=(n, n)).astype(np.float32) / 4.0
    return np.maximum(S, S.T)


@pytest.mark.parametrize("case,t", [("rbf", 5), ("rbf", 1), ("tied", 3),
                                    ("tied", 7), ("rbf", 500)])
def test_sparsify_topt_matches_jax_exactly(case, t):
    if case == "rbf":
        x, _ = _points()
        S = _similarity(x, 1.0)
    else:
        S = _tied()
    want = np.asarray(jsim.sparsify_topt(jnp.asarray(S), t))
    St = _t(S)
    assert sim.sparsify_topt_(St, t) is St            # in place
    np.testing.assert_array_equal(St.numpy(), want)


def test_sparsify_topt_tiles_cover_a_ragged_matrix(monkeypatch):
    """Chunks smaller than the matrix (and not dividing it) give the same
    graph as one chunk."""
    S = _tied(50, seed=1) + np.eye(50, dtype=np.float32)
    want = np.asarray(jsim.sparsify_topt(jnp.asarray(S), 4))
    monkeypatch.setattr(sim, "SPARSIFY_CHUNK", 16)
    np.testing.assert_array_equal(sim.sparsify_topt_(_t(S), 4).numpy(), want)


# ---------------------------------------------------------------------------
# dense Laplacian pieces and operators
# ---------------------------------------------------------------------------

def test_dense_laplacian_pieces_match_jax():
    x, _ = _points()
    S = _similarity(x, 1.0)
    S[:, 3] = S[3, :] = 0.0                  # a zero-degree row
    valid = np.ones(S.shape[0], np.float32)
    V = np.random.RandomState(0).randn(S.shape[0], 5).astype(np.float32)
    mm_j, inv_j = jlp.make_dense_operator(jnp.asarray(S), jnp.asarray(valid))
    mm, inv = lp.make_dense_operator(_t(S), _t(valid))
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), **TOL)
    np.testing.assert_allclose(mm(_t(V)).numpy(), np.asarray(mm_j(V)), **TOL)
    # with every row valid it is JAX's unmasked shifted product
    shifted_j = jlp.make_dense_shifted_matmat(jnp.asarray(S),
                                              jlp.dense_degrees(S))
    np.testing.assert_allclose(mm(_t(V)).numpy(), np.asarray(shifted_j(V)),
                               **TOL)


def _operators(name, n=160, sigma=1.3):
    x, _ = _points(n)
    arg = _similarity(x, sigma) if name == "precomputed" else x
    est_j = JaxSC(3, affinity=name)
    op_j = JAX_AFFINITIES.get(name)(est_j, jnp.asarray(arg), sigma,
                                    mesh_utils.local_mesh("rows"))
    est = SpectralClustering(3, affinity=name, device="cpu")
    op = AFFINITIES.get(name)(est, _t(arg), sigma)
    return est_j, op_j, est, op


@pytest.mark.parametrize("name", AFFINITY_NAMES)
def test_dense_family_operator_matches_jax(name):
    _, op_j, _, op = _operators(name)
    assert op_j.n_pad == op.n                       # one device: no pad
    V = np.random.RandomState(2).randn(op.n, 4).astype(np.float32)
    np.testing.assert_allclose(op.matmat(_t(V)).numpy(),
                               np.asarray(op_j.matmat(jnp.asarray(V))), **TOL)
    np.testing.assert_allclose(op.matvec(_t(V[:, 0])).numpy(),
                               np.asarray(op_j.matvec(jnp.asarray(V[:, 0]))),
                               **TOL)
    np.testing.assert_allclose(op.inv_sqrt.numpy(), np.asarray(op_j.inv_sqrt),
                               **TOL)
    np.testing.assert_allclose(op.materialize().numpy(),
                               np.asarray(op_j.materialize()), **TOL)


def test_materialize_from_matmat_blocks_matches_the_dense_oracle():
    """Without ``dense``, identity blocks through ``matmat`` (width 128,
    wider than one fused kernel launch) give the exact A."""
    x, _ = _points(200)
    op = build_fused_rbf_operator(_t(x), 1.1)
    assert op.dense is None
    want = lp.dense_shifted_matrix(sim.rbf_kernel(_t(x), _t(x), 1.1),
                                   op.valid)
    np.testing.assert_allclose(op.materialize().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", AFFINITY_NAMES)
def test_eigh_matches_jax(name):
    est_j, op_j, est, op = _operators(name)
    vals_j, Z_j, info_j = jax_eigh(est_j, op_j, jax.random.PRNGKey(0))
    vals, Z, info = eigh_solver(est, op, None)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), **TOL)
    assert info == info_j == {"solver": "eigh", "matrix_passes": op.n}
    assert Z.shape == (op.n, 3)


def test_precomputed_rejects_a_non_square_matrix():
    with pytest.raises(ValueError, match="square"):
        SpectralClustering(2, affinity="precomputed",
                           device="cpu").fit(np.zeros((4, 3)))


# ---------------------------------------------------------------------------
# whole fits, JAX starts injected
# ---------------------------------------------------------------------------

K, N_FIT = 4, 300
FIT_KW = dict(lanczos_steps=64, sigma=1.5, seed=0)


@pytest.fixture(scope="module")
def fit_data():
    return synthetic.blobs(N_FIT + 100, K, dim=6, spread=0.5, seed=2)


def _inject(monkeypatch, jax_est, n, block_size):
    """Make the port's fit start where the JAX fit started: JAX's start
    block, and the rows JAX's k-means++ picked (taken from the port's own
    embedding, so eigenvector signs do not matter)."""
    _, k_lan, k_km = jax.random.split(jax.random.PRNGKey(FIT_KW["seed"]), 3)
    V0 = np.array(jax.random.normal(k_lan, (block_size, n), jnp.float32))
    Yj = np.asarray(jax_est.embedding_)
    c0 = np.asarray(jseed.kmeans_plusplus_init(jnp.asarray(Yj), K, k_km,
                                               weights=jnp.ones(n)))
    picks = [int(np.argmin(((Yj - c) ** 2).sum(1))) for c in c0]
    block_lanczos = lz.block_lanczos

    def started(matmat, n_, steps, generator, **kw):
        return block_lanczos(matmat, n_, steps, None, V0=V0, **kw)

    monkeypatch.setattr(lz, "block_lanczos", started)
    monkeypatch.setattr(km, "kmeans_plusplus_init",
                        lambda y, k, generator, weights=None: y[picks])


@pytest.mark.parametrize("solver", ["block-lanczos", "eigh"])
@pytest.mark.parametrize("name", AFFINITY_NAMES)
def test_fit_matches_jax_with_injected_starts(monkeypatch, fit_data, name,
                                              solver):
    pts, truth = fit_data
    x = pts[:N_FIT]
    arg = _similarity(x, FIT_KW["sigma"]) if name == "precomputed" else x
    jax_est = JaxSC(K, affinity=name, eigensolver=solver,
                    **FIT_KW).fit(jnp.asarray(arg))
    _inject(monkeypatch, jax_est, N_FIT, 8)
    est = SpectralClustering(K, affinity=name, eigensolver=solver,
                             device="cpu", **FIT_KW).fit(arg)
    labels = est.labels_.numpy()
    assert ari(np.asarray(jax_est.labels_), labels) >= 0.99
    assert ari(truth[:N_FIT], labels) >= 0.99
    np.testing.assert_allclose(est.eigenvalues_.numpy(),
                               np.asarray(jax_est.eigenvalues_), atol=1e-4)
    assert est.info_["matrix_passes"] == jax_est.info_["matrix_passes"]
    assert est.info_["affinity"] == name


@pytest.mark.parametrize("solver", ["lanczos", "block-lanczos", "eigh"])
@pytest.mark.parametrize("name", AFFINITY_NAMES)
def test_every_dense_family_fit_runs(fit_data, name, solver):
    pts, truth = fit_data
    x = pts[:N_FIT]
    arg = _similarity(x, FIT_KW["sigma"]) if name == "precomputed" else x
    est = SpectralClustering(K, affinity=name, eigensolver=solver,
                             device="cpu", **FIT_KW).fit(arg)
    assert ari(truth[:N_FIT], est.labels_.numpy()) >= 0.99


def test_precomputed_fit_refuses_transform_and_save(fit_data, tmp_path):
    x = fit_data[0][:N_FIT]
    S = ops.rbf_similarity(_t(x), _t(x), FIT_KW["sigma"])
    est = SpectralClustering(K, affinity="precomputed", eigensolver="eigh",
                             device="cpu").fit(S)
    dense = SpectralClustering(K, affinity="dense", eigensolver="eigh",
                               device="cpu", sigma=FIT_KW["sigma"]).fit(x)
    assert ari(dense.labels_.numpy(), est.labels_.numpy()) == 1.0
    with pytest.raises(ValueError, match="precomputed"):
        est.transform(x[:5])
    with pytest.raises(ValueError, match="precomputed"):
        est.save(str(tmp_path))
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# save / load across the two packages
# ---------------------------------------------------------------------------

def test_port_save_loads_in_jax(fit_data, tmp_path):
    pts, _ = fit_data
    est = SpectralClustering(K, affinity="dense",
                             eigensolver="block-lanczos", device="cpu",
                             **FIT_KW).fit(pts[:N_FIT])
    path = est.save(str(tmp_path))
    assert os.path.basename(path) == "model_0000000000.npz"
    loaded = JaxSC.load(str(tmp_path))
    held = pts[N_FIT:]
    np.testing.assert_array_equal(
        np.asarray(loaded.predict(jnp.asarray(held))),
        est.predict(held).numpy())
    assert loaded.affinity == "dense" and loaded.sparsify_t is None
    again = SpectralClustering.load(str(tmp_path), device="cpu")
    assert torch.equal(again.predict(held), est.predict(held))


@pytest.mark.parametrize("path", ["dense", "fused"])
def test_jax_save_loads_in_the_port(fit_data, tmp_path, path):
    pts, _ = fit_data
    jax_est = JaxSC(K, affinity="dense", eigensolver="block-lanczos",
                    transform_path=path, **FIT_KW)
    jax_est.fit(jnp.asarray(pts[:N_FIT]))
    jax_est.save(str(tmp_path))
    est = SpectralClustering.load(str(tmp_path), device="cpu")
    held = pts[N_FIT:]
    np.testing.assert_array_equal(
        est.predict(held).numpy(),
        np.asarray(jax_est.predict(jnp.asarray(held))))
    assert est.info_["transform"]["path"] == path
    assert est.info_["affinity"] == "dense"
    assert est.transform_path == path and est.lanczos_steps == 64


@pytest.mark.parametrize("key,value,match", [
    ("schedule", "auto", "schedule"),
    ("compute_dtype", "bfloat16", "compute_dtype"),
    ("affinity", "triangular", "triangular"),
    ("eigensolver", "chebdav", "chebdav"),
    ("dtype", "bfloat16", "dtype"),
    ("max_retries", 3, "max_retries")])
def test_load_names_what_it_cannot_honour(fit_data, tmp_path, key, value,
                                          match):
    SpectralClustering(K, affinity="dense", eigensolver="eigh",
                       device="cpu").fit(fit_data[0][:40]).save(str(tmp_path))
    cfg_path = tmp_path / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["params"][key] = value
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=match):
        SpectralClustering.load(str(tmp_path), device="cpu")


@pytest.mark.parametrize("change", ["drop", "add"])
def test_load_names_missing_and_extra_arrays(fit_data, tmp_path, change):
    SpectralClustering(K, affinity="dense", eigensolver="eigh",
                       device="cpu").fit(fit_data[0][:40]).save(str(tmp_path))
    path = tmp_path / "model_0000000000.npz"
    with np.load(path) as data:
        arrays = dict(data)
    if change == "drop":
        del arrays["centers"]
        match = r"missing \['centers'\], not expected \[\]"
    else:
        arrays["b/c"] = np.zeros(3)
        match = r"missing \[\], not expected \['b/c'\]"
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match=match):
        SpectralClustering.load(str(tmp_path), device="cpu")
