"""The port's estimator stack (``repro_torch.cluster``) against
``repro.cluster`` on the CPU.

* the fused-rbf operator's ``matmat`` against the JAX operator's, on the
  JAX operator's first n rows (the JAX one is tile-padded, the port's is
  not), isolated point included;
* the eigensolvers with a start block injected that is zero on the JAX
  padded rows, so both recurrences are the same;
* ``from_state`` fed a JAX fit's serving state: ``transform`` (both
  routes) and ``predict`` against the JAX estimator's;
* the whole slice: port fit against JAX fit on blobs and rings;
* package rules: importing the port loads neither ``jax`` nor ``repro``,
  no card and no ``device="cpu"`` raises, unported names raise.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import SpectralClustering as JaxSC, serving as jserving
from repro.cluster.affinity import build_fused_rbf_operator as jax_operator
from repro.core import lanczos as jlz, similarity as jsim
from repro.data import synthetic
from repro.distrib import mesh_utils
from repro_torch import SpectralClustering, ari
from repro_torch.cluster import serving
from repro_torch.cluster.affinity import build_fused_rbf_operator
from repro_torch.cluster.estimator import MODEL_ARRAYS
from repro_torch.core import lanczos as lz, laplacian as lp, similarity as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def _sign_aligned(got, want):
    s = np.sign(np.sum(got * want, axis=0))
    return got * np.where(s == 0, 1.0, s)[None, :]


def _points(n=97, isolated=False):
    x, _ = synthetic.blobs(n, 3, dim=4, spread=0.8, seed=0)
    if isolated:
        x[7] = 1e4          # off-diagonal similarity underflows to 0
    return x


# ---------------------------------------------------------------------------
# the fused-rbf operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("isolated", [False, True])
def test_operator_matmat_matches_jax(isolated):
    x = _points(isolated=isolated)
    n = x.shape[0]
    op_j = jax_operator(jnp.asarray(x), 1.0, mesh_utils.local_mesh("rows"))
    op = build_fused_rbf_operator(_t(x), 1.0)
    assert op_j.n_pad > n and op.n == n          # the port does not pad
    V = np.random.RandomState(1).randn(op_j.n_pad, 4).astype(np.float32)
    V[n:] = 0.0
    want = np.asarray(op_j.matmat(jnp.asarray(V)))[:n]
    got = op.matmat(_t(V[:n])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(op.inv_sqrt.numpy(),
                               np.asarray(op_j.inv_sqrt)[:n], rtol=1e-5)
    # and against the materialized oracle
    A = lp.dense_shifted_matrix(sim.rbf_kernel(_t(x), _t(x), 1.0), op.valid)
    np.testing.assert_allclose(got, (A @ _t(V[:n])).numpy(), rtol=1e-4,
                               atol=1e-4)
    if isolated:    # the detached point sees only itself: A row = 2 I row
        np.testing.assert_allclose(got[7], 2.0 * V[7], rtol=1e-4, atol=1e-4)


def test_operator_counts_passes_and_resets():
    op = build_fused_rbf_operator(_t(_points(20)), 1.0)
    assert op.stats_snapshot()["matrix_passes"] == 1      # degree pass
    op.matmat(torch.ones(20, 3))
    op.matvec(torch.ones(20))
    assert op.stats_snapshot()["matrix_passes"] == 3
    op.reset_stats()
    assert op.stats_snapshot()["matrix_passes"] == 1


# ---------------------------------------------------------------------------
# eigensolvers through the operators, start block injected
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def operators():
    x = _points()
    sigma = float(jsim.median_sigma(jnp.asarray(x)))
    op_j = jax_operator(jnp.asarray(x), sigma, mesh_utils.local_mesh("rows"))
    return op_j, build_fused_rbf_operator(_t(x), sigma)


@pytest.mark.parametrize("b,steps", [(1, 24), (4, 6)])
def test_eigensolvers_match_jax_with_injected_start(operators, b, steps):
    op_j, op = operators
    n, k = op.n, 3
    V0 = np.random.RandomState(b).randn(b, op_j.n_pad).astype(np.float32)
    V0[:, n:] = 0.0                               # zero on JAX's padding
    key = jax.random.PRNGKey(0)
    if b == 1:
        st_j = jlz.lanczos(op_j.matvec, op_j.n_pad, steps, key,
                           v0=jnp.asarray(V0[0]))
        vals_j, vecs_j = jlz.topk_of_shifted(st_j, k)
        vals, vecs = lz.topk_of_shifted(
            lz.lanczos(op.matvec, n, steps, v0=V0[0, :n]), k)
    else:
        st_j = jlz.block_lanczos(op_j.matmat, op_j.n_pad, steps, key,
                                 block_size=b, V0=jnp.asarray(V0))
        vals_j, vecs_j = jlz.block_topk_of_shifted(st_j, k)
        vals, vecs = lz.block_topk_of_shifted(
            lz.block_lanczos(op.matmat, n, steps, block_size=b,
                             V0=V0[:, :n]), k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), atol=1e-4)
    want = np.asarray(vecs_j)[:n]
    np.testing.assert_allclose(_sign_aligned(vecs.numpy(), want), want,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# fits: the whole slice, and the state carried across
# ---------------------------------------------------------------------------

_DATASETS = {
    # name: (points, labels, k, estimator kwargs shared by both packages)
    "blobs": lambda: (*synthetic.blobs(500, 4, dim=8, seed=0), 4,
                      dict(eigensolver="block-lanczos")),
    "rings": lambda: (*synthetic.rings(480, 2, seed=0), 2,
                      dict(eigensolver="lanczos", sigma=0.25,
                           lanczos_steps=64, kmeans_iters=40)),
}
N_TRAIN = 400


@pytest.fixture(scope="module", params=sorted(_DATASETS))
def fits(request):
    pts, truth, k, kw = _DATASETS[request.param]()
    x = pts[:N_TRAIN]
    jax_est = JaxSC(k, affinity="fused-rbf", seed=0, **kw).fit(jnp.asarray(x))
    est = SpectralClustering(k, affinity="fused-rbf", seed=0, device="cpu",
                             **kw).fit(x)
    return request.param, pts, truth, k, kw, jax_est, est


def test_fit_matches_jax(fits):
    _, _, truth, _, _, jax_est, est = fits
    labels = est.labels_.numpy()
    assert labels.shape == (N_TRAIN,)
    assert ari(np.asarray(jax_est.labels_), labels) >= 0.99
    assert ari(truth[:N_TRAIN], labels) >= 0.99
    np.testing.assert_allclose(est.eigenvalues_.numpy(),
                               np.asarray(jax_est.eigenvalues_), atol=1e-3)
    assert est.info_["engine"]["matrix_passes"] == \
        jax_est.info_["engine"]["matrix_passes"]
    assert est.info_["matrix_passes"] == jax_est.info_["matrix_passes"]
    assert set(est.info_["phase_s"]) == {"affinity", "eigensolve", "assign"}


@pytest.mark.parametrize("path", ["dense", "fused"])
def test_from_state_serves_like_jax(fits, path):
    _, pts, _, k, kw, jax_est, _ = fits
    arrays = {"train_x": jax_est._train_x, "eigvecs": jax_est._eigvecs,
              "inv_sqrt": jax_est._inv_sqrt,
              "eigenvalues": jax_est.eigenvalues_,
              "centers": jax_est.centers_, "sigma": jax_est.sigma_,
              "labels": jax_est.labels_, "embedding": jax_est.embedding_}
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    assert set(arrays) == set(MODEL_ARRAYS)
    est = SpectralClustering.from_state(arrays, k=k, device="cpu",
                                        transform_path=path)
    held = pts[N_TRAIN:]
    jax_est.transform_path = path
    want = np.asarray(jax_est.transform(jnp.asarray(held)))
    want_labels = np.asarray(jax_est.predict(jnp.asarray(held)))
    got = est.transform(held).numpy()
    assert est.info_["transform"]["path"] == path
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(est.predict(held).numpy(), want_labels)


def test_from_state_names_missing_arrays():
    with pytest.raises(ValueError, match="eigvecs"):
        SpectralClustering.from_state({"train_x": np.zeros((3, 2))}, k=2,
                                      device="cpu")


@pytest.mark.parametrize("n,m,path,budget", [
    (4096, 4096, "auto", None), (4096, 4097, "auto", None),
    (131072, 16384, "auto", None), (100, 100, "auto", 100 * 100 * 4 - 1),
    (10, 10, "fused", None), (10 ** 6, 10 ** 6, "dense", None)])
def test_route_transform_matches_jax(n, m, path, budget):
    assert serving.route_transform(n, m, path=path, memory_budget=budget) \
        == jserving.route_transform(n, m, path=path, memory_budget=budget)


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    scanned = {os.path.relpath(p, REPO) for p in files}
    assert {"src/repro_torch/kernels/rbf_similarity.py",
            "src/repro_torch/kernels/block_matvec.py",
            "src/repro_torch/cluster/affinity.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/models/config.py",
            "src/repro_torch/models/params.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/api.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/qwen1_5_0_5b.py",
            "src/repro_torch/launch/serve.py"} <= scanned, scanned
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (path, mod)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert {'repro_torch.kernels.rbf_similarity',\n"
        "        'repro_torch.kernels.block_matvec',\n"
        "        'repro_torch.kernels.flash_attention',\n"
        "        'repro_torch.models.config', 'repro_torch.models.params',\n"
        "        'repro_torch.models.layers',\n"
        "        'repro_torch.models.transformer', 'repro_torch.models.api',\n"
        "        'repro_torch.configs', 'repro_torch.configs.qwen1_5_0_5b',\n"
        "        'repro_torch.launch',\n"
        "        'repro_torch.launch.serve'} <= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 36 and bad.strip() == "[]", out.stdout


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpectralClustering(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpectralClustering(3, device="cuda")
    assert SpectralClustering(3, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,match", [
    (dict(affinity="triangular"), "fused-rbf"),
    (dict(eigensolver="chebdav"), "block-lanczos"),
    (dict(assigner="minibatch"), "lloyd"),
    (dict(compute_dtype="bf16"), "not ported"),
    (dict(compute_dtype="fp8"), "compute_dtype"),
    (dict(transform_path="sparse"), "transform_path")])
def test_unported_or_unknown_names_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        SpectralClustering(3, device="cpu", **kw)


def test_predict_before_fit_raises():
    with pytest.raises(ValueError, match="not fitted"):
        SpectralClustering(2, device="cpu").predict(np.zeros((2, 2)))
