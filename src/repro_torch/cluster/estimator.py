"""The estimator — port of ``repro/cluster/estimator.py`` (single device).

    est = SpectralClustering(k=8, affinity="fused-rbf",
                             eigensolver="block-lanczos", assigner="lloyd")
    est.fit(x)                 # points (n, d)
    est.labels_                # (n,) cluster ids
    est.predict(x_new)         # nearest fitted center in embedding space

``fit`` runs the paper's three phases — similarity, eigendecomposition,
k-means — each chosen by a registry name.  Ported so far: affinities
``fused-rbf``, ``dense``, ``knn-topt`` and ``precomputed``, eigensolvers
``lanczos``, ``block-lanczos`` and ``eigh``, assigner ``lloyd``; any other
name raises ``ValueError`` at construction.

Randomness comes from two ``torch.Generator``s on the estimator's device,
seeded ``seed`` (Lanczos start block) and ``seed + 1`` (k-means++).  They
draw other numbers than the JAX package's keys; the tests inject the JAX
start block and centers where they compare the two step for step.

:meth:`SpectralClustering.save` and :meth:`SpectralClustering.load` keep
the JAX package's on-disk layout (``repro/cluster/estimator.py:427-531``),
so a model saved by either package loads in the other.
:meth:`SpectralClustering.from_state` builds a fitted estimator from the
Nystrom serving state as numpy arrays under the model's array names.
"""
from __future__ import annotations

import inspect
import json
import os
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch.cluster import serving
from repro_torch.cluster.affinity import AFFINITIES, check_compute_dtype
from repro_torch.cluster.assigners import ASSIGNERS
from repro_torch.cluster.eigensolvers import EIGENSOLVERS
from repro_torch.cluster.operator import SpectralResult
from repro_torch.core import kmeans as km, similarity as sim
from repro_torch.device import resolve_device

# the JAX model's layout version and array names
# (repro/cluster/estimator.py:38-40)
MODEL_FORMAT = 1
MODEL_ARRAYS = ("train_x", "eigvecs", "inv_sqrt", "eigenvalues", "centers",
                "sigma", "labels", "embedding")
# JAX constructor knobs of backends and engine parts the port does not
# run, as ``save`` writes them (the JAX defaults); ``load`` ignores them
JAX_ONLY_PARAMS = {"cheb_degree": 12, "minibatch_size": 256,
                   "chunk_size": None, "workers": 1, "prefetch_depth": 2}
# the npz the JAX checkpoint manager writes for name "model", step 0
# (repro/checkpoint/manager.py:43): arrays under their flat keys
MODEL_FILE = "model_0000000000.npz"


def _save_model_arrays(directory: str, arrays: Mapping[str, object]) -> str:
    """Write ``arrays`` as :data:`MODEL_FILE`, atomically (a temporary
    file, then ``os.replace``); returns its path."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in arrays.items()}
    path = os.path.join(directory, MODEL_FILE)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **flat)
    os.replace(path + ".tmp", path)
    return path


def _restore_model_arrays(directory: str) -> dict[str, np.ndarray]:
    """The :data:`MODEL_ARRAYS` of :data:`MODEL_FILE`; raises naming the
    keys missing from the file and the keys it has beyond them."""
    with np.load(os.path.join(directory, MODEL_FILE)) as data:
        flat = dict(data)
    missing = sorted(set(MODEL_ARRAYS) - set(flat))
    extra = sorted(set(flat) - set(MODEL_ARRAYS))
    if missing or extra:
        raise ValueError(
            f"{MODEL_FILE} in {directory} does not hold the model's "
            f"arrays: missing {missing}, not expected {extra}")
    return {k: flat[k] for k in MODEL_ARRAYS}


class SpectralClustering:
    """Spectral clustering with pluggable phase backends, on one device.

    Parameters (names and defaults as in the JAX estimator where ported)
    ----------
    k:              number of clusters (and embedding dimensions).
    affinity:       "fused-rbf" (the default here; the JAX default
                    "triangular" is not ported yet) | "dense" |
                    "knn-topt" | "precomputed".  With "precomputed",
                    ``fit(S)`` takes the (n, n) similarity matrix.
    eigensolver:    "lanczos" | "block-lanczos" | "eigh".
    assigner:       "lloyd".
    sigma:          RBF bandwidth; None = median heuristic.
    lanczos_steps:  None = max(4k, 32), capped below n; for
                    "block-lanczos" the target Krylov dimension.
    block_size:     block width for "block-lanczos" (None = 8).
    kmeans_iters:   Lloyd rounds at most.
    sparsify_t:     top-t per row for "knn-topt" (None = max(k + 2, 10)).
    compute_dtype:  None / "float32"; "bf16" is not ported yet and raises.
    transform_path: "auto" | "dense" | "fused" for transform/predict.
    memory_budget:  bytes the dense transform route may materialize
                    (None = 64 MiB).
    seed:           seeds the estimator's generators.
    device:         None = "cuda" (raises without a card) | "cpu" (the
                    kernels' plain PyTorch versions).

    Fitted attributes: ``labels_``, ``embedding_``, ``eigenvalues_``,
    ``centers_``, ``sigma_``, ``info_``, ``result_``.
    """

    def __init__(self, k: int = 8, *, affinity: str = "fused-rbf",
                 eigensolver: str = "lanczos", assigner: str = "lloyd",
                 sigma: float | None = None, lanczos_steps: int | None = None,
                 block_size: int | None = None, kmeans_iters: int = 50,
                 sparsify_t: int | None = None, compute_dtype=None,
                 transform_path: str = "auto",
                 memory_budget: int | None = None, seed: int = 0,
                 device=None):
        self._affinity_fn = AFFINITIES.get(affinity)
        self._eigensolver_fn = EIGENSOLVERS.get(eigensolver)
        self._assigner_fn = ASSIGNERS.get(assigner)
        check_compute_dtype(compute_dtype)
        serving.check_transform_path(transform_path)
        self.k = k
        self.affinity = affinity
        self.eigensolver = eigensolver
        self.assigner = assigner
        self.sigma = sigma
        self.lanczos_steps = lanczos_steps
        self.block_size = block_size
        self.kmeans_iters = kmeans_iters
        self.sparsify_t = sparsify_t
        self.compute_dtype = compute_dtype
        self.transform_path = transform_path
        self.memory_budget = memory_budget
        self.seed = seed
        self.device = resolve_device(device)
        self.result_: SpectralResult | None = None

    # -- configuration helpers ------------------------------------------------

    def num_lanczos_steps(self, n: int) -> int:
        m = self.lanczos_steps or max(4 * self.k, 32)
        return int(min(m, n - 1))

    def num_block_size(self, n: int | None = None) -> int:
        if self.block_size is not None:
            if self.block_size <= 0:
                raise ValueError(
                    f"block_size must be positive, got {self.block_size}")
            b = int(self.block_size)
        else:
            b = 8 if self.eigensolver == "block-lanczos" else max(2, self.k)
        return b if n is None else max(1, min(b, n))

    def num_block_steps(self, n: int) -> int:
        """Block steps covering the single-vector Krylov dimension."""
        b = self.num_block_size(n)
        return max(1, -(-self.num_lanczos_steps(n) // b))

    def _generator(self, offset: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + offset)
        return g

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- fitting --------------------------------------------------------------

    def fit(self, x) -> "SpectralClustering":
        """Cluster points (n, d) — or, with ``affinity="precomputed"``, a
        similarity matrix (n, n); numpy or tensor.  Returns ``self``."""
        if self.affinity == "precomputed":
            return self.fit_affinity(x)
        t0 = time.perf_counter()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        sigma = torch.tensor(self.sigma, dtype=torch.float32,
                             device=self.device) \
            if self.sigma is not None else sim.median_sigma(x)
        op = self._affinity_fn(self, x, sigma)
        self._sync()
        walls = {"affinity": time.perf_counter() - t0}
        return self._finish(op, sigma, x, walls, self.affinity)

    def fit_affinity(self, S) -> "SpectralClustering":
        """Cluster from a precomputed (n, n) similarity/adjacency matrix
        (the paper's §5 graph dataset), whatever ``self.affinity`` is.
        Such a fit has no training points: it cannot ``transform`` or
        ``save``."""
        t0 = time.perf_counter()
        op = AFFINITIES.get("precomputed")(self, S, None)
        self._sync()
        walls = {"affinity": time.perf_counter() - t0}
        return self._finish(op, torch.zeros((), device=self.device), None,
                            walls, "precomputed")

    def _finish(self, op, sigma, train_x, walls, affinity_used):
        op.reset_stats()
        t0 = time.perf_counter()
        evals, Z, info = self._eigensolver_fn(self, op, self._generator(0))
        self._sync()
        t1 = time.perf_counter()
        Y = km.normalize_rows(Z) * op.valid[:, None]
        labels, centers = self._assigner_fn(self, Y, op.valid,
                                            self._generator(1))
        self._sync()
        walls.update(eigensolve=t1 - t0, assign=time.perf_counter() - t1)

        self.labels_ = op.unpermute(labels)
        self.embedding_ = op.unpermute(Y)
        self.eigenvalues_ = evals
        self.centers_ = centers
        self.sigma_ = sigma
        self.info_ = dict(info, affinity=affinity_used,
                          eigensolver=self.eigensolver,
                          assigner=self.assigner, n=op.n, phase_s=walls)
        op_stats = op.stats_snapshot()
        if op_stats:
            self.info_["engine"] = op_stats
        # Nystrom-extension state for transform()/predict()
        self._train_x = train_x
        self._eigvecs = op.unpermute(Z)
        self._inv_sqrt = op.unpermute(op.inv_sqrt)
        self.result_ = SpectralResult(
            labels=self.labels_, embedding=self.embedding_,
            eigenvalues=evals, centers=centers, sigma=sigma, info=self.info_)
        return self

    @classmethod
    def from_state(cls, arrays: Mapping[str, np.ndarray], *, k: int,
                   device=None, **params) -> "SpectralClustering":
        """A fitted estimator from another fit's serving state: the arrays
        under :data:`MODEL_ARRAYS` (a JAX estimator's ``_train_x``,
        ``_eigvecs``, ``_inv_sqrt``, ``eigenvalues_``, ``centers_``,
        ``sigma_``, ``labels_``, ``embedding_`` as numpy).  ``params`` are
        constructor arguments (``transform_path``, ``memory_budget``, ...)."""
        missing = [name for name in MODEL_ARRAYS if name not in arrays]
        if missing:
            raise ValueError(f"from_state: missing arrays {missing}; "
                             f"expected {list(MODEL_ARRAYS)}")
        est = cls(k, device=device, **params)

        def t(name, dtype=torch.float32):
            return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                                   device=est.device)

        est._train_x = t("train_x")
        est._eigvecs = t("eigvecs")
        est._inv_sqrt = t("inv_sqrt")
        est.eigenvalues_ = t("eigenvalues")
        est.centers_ = t("centers")
        est.sigma_ = t("sigma")
        est.labels_ = t("labels", torch.int64)
        est.embedding_ = t("embedding")
        if est._eigvecs.shape != (est._train_x.shape[0], k):
            raise ValueError(f"from_state: eigvecs {tuple(est._eigvecs.shape)}"
                             f" must be ({est._train_x.shape[0]}, {k})")
        est.info_ = {"from_state": True}
        est.result_ = SpectralResult(
            labels=est.labels_, embedding=est.embedding_,
            eigenvalues=est.eigenvalues_, centers=est.centers_,
            sigma=est.sigma_, info=est.info_)
        return est

    # -- out-of-sample extension ----------------------------------------------

    def transform(self, x) -> torch.Tensor:
        """Embed new points (m, d) into the fitted spectral space by the
        Nystrom extension, routed per ``transform_path``; the route taken
        is recorded in ``info_["transform"]``."""
        self._check_fitted()
        if self._train_x is None:
            raise ValueError(
                "transform/predict need the training points; an estimator "
                "fitted from a precomputed similarity matrix cannot embed "
                "new points")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        m, n = int(x.shape[0]), int(self._train_x.shape[0])
        path = serving.route_transform(n, m, path=self.transform_path,
                                       memory_budget=self.memory_budget)
        mu = serving.shifted_mu(self.eigenvalues_)
        if path == "dense":
            K = sim.rbf_kernel(x, self._train_x, self.sigma_)
            O = K @ (self._inv_sqrt[:, None] * self._eigvecs)
            emb = serving.extension_from_product(O, K.sum(1), mu)
        else:
            emb = serving.fused_transform(x, self._train_x, self._eigvecs,
                                          self._inv_sqrt, self.sigma_, mu)
        self.info_.setdefault("transform", {}).update(path=path, m=m)
        return emb

    def predict(self, x) -> torch.Tensor:
        """Nearest fitted center of each new point in embedding space."""
        return km.assign(self.transform(x), self.centers_)

    def _check_fitted(self):
        if self.result_ is None:
            raise ValueError("this SpectralClustering instance is not "
                             "fitted yet; call fit() first")

    # -- persistence ----------------------------------------------------------

    def save(self, directory: str) -> str:
        """Persist the fitted model in the JAX package's layout: the
        serving state (:data:`MODEL_ARRAYS`) as ``model_0000000000.npz``
        plus an atomic ``config.json`` of the constructor parameters, with
        the JAX defaults for the knobs the port lacks.  Returns the npz
        path.  Restore with :meth:`load` (either package)."""
        self._check_fitted()
        if self._train_x is None:
            raise ValueError(
                "cannot save a model fitted from a precomputed similarity "
                "matrix; transform/predict would have no training points")
        state = {"train_x": self._train_x, "eigvecs": self._eigvecs,
                 "inv_sqrt": self._inv_sqrt,
                 "eigenvalues": self.eigenvalues_, "centers": self.centers_,
                 "sigma": self.sigma_, "labels": self.labels_,
                 "embedding": self.embedding_}
        path = _save_model_arrays(directory, state)
        params = dict(
            JAX_ONLY_PARAMS, k=self.k, affinity=self.affinity,
            eigensolver=self.eigensolver, assigner=self.assigner,
            sigma=self.sigma, lanczos_steps=self.lanczos_steps,
            block_size=self.block_size, kmeans_iters=self.kmeans_iters,
            sparsify_t=self.sparsify_t,
            compute_dtype=None if self.compute_dtype is None
            else "float32", schedule=None,
            transform_path=self.transform_path,
            memory_budget=self.memory_budget, seed=self.seed,
            dtype="float32")
        cfg = {"format": MODEL_FORMAT, "params": params,
               "fitted": {"n": int(self._train_x.shape[0]),
                          "d": int(self._train_x.shape[1]),
                          "info": {k: v for k, v in self.info_.items()
                                   if isinstance(v, (str, int, float))}}}
        tmp = os.path.join(directory, "config.json.tmp")
        with open(tmp, "w") as f:
            json.dump(cfg, f, indent=2)
        os.replace(tmp, os.path.join(directory, "config.json"))
        return path

    @classmethod
    def load(cls, directory: str, *, device=None) -> "SpectralClustering":
        """Rebuild a fitted estimator from a :meth:`save` of either
        package.  Raises ``ValueError`` naming any parameter the port
        cannot honour (a non-null ``schedule``, a dtype other than
        float32, a bf16 ``compute_dtype``, an unported backend);
        :data:`JAX_ONLY_PARAMS` are ignored."""
        with open(os.path.join(directory, "config.json")) as f:
            cfg = json.load(f)
        if cfg.get("format") != MODEL_FORMAT:
            raise ValueError(
                f"unsupported model format {cfg.get('format')!r} in "
                f"{directory} (this build reads format {MODEL_FORMAT})")
        params = {k: v for k, v in cfg["params"].items()
                  if k not in JAX_ONLY_PARAMS}
        schedule = params.pop("schedule", None)
        if schedule not in (None, "default"):
            raise ValueError(f"load: schedule={schedule!r} cannot be "
                             f"honoured; the port has no schedule layer "
                             f"yet (ROADMAP.md)")
        dtype = params.pop("dtype", "float32")
        if dtype != "float32":
            raise ValueError(f"load: dtype={dtype!r} cannot be honoured; "
                             f"the port runs float32")
        unknown = sorted(set(params) - set(inspect.signature(cls).parameters)
                         - {"device"})
        if unknown:
            raise ValueError(f"load: parameters {unknown} cannot be "
                             f"honoured by this estimator")
        arrays = _restore_model_arrays(directory)
        est = cls.from_state(arrays, device=device, **params)
        est.info_ = dict(cfg["fitted"].get("info", {}))
        est.result_.info = est.info_
        return est
