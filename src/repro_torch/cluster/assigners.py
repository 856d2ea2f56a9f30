"""Assigner backends — port of ``repro/cluster/assigners.py:31``.

Signature: ``backend(est, Y, valid, generator) -> (labels, centers)``
for the row-normalized (n, k) embedding ``Y``.

Ported backend:
  lloyd   full Lloyd k-means (paper §4.3.3) from a k-means++ start; the
          assignment step runs on the ``kmeans_assign`` CUDA kernel.
"""
from __future__ import annotations

from repro_torch.cluster.registry import Registry
from repro_torch.core import kmeans as km

ASSIGNERS = Registry("assigner")


@ASSIGNERS.register("lloyd")
def lloyd_assigner(est, Y, valid, generator):
    labels, state = km.distributed_kmeans(Y, valid, est.k, generator,
                                          iters=est.kmeans_iters)
    return labels, state.centers
