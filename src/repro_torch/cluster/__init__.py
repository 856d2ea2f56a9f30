"""The estimator and its backend registries (port of ``repro.cluster``)."""
from repro_torch.cluster.affinity import AFFINITIES
from repro_torch.cluster.assigners import ASSIGNERS
from repro_torch.cluster.eigensolvers import EIGENSOLVERS
from repro_torch.cluster.estimator import SpectralClustering
from repro_torch.cluster.metrics import ari
from repro_torch.cluster.operator import NormalizedOperator, SpectralResult

__all__ = ["AFFINITIES", "ASSIGNERS", "EIGENSOLVERS", "NormalizedOperator",
           "SpectralClustering", "SpectralResult", "ari"]
