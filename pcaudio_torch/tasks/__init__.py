"""The Set Transformer's own tasks (counterpart of ``pcaudio/tasks``):
ModelNet40 classification, amortized MoG clustering, max-of-set
regression."""
from pcaudio_torch.tasks.clustering import (
    ClusteringConfig,
    sample_mog,
    mog_log_likelihood,
    parse_raw,
)
from pcaudio_torch.tasks.modelnet40 import ModelNet40Config
from pcaudio_torch.tasks.max_regression import SmallSetTransformer, SmallDeepSet

__all__ = [
    "ClusteringConfig", "sample_mog", "mog_log_likelihood", "parse_raw",
    "ModelNet40Config", "SmallSetTransformer", "SmallDeepSet",
]
