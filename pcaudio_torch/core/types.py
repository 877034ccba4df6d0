"""Point-cloud batch container (counterpart of ``pcaudio/core/types.py``).

Clouds are fixed-budget and padded, with an explicit validity mask, so every
device op is batched and shape-static.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PointCloud:
    """A batch of fixed-budget point clouds.

    Attributes:
      points: ``[B, K, d]`` float tensor; ``d`` is 2 for framewise clouds
        ``(f_norm, log_mag)`` and 3 for temporal clouds
        ``(f_norm, t_sec, log_mag)``.
      mask: ``[B, K]`` bool tensor; True for valid points.
    """

    points: torch.Tensor
    mask: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.points.shape[0]

    @property
    def budget(self) -> int:
        return self.points.shape[1]
