from pcaudio_torch.core.types import PointCloud
from pcaudio_torch.core.config import (
    ARCH_3ST, ARCH_CNN, ARCH_FB, ARCH_FST, ExperimentConfig)

__all__ = ["PointCloud", "ExperimentConfig", "ARCH_FST", "ARCH_3ST", "ARCH_FB",
           "ARCH_CNN"]
