"""Reference config JSON reader (counterpart of ``pcaudio/core/config.py``).

The JAX package's module cannot be imported here: ``pcaudio/core/__init__.py``
imports ``types.py``, which imports jax.  This reads the keys the serving
path needs, with the defaults of ``ExperimentConfig.from_reference_json``
there.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

ARCH_FST = "FST (Framewise Set Transformer)"
ARCH_3ST = "3ST (Set Transformer Temporal)"


@dataclasses.dataclass
class ExperimentConfig:
    """The set-transformer and featurizer keys of a reference config."""

    architecture: str = ARCH_FST
    window_size: int = 2048        # Nfft
    hop_factor: float = 0.5
    trim_dB: float = 60
    sampling_rate: int = 44100
    classes: int = 10
    dhidden: Optional[int] = None
    nheads: Optional[int] = None
    ninds: Optional[int] = None
    Ntemp: Optional[int] = None

    @classmethod
    def from_reference_json(cls, path_or_dict) -> "ExperimentConfig":
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        return cls(
            architecture=d.get("architecture", ARCH_FST),
            window_size=d.get("window_size", 2048),
            hop_factor=d.get("hop_factor", 0.5),
            trim_dB=d.get("trim_dB", 60),
            sampling_rate=d.get("sampling_rate", 44100),
            classes=d.get("classes", 10),
            dhidden=d.get("dhidden"),
            nheads=d.get("nheads"),
            ninds=d.get("ninds"),
            Ntemp=d.get("Ntemp"),
        )

    def build_model(self):
        """The torch ``ST`` this config describes (FST: 2-D clouds, 3ST: 3-D)."""
        from pcaudio_torch.nn import ST

        if self.architecture not in (ARCH_FST, ARCH_3ST):
            raise NotImplementedError(
                f"{self.architecture!r} is not ported yet (ROADMAP Queue 1)")
        return ST(dim_input=2 if self.architecture == ARCH_FST else 3,
                  num_outputs=1, dim_output=self.classes,
                  num_inds=self.ninds, dim_hidden=self.dhidden,
                  num_heads=self.nheads)
