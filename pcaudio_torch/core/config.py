"""Reference config JSON round-trip (counterpart of ``pcaudio/core/config.py``).

The JAX package's module cannot be imported here: ``pcaudio/core/__init__.py``
imports ``types.py``, which imports jax.  This keeps the set-transformer
part of ``ExperimentConfig``: its keys, its defaults, the ``np_seed`` legacy
alias of ``numpy_seed`` (3ST/CNNTemp configs), and ``to_reference_json``,
which writes the per-architecture schema back so a checkpoint saved here is
read by reference-convention tooling.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

ARCH_FST = "FST (Framewise Set Transformer)"
ARCH_3ST = "3ST (Set Transformer Temporal)"
# the baselines' names, so that their configs are recognised; their models
# are not ported yet (ROADMAP Queue 1)
ARCH_FB = "FB (Framewise Feed Forward Baseline)"
ARCH_CNN = "CNN_Temp (Temporal Baseline CNN)"


@dataclasses.dataclass
class ExperimentConfig:
    """The set-transformer, featurizer and training keys of a reference
    config."""

    architecture: str = ARCH_FST
    dataset: str = "ESC10"
    epochs: int = 500
    weight_decay: float = 1.0e-3
    learning_rate: float = 1.0e-3
    batch_size: int = 128
    window_size: int = 2048        # Nfft
    hop_factor: float = 0.5
    trim_dB: float = 60
    sampling_rate: int = 44100
    classes: int = 10
    numpy_seed: int = 1
    torch_seed: int = 1
    dhidden: Optional[int] = None
    nheads: Optional[int] = None
    ninds: Optional[int] = None
    Ntemp: Optional[int] = None
    model_params: Optional[int] = None

    @classmethod
    def from_reference_json(cls, path_or_dict) -> "ExperimentConfig":
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        return cls(
            architecture=d.get("architecture", ARCH_FST),
            dataset=d.get("dataset", "ESC10"),
            epochs=d.get("epochs", 500),
            weight_decay=d.get("weight_decay", 1.0e-3),
            learning_rate=d.get("learning_rate", 1.0e-3),
            batch_size=d.get("batch_size", 128),
            window_size=d.get("window_size", 2048),
            hop_factor=d.get("hop_factor", 0.5),
            trim_dB=d.get("trim_dB", 60),
            sampling_rate=d.get("sampling_rate", 44100),
            classes=d.get("classes", 10),
            numpy_seed=d.get("numpy_seed", d.get("np_seed", 1)),
            torch_seed=d.get("torch_seed", 1),
            dhidden=d.get("dhidden"),
            nheads=d.get("nheads"),
            ninds=d.get("ninds"),
            Ntemp=d.get("Ntemp"),
            model_params=d.get("model_params"),
        )

    def to_reference_json(self) -> dict:
        """The reference schema of a set-transformer config (``np_seed`` for
        the temporal 3ST, ``numpy_seed`` for FST), key for key as
        ``pcaudio/core/config.py`` writes it."""
        if self.architecture not in (ARCH_FST, ARCH_3ST):
            raise NotImplementedError(
                f"{self.architecture!r} is not ported yet (ROADMAP Queue 1)")
        d = {
            "epochs": self.epochs,
            "weight_decay": self.weight_decay,
            "window_size": self.window_size,
            "hop_factor": self.hop_factor,
            "trim_dB": self.trim_dB,
            "sampling_rate": self.sampling_rate,
            "classes": self.classes,
            "batch_size": self.batch_size,
            "learning_rate": self.learning_rate,
            "dataset": self.dataset,
            "architecture": self.architecture,
            "model_params": self.model_params,
        }
        if self.architecture == ARCH_3ST:
            d["Ntemp"] = self.Ntemp
            d["np_seed"] = self.numpy_seed
        else:
            d["numpy_seed"] = self.numpy_seed
        d["torch_seed"] = self.torch_seed
        d.update(dhidden=self.dhidden, nheads=self.nheads, ninds=self.ninds)
        return d

    def build_model(self, fused_attn: bool = False):
        """The torch ``ST`` this config describes (FST: 2-D clouds, 3ST: 3-D);
        ``fused_attn`` routes its attention through kernel K4."""
        from pcaudio_torch.nn import ST

        if self.architecture not in (ARCH_FST, ARCH_3ST):
            raise NotImplementedError(
                f"{self.architecture!r} is not ported yet (ROADMAP Queue 1)")
        return ST(dim_input=2 if self.architecture == ARCH_FST else 3,
                  num_outputs=1, dim_output=self.classes,
                  num_inds=self.ninds, dim_hidden=self.dhidden,
                  num_heads=self.nheads, fused_attn=fused_attn)
