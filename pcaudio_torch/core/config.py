"""Reference config JSON round-trip (counterpart of ``pcaudio/core/config.py``).

The JAX package's module cannot be imported here: ``pcaudio/core/__init__.py``
imports ``types.py``, which imports jax.  This is the union of the four
reference config schemas: their keys, their defaults, the legacy aliases
(``numpy_seed`` for FST/FB and ``np_seed`` for 3ST/CNNTemp; ``layers`` for
FB and ``layer_dims`` for CNNTemp), and ``to_reference_json``, which writes
the per-architecture schema back so a checkpoint saved here is read by
reference-convention tooling.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

ARCH_FST = "FST (Framewise Set Transformer)"
ARCH_3ST = "3ST (Set Transformer Temporal)"
ARCH_FB = "FB (Framewise Feed Forward Baseline)"
ARCH_CNN = "CNN_Temp (Temporal Baseline CNN)"


@dataclasses.dataclass
class ExperimentConfig:
    """Union of the four reference config schemas."""

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
    # set-transformer models (FST/3ST)
    dhidden: Optional[int] = None
    nheads: Optional[int] = None
    ninds: Optional[int] = None
    # temporal models (3ST/CNNTemp)
    Ntemp: Optional[int] = None
    # FB / CNNTemp
    layers: Optional[List[int]] = None
    dropout_prob: Optional[float] = None
    # CNNTemp
    Nt: Optional[int] = None
    Nf: Optional[int] = None
    model_params: Optional[int] = None

    @property
    def is_set_model(self) -> bool:
        """FST and 3ST are set transformers on point clouds (and the
        reference wraps them in ``nn.DataParallel``); FB and CNN_temp take
        grids."""
        return self.architecture in (ARCH_FST, ARCH_3ST)

    @property
    def is_framewise(self) -> bool:
        """FST and FB classify frames; 3ST and CNN_temp ``Ntemp``-frame
        chunks."""
        return self.architecture in (ARCH_FST, ARCH_FB)

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
            layers=d.get("layers", d.get("layer_dims")),
            dropout_prob=d.get("dropout_prob"),
            Nt=d.get("Nt"),
            Nf=d.get("Nf"),
            model_params=d.get("model_params"),
        )

    def to_reference_json(self) -> dict:
        """The per-architecture reference schema (``np_seed`` for the
        temporal 3ST and CNN, ``numpy_seed`` for FST and FB; FB's ``layers``,
        CNN's ``layer_dims``), key for key as ``pcaudio/core/config.py``
        writes it."""
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
        if self.architecture in (ARCH_3ST, ARCH_CNN):
            d["Ntemp"] = self.Ntemp
            d["np_seed"] = self.numpy_seed
        else:
            d["numpy_seed"] = self.numpy_seed
        d["torch_seed"] = self.torch_seed
        if self.is_set_model:
            d.update(dhidden=self.dhidden, nheads=self.nheads, ninds=self.ninds)
        if self.architecture == ARCH_FB:
            d["layers"] = self.layers
            d["dropout_prob"] = self.dropout_prob
        if self.architecture == ARCH_CNN:
            d.update(Nt=self.Nt, Nf=self.Nf, layer_dims=self.layers,
                     dropout_prob=self.dropout_prob)
        return d

    def build_model(self, fused_attn: bool = False):
        """The torch model this config describes: an ``ST`` for FST (2-D
        clouds) and 3ST (3-D), ``BaselineFF`` for FB, ``CNNClassifier`` for
        CNN_Temp (dropout 0.5 unless the config names one).
        ``fused_attn`` routes an ST's attention through kernel K4; the
        baselines have no attention and ignore it."""
        from pcaudio_torch.nn import ST, BaselineFF, CNNClassifier

        if self.is_set_model:
            return ST(dim_input=2 if self.architecture == ARCH_FST else 3,
                      num_outputs=1, dim_output=self.classes,
                      num_inds=self.ninds, dim_hidden=self.dhidden,
                      num_heads=self.nheads, fused_attn=fused_attn)
        if self.architecture == ARCH_FB:
            return BaselineFF(layer_dims=tuple(self.layers),
                              nclasses=self.classes,
                              p=self.dropout_prob or 0.5)
        if self.architecture == ARCH_CNN:
            return CNNClassifier(Nt=self.Nt, Nf=self.Nf,
                                 layer_dims=tuple(self.layers),
                                 nclass=self.classes,
                                 p=self.dropout_prob or 0.5)
        raise ValueError(f"unknown architecture {self.architecture!r}")
