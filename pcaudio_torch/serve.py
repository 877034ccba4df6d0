"""Batched wave → class serving (counterpart of ``pcaudio/serve.py``).

Requests are padded to a fixed batch bucket: padded slots get length 1 and
are sliced off, so every call runs the same shapes.

    clf = AudioClassifier.from_reference_checkpoint(cfg_json, pth, device="cuda")
    labels, probs = clf.classify(list_of_float32_clips)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcaudio_torch.checkpoint import load_reference_pth
from pcaudio_torch.core.config import ARCH_3ST, ExperimentConfig
from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.data import pad_batch
from pcaudio_torch.eval.pipeline import (
    TemporalPipelineConfig, make_temporal_classifier)
from pcaudio_torch.nn import ST


@dataclasses.dataclass
class AudioClassifier:
    """Batched end-to-end classifier for the temporal 3ST model."""

    model: ST
    pipeline: TemporalPipelineConfig
    batch_size: int = 64
    buffer_len: int = 220672  # 5 s at 44.1 kHz
    use_fused_st: bool = True
    device: str = "cuda"  # raises without a card; "cpu" only when asked
    # run the kernels' plain PyTorch versions (the reference they are held
    # against) whatever the device
    plain: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()
        self._fn = make_temporal_classifier(self.model, self.pipeline,
                                            use_fused_st=self.use_fused_st,
                                            plain=self.plain)

    @classmethod
    def from_reference_checkpoint(cls, config_json: str, pth_path: str,
                                  top_k: Optional[int] = 256,
                                  **kw) -> "AudioClassifier":
        cfg = ExperimentConfig.from_reference_json(config_json)
        if cfg.architecture != ARCH_3ST:
            raise ValueError("the temporal pipeline makes 3-D clouds: it "
                             f"serves {ARCH_3ST!r} models only")
        model = cfg.build_model()
        model.load_state_dict(load_reference_pth(pth_path))
        pipe = TemporalPipelineConfig(
            fs=cfg.sampling_rate, n_fft=cfg.window_size,
            hop_factor=cfg.hop_factor, num_frames=cfg.Ntemp or 10,
            top_db=cfg.trim_dB, top_k=top_k)
        return cls(model=model, pipeline=pipe, **kw)

    def logits(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        """Classify ragged float32 clips → ``[len(clips), nclass]``."""
        outs: List[np.ndarray] = []
        for start in range(0, len(clips), self.batch_size):
            group = clips[start: start + self.batch_size]
            waves, lengths = pad_batch(group, self.buffer_len)
            n = len(group)
            if n < self.batch_size:  # pad the request to the bucket
                waves = np.pad(waves, ((0, self.batch_size - n), (0, 0)))
                lengths = np.pad(lengths, (0, self.batch_size - n),
                                 constant_values=1)
            out = self._fn(torch.from_numpy(waves).to(self.device),
                           torch.from_numpy(lengths).to(self.device))
            outs.append(out[:n].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def classify(self, clips: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(predicted_labels [N], probabilities [N, nclass])``."""
        lg = self.logits(clips)
        probs = torch.softmax(torch.from_numpy(lg), dim=-1).numpy()
        return np.argmax(lg, axis=-1), probs
