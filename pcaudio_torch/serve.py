"""Batched wave → class serving (counterpart of ``pcaudio/serve.py``).

Requests are padded to a fixed batch bucket: padded slots get length 1 and
are sliced off, so every call runs the same shapes.  The classifier serves
the temporal 3ST (a ``TemporalPipelineConfig``) and the Audio Spectrogram
Transformer (an ``AST`` with a ``SpectrogramPipelineConfig``, port-only):
it dispatches on the pipeline config's type.

    clf = AudioClassifier.from_reference_checkpoint(cfg_json, pth, device="cuda")
    labels, probs = clf.classify(list_of_float32_clips)
    labels, probs = clf.classify_paths(list_of_wav_paths)
"""
from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from pcaudio_torch.checkpoint import CONFIG_FILE, load_checkpoint, load_reference_pth
from pcaudio_torch.core.config import ARCH_3ST, ExperimentConfig
from pcaudio_torch.core.device import resolve_device
from pcaudio_torch.data import pad_batch
from pcaudio_torch.data.audio_io import load_wav_batch
from pcaudio_torch.eval.pipeline import (
    SpectrogramPipelineConfig, TemporalPipelineConfig,
    make_spectrogram_classifier, make_temporal_classifier)


def _served_config(cfg: ExperimentConfig, top_k: Optional[int]
                   ) -> TemporalPipelineConfig:
    if cfg.architecture != ARCH_3ST:
        raise ValueError("the temporal pipeline makes 3-D clouds: it "
                         f"serves {ARCH_3ST!r} models only")
    return TemporalPipelineConfig(
        fs=cfg.sampling_rate, n_fft=cfg.window_size,
        hop_factor=cfg.hop_factor, num_frames=cfg.Ntemp or 10,
        top_db=cfg.trim_dB, top_k=top_k)


@dataclasses.dataclass
class AudioClassifier:
    """Batched end-to-end classifier for the temporal 3ST model, or for an
    ``AST`` given a ``SpectrogramPipelineConfig`` (then give ``buffer_len``
    in samples at its 16 kHz, 160,000 for 10 s clips; ``use_fused_st``
    plays no part, and attention runs through kernel K5 unless ``plain``)."""

    model: nn.Module
    pipeline: Union[TemporalPipelineConfig, SpectrogramPipelineConfig]
    batch_size: int = 64
    buffer_len: int = 220672  # 5 s at 44.1 kHz
    use_fused_st: bool = True
    device: str = "cuda"  # raises without a card; "cpu" only when asked
    # run the kernels' plain PyTorch versions (the reference they are held
    # against) whatever the device
    plain: bool = False
    # host staging and host-to-device type of classify_paths: "int16" ships
    # raw PCM16 and divides by 32768 on the device (half the bytes; bit-exact
    # for 16-bit PCM sources, round-clamped to 2^-16 for wider or float ones)
    wave_dtype: str = "float32"

    # batches whose logits are awaited at once; the ring holds two slots
    # more (the batch being dispatched and one decoded ahead)
    MAX_IN_FLIGHT = 4

    def __post_init__(self):
        if self.wave_dtype not in ("float32", "int16"):
            raise ValueError(f"wave_dtype must be float32 or int16, not "
                             f"{self.wave_dtype!r}")
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()
        if isinstance(self.pipeline, SpectrogramPipelineConfig):
            self._fn = make_spectrogram_classifier(self.model, self.pipeline,
                                                   plain=self.plain)
        else:
            self._fn = make_temporal_classifier(self.model, self.pipeline,
                                                use_fused_st=self.use_fused_st,
                                                plain=self.plain)
        self._pf = None
        self._copy_stream = None

    @classmethod
    def from_reference_checkpoint(cls, config_json: str, pth_path: str,
                                  top_k: Optional[int] = 256,
                                  **kw) -> "AudioClassifier":
        cfg = ExperimentConfig.from_reference_json(config_json)
        pipe = _served_config(cfg, top_k)
        model = cfg.build_model()
        model.load_state_dict(load_reference_pth(pth_path))
        return cls(model=model, pipeline=pipe, **kw)

    @classmethod
    def from_checkpoint(cls, directory: str, top_k: Optional[int] = 256,
                        **kw) -> "AudioClassifier":
        """Serve the latest training checkpoint ``step_*.pt`` in
        ``directory`` with its ``reference_config.json`` (what ``cli
        train`` writes); the counterpart of ``from_orbax``."""
        cfg = ExperimentConfig.from_reference_json(
            os.path.join(directory, CONFIG_FILE))
        pipe = _served_config(cfg, top_k)
        tree, _ = load_checkpoint(directory)
        model = cfg.build_model()
        model.load_state_dict(tree["model"])
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
        return self._labels(self.logits(clips))

    @staticmethod
    def _labels(lg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        probs = torch.softmax(torch.from_numpy(lg), dim=-1).numpy()
        return np.argmax(lg, axis=-1), probs

    def classify_paths(self, paths: Sequence[str]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode WAV files and classify them; returns ``(labels [N],
        probabilities [N, nclass])`` (:meth:`logits_paths`)."""
        return self._labels(self.logits_paths(paths))

    def logits_paths(self, paths: Sequence[str]) -> np.ndarray:
        """Decode WAV files and classify them, host decode of upcoming
        batches overlapping the device's work → ``[len(paths), nclass]``.

        Decode runs in the native ring loader (:mod:`pcaudio_torch.native`),
        whose slots are pinned on a CUDA device: each batch goes from its
        slot to the card by a non-blocking copy on a copy stream of its own,
        so the copy of batch i+1 overlaps the compute of batch i, and a slot
        is released once an event says its copy has completed.  On a CUDA
        device the native loader is required (``RuntimeError`` when it does
        not build); on the CPU a Python producer thread takes over when it
        does not build."""
        from pcaudio_torch import native

        if self.device.type == "cuda" or native.available():
            return self._classify_native(paths)
        return self._classify_python(paths)

    def _loader(self):
        """The ring loader, created once and reused: its slots are the
        only large host buffers of the ingest path, so they are allocated
        (and pinned) once.  Each classify_paths call drains all it
        submits, so reuse needs no reset."""
        from pcaudio_torch.native import PrefetchingLoader

        if self._pf is None:
            self._pf = PrefetchingLoader(
                self.buffer_len, self.batch_size, depth=self.MAX_IN_FLIGHT + 2,
                dtype=self.wave_dtype, pin_memory=self.device.type == "cuda")
        return self._pf

    def close(self) -> None:
        """Stop the ring loader's threads and free its slots."""
        if self._pf is not None:
            self._pf.close()
            self._pf = None

    def _classify_native(self, paths: Sequence[str]) -> np.ndarray:
        groups = [list(paths[i: i + self.batch_size])
                  for i in range(0, len(paths), self.batch_size)]
        pf = self._loader()
        cuda = self.device.type == "cuda"
        if cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
        submitted = min(pf.depth, len(groups))
        for group in groups[:submitted]:
            pf.submit(group)
        held = collections.deque()    # per acquired slot: its copy's event
        window = collections.deque()  # (logits, n) of the batches in flight
        done: List[np.ndarray] = []
        try:
            for _ in groups:
                waves, lengths, n = pf.acquire()
                lengths.clamp_(min=1)  # padded rows
                if cuda:
                    with torch.cuda.stream(self._copy_stream):
                        dw = waves.to(self.device, non_blocking=True)
                        dl = lengths.to(self.device, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record()
                    compute.wait_event(copied)
                    # made on the copy stream, read on the compute stream
                    dw.record_stream(compute)
                    dl.record_stream(compute)
                else:  # the CPU reads the slot while _fn runs
                    dw, dl, copied = waves, lengths, None
                if len(window) >= self.MAX_IN_FLIGHT:
                    out, m = window.popleft()
                    done.append(out[:m].cpu().numpy())
                window.append((self._fn(dw, dl), n))
                held.append(copied)
                # a slot goes back to the decoder only once its copy has
                # completed on the card, oldest first
                while held and (held[0] is None or held[0].query()):
                    held.popleft()
                    pf.release()
                if submitted < len(groups):
                    pf.submit(groups[submitted])
                    submitted += 1
            done.extend(out[:m].cpu().numpy() for out, m in window)
            for _ in held:
                pf.release()
        except BaseException:
            # the ring holds work of this call: drop it, once no copy reads
            # its slots any more
            if cuda:
                self._copy_stream.synchronize()
            self.close()
            raise
        return np.concatenate(done, axis=0)

    def _classify_python(self, paths: Sequence[str]) -> np.ndarray:
        window = collections.deque()
        done: List[np.ndarray] = []
        for waves, lengths, n in self._python_batches(paths):
            dw = torch.from_numpy(waves).to(self.device)
            dl = torch.from_numpy(lengths).to(self.device)
            if len(window) >= self.MAX_IN_FLIGHT:
                out, m = window.popleft()
                done.append(out[:m].cpu().numpy())
            window.append((self._fn(dw, dl), n))
        done.extend(out[:m].cpu().numpy() for out, m in window)
        return np.concatenate(done, axis=0)

    def _python_batches(self, paths: Sequence[str]):
        """Without the native loader: one Python producer thread decoding
        with the Python decoder, a batch ahead."""
        q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            try:
                for i in range(0, len(paths), self.batch_size):
                    group = paths[i: i + self.batch_size]
                    waves, lengths = load_wav_batch(group, self.buffer_len,
                                                    use_native="never")
                    n = len(group)
                    if n < self.batch_size:
                        waves = np.pad(waves, ((0, self.batch_size - n), (0, 0)))
                        lengths = np.pad(lengths, (0, self.batch_size - n),
                                         constant_values=1)
                    q.put((waves, lengths, n))
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                t.join()
                raise item
            yield item
        t.join()
