"""Audio data for the port: its own copies of the JAX package's numpy-only
data modules, so that nothing of ``pcaudio`` is imported.

  load_esc_split_waves  the reference's seeded ESC-10 train/test split,
                        decoded into a padded ``[B, L]`` batch (``esc.py``)
  generate_esc_corpus   the deterministic synthetic ESC-shaped WAV corpus
                        (``synthetic.py``)
  pad_batch             ragged clips → padded buffer + lengths
                        (``audio_io.py``)
  ModelNet40Fetcher     ModelNet40 train/test batches from the h5 dump or
                        arrays in memory (``modelnet40.py``)
"""
from pcaudio_torch.data.audio_io import pad_batch
from pcaudio_torch.data.esc import load_esc_split_waves
from pcaudio_torch.data.modelnet40 import ModelNet40Fetcher
from pcaudio_torch.data.synthetic import generate_esc_corpus

__all__ = ["load_esc_split_waves", "generate_esc_corpus", "pad_batch",
           "ModelNet40Fetcher"]
