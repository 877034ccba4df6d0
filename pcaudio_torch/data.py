"""Audio data for the port: the JAX package's numpy-only data modules,
imported rather than copied (they load no jax).

  load_esc_split_waves  the reference's seeded ESC-10 train/test split,
                        decoded into a padded ``[B, L]`` batch
                        (``pcaudio/data/esc.py``)
  generate_esc_corpus   the deterministic synthetic ESC-shaped WAV corpus
                        (``pcaudio/data/synthetic.py``)
  pad_batch             ragged clips → padded buffer + lengths
                        (``pcaudio/data/audio_io.py``)
"""
from pcaudio.data.audio_io import pad_batch
from pcaudio.data.esc import load_esc_split_waves
from pcaudio.data.synthetic import generate_esc_corpus

__all__ = ["load_esc_split_waves", "generate_esc_corpus", "pad_batch"]
