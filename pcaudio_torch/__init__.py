"""pcaudio_torch — the PyTorch / CUDA port of :mod:`pcaudio` for NVIDIA Hopper.

The JAX package ``pcaudio`` is the reference; this package keeps its module
names so each counterpart is easy to find, and never imports ``jax``.  The
serving path (wave → trimmed STFT |X|² chunks → exact top-K clouds → Set
Transformer → clip logits) runs through three hand-written CUDA kernels
(``pcaudio_torch/csrc``), each with a plain PyTorch version beside it that
CPU tensors take.

Subpackages:
  core        PointCloud dataclass, reference config JSON reader
  nn          masked MAB/SAB/ISAB/PMA and the ST classifier
  dsp         trim / STFT / temporal chunking (plain PyTorch)
  ops         the CUDA kernels' wrappers and their plain versions
  eval        the temporal serving pipeline
"""

__version__ = "0.1.0"
