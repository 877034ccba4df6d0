"""pcaudio_torch — the PyTorch / CUDA port of :mod:`pcaudio` for NVIDIA Hopper.

The JAX package ``pcaudio`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports neither ``jax`` nor
any module of ``pcaudio``.  The
serving path (wave → trimmed STFT |X|² chunks → exact top-K clouds → Set
Transformer → clip logits) runs through three hand-written CUDA kernels
(``pcaudio_torch/csrc``), and the FST/3ST training path through a fourth,
the trainable masked attention (forward and backward); each has a plain
PyTorch version beside it that CPU tensors take.

Subpackages and modules:
  core        PointCloud dataclass, reference config JSON round-trip
  nn          masked MAB/SAB/ISAB/PMA and the ST classifier
  dsp         trim / STFT / featurizer / temporal chunking (plain PyTorch)
  ops         point-cloud builders; the CUDA kernels' wrappers and their
              plain versions
  eval        the temporal serving pipeline
  train       the recipes, train and eval steps (with remat), the epoch
              loop
  tasks       the Set Transformer's own tasks: ModelNet40, MoG clustering,
              max-of-set regression
  utils       metrics streams and result files, parameter counts, NaN
              debugging, timing and traces
  checkpoint  weights across the stacks, training checkpoints, .pth export
  data        its own copies of the JAX package's numpy-only ESC and
              ModelNet40 loaders and synthetic corpus
  probes      timing probes of K1's design questions on the card
              (``python -m pcaudio_torch.probes <name>``)
  cli         ``python -m pcaudio_torch.cli {train,eval,plots,modelnet40,
              clustering,max-regression} ...``
"""

__version__ = "0.1.0"
