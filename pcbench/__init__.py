"""The benchmark of ``pcaudio_torch`` on one NVIDIA H100: run a cell with
``python -m pcbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` (``run.py``).  Nothing here imports ``jax`` or the JAX package
``pcaudio``, and ``reference/`` imports nothing of ``pcaudio_torch``."""
