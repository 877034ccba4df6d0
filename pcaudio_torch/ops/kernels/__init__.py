"""Hand-written CUDA kernels of the serving and training paths, each beside
its plain PyTorch version.  A wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches its kernel (counted in
``<wrapper>.launches``) or raises."""
