"""Hand-written CUDA kernels of the eval path, each beside its plain PyTorch
twin. A wrapper takes the twin only for CPU tensors; for CUDA tensors it
launches its kernel (built from ``csrc/`` on first use) or raises. Each
wrapper counts its launches in a ``launches`` attribute."""
