"""Hand-written CUDA kernels of the eval and training paths, each beside its
plain PyTorch twin; the backward kernels run inside autograd Functions around
the forward ones. A wrapper takes the twin only for CPU tensors; for CUDA
tensors it launches its kernel (built from ``csrc/`` on first use) or raises.
Each wrapper counts its launches in a ``launches`` attribute."""
