"""Kernels of the port: each module wraps one CUDA kernel of ``csrc/``
beside its plain PyTorch version. The wrapper launches the kernel for
CUDA tensors (or raises) and runs the plain version for CPU tensors."""
