"""Hopper kernels (CUDA C++ under csrc/) with plain PyTorch versions beside them."""
