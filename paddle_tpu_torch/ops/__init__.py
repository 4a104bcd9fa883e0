"""Kernel wrappers: each pairs a hand-written CUDA kernel with its plain
PyTorch version (used for CPU tensors only)."""
