"""Kernel wrappers: each pairs a hand-written CUDA kernel with its plain
PyTorch version (used for CPU tensors only). ``library.py`` registers the
op that ``torch.export`` records in place of the attention wrapper."""
