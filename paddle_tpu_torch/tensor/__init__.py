"""Tensor ops of the port that the models call where the reference calls
its own (``paddle_tpu/tensor/``), so that ``auto_cast`` casts their
inputs as the reference's gateway does (``framework/op.py``)."""
from .linalg import bmm, matmul
from .manipulation import (flatten, getitem, repeat_interleave, reshape, t,
                           transpose)
from .math import add, clip, divide, exp, log, mean, multiply, sum

__all__ = ["add", "bmm", "clip", "divide", "exp", "flatten", "getitem",
           "log", "matmul", "mean", "multiply", "repeat_interleave",
           "reshape", "sum", "t", "transpose"]
