"""Products and norms (counterparts of those in
``paddle_tpu/tensor/linalg.py``), ``matmul`` / ``bmm`` / ``mv`` on the AMP
white list. The decompositions and solvers are still to be ported (ROADMAP
A.9b)."""
from __future__ import annotations

import math

import torch

from ..framework.op import amp_op


@amp_op("matmul", "white")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@amp_op("bmm", "white")
def bmm(x, y, name=None):
    return torch.bmm(x, y)


@amp_op("mv", "white")
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


def mm(input, mat2, name=None):
    """Alias of matmul."""
    return matmul(input, mat2)


@amp_op("dot")
def dot(x, y, name=None):
    """The dot product along the last axis (row by row for 2-D)."""
    return torch.sum(x * y, dim=-1)


@amp_op("vecdot")
def vecdot(x, y, axis=-1, name=None):
    return torch.sum(x * y, dim=axis)


@amp_op("cross")
def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (default: the first of size 3)."""
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def _pnorm(v, p, dims, keepdim):
    """The entrywise ``p``-norm of ``v`` over ``dims``."""
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(v), dim=dims,
                                    keepdim=keepdim))
    if p == math.inf:
        return torch.amax(torch.abs(v), dim=dims, keepdim=keepdim)
    if p == -math.inf:
        return torch.amin(torch.abs(v), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((v != 0).to(v.dtype), dim=dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(v), p), dim=dims,
                               keepdim=keepdim), 1.0 / p)


@amp_op("norm_op")
def _norm(x, p, axis, keepdim):
    if axis is None:
        return _pnorm(x.reshape(-1), p, 0, keepdim)
    return _pnorm(x, p, axis, keepdim)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The entrywise ``p``-norm over ``axis`` (an int or a tuple; all of
    ``x`` when None); ``p`` ``"fro"``, a number, ``inf`` or ``-inf``."""
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = int(axis)
    return _norm(x, p=p, axis=axis, keepdim=bool(keepdim))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


@amp_op("matrix_norm_op")
def matrix_norm_op(x, p, axis, keepdim):
    return torch.linalg.matrix_norm(x, ord=p, dim=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """The matrix norm ``p`` (``"fro"``, ``"nuc"``, ``1``, ``-1``,
    ``2``, ``-2``, ``inf``, ``-inf``) of the planes ``axis``."""
    return matrix_norm_op(x, p=p, axis=tuple(axis), keepdim=bool(keepdim))


@amp_op("dist")
def dist(x, y, p=2, name=None):
    """The ``p``-norm of ``x - y``."""
    return _pnorm((x - y).reshape(-1), p, 0, False)


@amp_op("multi_dot_op")
def _multi_dot_op(xs):
    return torch.linalg.multi_dot(xs)


def multi_dot(x, name=None):
    return _multi_dot_op(list(x))


@amp_op("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, int(n))


@amp_op("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise ``p``-norm distances of the rows of ``x`` ``[.., n, d]``
    and ``y`` ``[.., m, d]``, ``[.., n, m]``; at ``p = 2`` through the
    product form ``|a|^2 + |b|^2 - 2ab``, as the reference."""
    if p == 2.0 and not str(compute_mode).startswith("donot"):
        x2 = torch.sum(x * x, dim=-1)[..., :, None]
        y2 = torch.sum(y * y, dim=-1)[..., None, :]
        xy = torch.matmul(x, y.transpose(-1, -2))
        return torch.sqrt(torch.clamp(x2 + y2 - 2 * xy, min=0.0))
    d = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == 0:
        return torch.sum((d != 0).to(x.dtype), dim=-1)
    if math.isinf(p):
        return torch.amax(d, dim=-1)
    return torch.pow(torch.sum(torch.pow(d, p), dim=-1), 1.0 / p)


@amp_op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """The covariance of the variables in ``x``'s rows (its columns
    without ``rowvar``)."""
    return torch.cov(x if rowvar or x.dim() < 2 else x.T,
                     correction=int(bool(ddof)), fweights=fweights,
                     aweights=aweights)


@amp_op("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar or x.dim() < 2 else x.T)


__all__ = ["bmm", "cdist", "corrcoef", "cov", "cross", "dist", "dot",
           "matmul", "matrix_norm", "matrix_norm_op", "matrix_power", "mm",
           "multi_dot", "mv", "norm", "vecdot", "vector_norm"]
