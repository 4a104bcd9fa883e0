"""Shape, layout, indexing and sorting ops (counterparts of
``paddle_tpu/tensor/manipulation.py``), under the reference's op names.
They return views where torch can.

Paddle's semantics hold where torch's same-named calls differ: ``split``
takes a count of parts (or sizes, one of them -1), ``gather`` selects
slices by index along an axis, ``squeeze`` leaves an axis that is not 1,
``expand`` keeps an axis at -1, ``where(cond)`` is ``nonzero``, and
``argsort(descending=True)`` is the ascending order reversed. An in-place
``*_`` op writes the out-of-place result back into its input."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.op import amp_op
from .creation import _shape


def _rebind(x, out):
    """``x`` made to hold ``out`` (an in-place op's result, copied in
    where autograd can follow it); a new shape or dtype replaces ``x``'s
    data."""
    if out.shape == x.shape and out.dtype == x.dtype:
        return x.copy_(out)
    x.data = out.detach()
    return x


def _axis(axis):
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def _index(index, device):
    return torch.as_tensor(index, device=device).long()


@amp_op("reshape_op")
def reshape(x, shape, name=None):
    return x.reshape(tuple(shape))


def reshape_(x, shape, name=None):
    return _rebind(x, reshape(x, _shape(shape)))


@amp_op("transpose_op")
def transpose(x, perm, name=None):
    return x.permute(*perm)


def t(x, name=None):
    """The transpose of a matrix (a vector as given)."""
    if x.dim() < 2:
        return x
    if x.dim() == 2:
        return transpose(x, (1, 0))
    raise ValueError("t only supports tensors with ndim <= 2; use transpose")


def permute(x, *perm, name=None):
    if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
        perm = tuple(perm[0])
    return transpose(x, [int(p) for p in perm])


@amp_op("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2, name=None):
    perm = list(range(x.dim()))
    perm[axis1], perm[axis2] = perm[axis2], perm[axis1]
    return transpose(x, perm)


swapdims = swapaxes


@amp_op("matrix_transpose")
def matrix_transpose(x, name=None):
    """The last two axes swapped."""
    if x.dim() < 2:
        raise ValueError("matrix_transpose needs at least 2 dims")
    return x.transpose(-1, -2)


@amp_op("flatten_op")
def _flatten(x, start_axis, stop_axis):
    return x.flatten(start_axis, stop_axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis`` .. ``stop_axis`` of ``x`` merged into one."""
    return _flatten(x, int(start_axis), int(stop_axis))


@amp_op("unflatten")
def unflatten(x, axis, shape, name=None):
    """Axis ``axis`` split into ``shape`` (one -1 inferred)."""
    return torch.unflatten(x, int(axis), tuple(int(s) for s in shape))


@amp_op("squeeze_op")
def _squeeze(x, axis):
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(a for a in axis if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


def squeeze(x, axis=None, name=None):
    """``x`` without the axes of size 1 among ``axis`` (all when None);
    an axis of another size stays."""
    if axis is not None:
        axis = (int(axis),) if isinstance(axis, (int, np.integer)) \
            else tuple(int(a) for a in axis)
    return _squeeze(x, axis=axis)


def squeeze_(x, axis=None, name=None):
    return _rebind(x, squeeze(x, axis))


@amp_op("unsqueeze_op")
def _unsqueeze(x, axis):
    for a in sorted(axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    """New axes of size 1 at ``axis`` (inserted in ascending order)."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (int, np.integer)):
        axis = [int(axis)]
    return _unsqueeze(x, axis=tuple(int(a) for a in axis))


def unsqueeze_(x, axis, name=None):
    return _rebind(x, unsqueeze(x, axis))


@amp_op("concat_op")
def _concat(xs, axis):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0, name=None):
    return _concat(list(x), axis=_axis(axis))


def cat(x, axis=0, name=None):
    return concat(x, axis)


@amp_op("stack_op")
def _stack(xs, axis):
    return torch.stack(xs, dim=axis)


def stack(x, axis=0, name=None):
    return _stack(list(x), axis=int(axis))


@amp_op("hstack_op")
def _hstack_op(xs):
    return torch.hstack(xs)


def hstack(x, name=None):
    return _hstack_op(list(x))


@amp_op("dstack_op")
def _dstack_op(xs):
    return torch.dstack(xs)


def dstack(x, name=None):
    return _dstack_op(list(x))


@amp_op("row_stack_op")
def _row_stack_op(xs):
    return torch.vstack(xs)


def row_stack(x, name=None):
    return _row_stack_op(list(x))


vstack = row_stack


@amp_op("column_stack_op")
def _column_stack_op(xs):
    return torch.column_stack(xs)


def column_stack(x, name=None):
    return _column_stack_op(list(x))


@amp_op("block_diag_op")
def _block_diag_op(xs):
    return torch.block_diag(*(torch.atleast_2d(v) for v in xs))


def block_diag(inputs, name=None):
    return _block_diag_op(list(inputs))


@amp_op("split_op")
def _split(x, sections, axis):
    return tuple(torch.split(x, sections, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """``x`` cut along ``axis`` into ``num_or_sections`` equal parts (an
    int, which must divide the axis), or into parts of the sizes listed
    (one of them may be -1: the rest of the axis)."""
    axis = _axis(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, (list, tuple)):
        secs = [_axis(s) for s in num_or_sections]
        known = builtins.sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
    else:
        n = _axis(num_or_sections)
        if n <= 0 or total % n:
            raise ValueError(f"split: {n} parts do not divide axis {axis} "
                             f"of size {total}")
        secs = [total // n] * n
    return list(_split(x, sections=secs, axis=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def _numpy_split(x, num_or_indices, axis):
    """numpy's ``split``: an int must divide the axis; a list gives the
    cut points."""
    if isinstance(num_or_indices, int) and x.shape[axis] % num_or_indices:
        raise ValueError(f"{num_or_indices} parts do not divide axis "
                         f"{axis} of size {x.shape[axis]}")
    return list(torch.tensor_split(x, num_or_indices if isinstance(
        num_or_indices, int) else list(num_or_indices), dim=axis))


def vsplit(x, num_or_indices, name=None):
    return _numpy_split(x, num_or_indices, 0)


def hsplit(x, num_or_indices, name=None):
    return _numpy_split(x, num_or_indices, 0 if x.dim() == 1 else 1)


def dsplit(x, num_or_indices, name=None):
    return _numpy_split(x, num_or_indices, 2)


def tensor_split(x, num_or_indices, axis=0, name=None):
    """numpy's ``array_split``: an int that does not divide the axis gives
    the first parts one longer."""
    return list(torch.tensor_split(
        x, num_or_indices if isinstance(num_or_indices, int)
        else list(num_or_indices), dim=int(axis)))


def unbind(x, axis=0, name=None):
    """The slices of ``x`` along ``axis``, that axis dropped."""
    axis = int(axis)
    return [squeeze(part, axis) for part in split(x, x.shape[axis], axis)]


unstack = unbind


@amp_op("tile_op")
def _tile(x, repeat_times):
    return torch.tile(x, repeat_times)


def tile(x, repeat_times, name=None):
    return _tile(x, repeat_times=_shape(repeat_times))


@amp_op("expand_op")
def _expand(x, shape):
    lead = len(shape) - x.dim()
    shape = tuple(x.shape[i - lead] if s == -1 and i >= lead else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape``; a -1 keeps that axis of ``x``."""
    return _expand(x, shape=_shape(shape))


def expand_as(x, y, name=None):
    return _expand(x, shape=tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return _expand(x, shape=_shape(shape))


def broadcast_tensors(inputs, name=None):
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in inputs)))
    return [_expand(t, shape=shape) for t in inputs]


@amp_op("flip")
def flip(x, axis, name=None):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


reverse = flip


@amp_op("roll")
def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, dims=axis)


@amp_op("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


@amp_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    return x.repeat_interleave(repeats, dim=axis)


# -- gather / scatter ---------------------------------------------------------


@amp_op("gather")
def gather(x, index, axis=0, name=None):
    """The slices of ``x`` at ``index`` along ``axis`` (numpy's ``take``:
    ``index``'s shape replaces that axis)."""
    axis = _axis(axis) % x.dim()
    index = _index(index, x.device)
    if index.dim() == 0:
        index = index[None]
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


@amp_op("gather_nd")
def gather_nd(x, index, name=None):
    """``x`` at the coordinates in ``index``'s last axis."""
    return x[tuple(_index(index, x.device).movedim(-1, 0))]


@amp_op("take_along_axis")
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    indices = _index(indices, arr.device)
    if broadcast:
        shape = list(arr.shape)
        shape[axis] = indices.shape[axis]
        indices = torch.broadcast_to(indices, shape)
    return torch.gather(arr, axis, indices)


@amp_op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr`` with ``values`` written at ``indices`` along ``axis``
    (``reduce`` ``"assign"``, ``"add"`` / ``"sum"`` or ``"mul"`` /
    ``"multiply"``)."""
    indices = _index(indices, arr.device)
    values = torch.broadcast_to(
        torch.as_tensor(values, dtype=arr.dtype, device=arr.device),
        indices.shape)
    if reduce == "assign":
        return arr.scatter(axis, indices, values)
    if reduce in ("add", "sum"):
        return arr.scatter_add(axis, indices, values)
    if reduce in ("mul", "multiply"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(f"unsupported reduce mode {reduce}")


@amp_op("index_select")
def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, int(axis), _index(index, x.device))


@amp_op("index_sample")
def index_sample(x, index):
    """Row ``i`` of the result: ``x[i]`` at ``index[i]``."""
    return torch.gather(x, 1, _index(index, x.device))


@amp_op("index_add")
def index_add(x, index, axis, value, name=None):
    return x.index_add(int(axis), _index(index, x.device), value)


@amp_op("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(_index(i, x.device) for i in indices)
    return x.index_put(idx, torch.as_tensor(value, dtype=x.dtype,
                                            device=x.device), accumulate)


@amp_op("index_fill_op")
def _index_fill(x, index, axis, value):
    return x.index_fill(axis, _index(index, x.device), value)


def index_fill(x, index, axis, value, name=None):
    return _index_fill(x, index, axis=int(axis), value=value)


def index_fill_(x, index, axis, value, name=None):
    return _rebind(x, index_fill(x, index, axis, value))


@amp_op("scatter_op")
def scatter_op(x, index, updates, overwrite=True):
    index = _index(index, x.device)
    if index.dim() == 2:
        index = index[:, 0]
    if overwrite:
        return x.index_put((index,), updates)
    # accumulate into the rows, zeroed first (Paddle's overwrite=False)
    zeroed = x.index_put((index,), torch.zeros_like(updates))
    return zeroed.index_put((index,), updates, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with rows ``index`` replaced by ``updates`` (``overwrite``)
    or set to the sum of the updates aimed at them."""
    return scatter_op(x, index, updates, overwrite=overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _rebind(x, scatter(x, index, updates, overwrite))


@amp_op("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    idx = tuple(_index(index, x.device).movedim(-1, 0))
    return x.index_put(idx, updates, accumulate=True)


@amp_op("scatter_nd")
def scatter_nd(index, updates, shape, name=None):
    """``updates`` added at ``index`` into zeros of ``shape``."""
    out = torch.zeros(_shape(shape), dtype=updates.dtype,
                      device=updates.device)
    idx = tuple(_index(index, updates.device).movedim(-1, 0))
    return out.index_put(idx, updates, accumulate=True)


@amp_op("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values, int(axis), int(index))


@amp_op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    """``x`` with ``value`` written into its strided slice."""
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(int(st), int(en), int(sr))
    out = x.clone()
    out[tuple(idx)] = value
    return out


@amp_op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(x, y, int(offset), int(axis1), int(axis2))


@amp_op("masked_scatter")
def masked_scatter(x, mask, value, name=None):
    """``x`` with its elements under ``mask`` taken, in order, from
    ``value``."""
    return x.masked_scatter(torch.broadcast_to(mask, x.shape), value)


@amp_op("where_op")
def where_op(condition, x, y):
    return torch.where(condition, x, y)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; ``where(condition)``
    alone is ``nonzero(condition, as_tuple=True)``."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return where_op(condition, x, y)


def where_(condition, x=None, y=None, name=None):
    return _rebind(x, where_op(condition, x, y))


@amp_op("masked_fill")
def masked_fill(x, mask, value, name=None):
    return x.masked_fill(mask, value)


def masked_fill_(x, mask, value, name=None):
    return _rebind(x, masked_fill(x, mask, value))


def nonzero(x, as_tuple=False, name=None):
    """The int64 coordinates of ``x``'s nonzero elements, ``[N, ndim]``,
    or one 1-D tensor per axis with ``as_tuple``."""
    return torch.nonzero(x, as_tuple=bool(as_tuple))


def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask)


def _first_index(inverse, n):
    """For each of ``n`` groups, the first position whose ``inverse`` (a
    flat group id) names it."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n,), inverse.numel(), dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted distinct values (slices along ``axis``) of ``x``, and as
    asked the first index of each, the inverse map and the counts, in
    numpy's order; the index outputs are ``dtype``."""
    dt = convert_dtype(dtype)
    src = x.reshape(-1) if axis is None else x
    out, inverse, counts = torch.unique(src, sorted=True, return_inverse=True,
                                        return_counts=True, dim=axis)
    extra = []
    if return_index:
        extra.append(_first_index(inverse, len(counts)).to(dt))
    if return_inverse:
        extra.append(inverse.to(dt))
    if return_counts:
        extra.append(counts.to(dt))
    return (out, *extra) if extra else out


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """``x`` (flattened when ``axis`` is None) with each run of equal
    values kept once; the inverse map and run lengths as asked."""
    src = x.reshape(-1) if axis is None else x
    out, inverse, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    dt = convert_dtype(dtype)
    extra = ([inverse.to(dt)] if return_inverse else []) + \
        ([counts.to(dt)] if return_counts else [])
    return (out, *extra) if extra else out


# -- sort, search ---------------------------------------------------------------


@amp_op("sort_op")
def _sort(x, axis, descending):
    return torch.sort(x, dim=axis, descending=descending).values


def sort(x, axis=-1, descending=False, name=None):
    return _sort(x, axis=int(axis), descending=bool(descending))


@amp_op("msort_op")
def _msort_op(x):
    return torch.sort(x, dim=0).values


def msort(x, name=None):
    return _msort_op(x)


@amp_op("argsort_op")
def _argsort(x, axis, descending):
    idx = torch.argsort(x, dim=axis, stable=True)
    return idx.flip(axis) if descending else idx


def argsort(x, axis=-1, descending=False, name=None):
    """int64 indices that sort ``x`` along ``axis``; descending is the
    stable ascending order reversed (equal values latest first)."""
    return _argsort(x, axis=int(axis), descending=bool(descending))


@amp_op("topk_op")
def _topk(x, k, axis, largest, sorted):
    return torch.topk(x, k, dim=axis, largest=largest, sorted=sorted)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """``(values, int64 indices)`` of the ``k`` largest (smallest) along
    ``axis`` (the last when None)."""
    vals, idx = _topk(x, k=_axis(k), axis=-1 if axis is None else int(axis),
                      largest=bool(largest), sorted=bool(sorted))
    return vals, idx


@amp_op("kthvalue_op")
def _kthvalue(x, k, axis, keepdim):
    return tuple(torch.kthvalue(x, k, dim=axis, keepdim=keepdim))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return _kthvalue(x, k=int(k), axis=int(axis) % x.dim(),
                     keepdim=bool(keepdim))


def mode(x, axis=-1, keepdim=False, name=None):
    """``(values, int64 indices)``: the most frequent value along ``axis``
    (the smallest of a tie) and the last position holding it, on every
    device (``torch.mode`` leaves the index it returns unspecified)."""
    axis = int(axis) % x.dim()
    moved = x.movedim(axis, -1)
    srt = torch.sort(moved, dim=-1).values
    n = srt.shape[-1]
    # run length ending at each sorted position; the first maximal run's
    # value is the smallest most frequent one
    new_run = torch.ones_like(srt, dtype=torch.bool)
    new_run[..., 1:] = srt[..., 1:] != srt[..., :-1]
    pos = torch.arange(n, device=x.device).expand_as(srt)
    start = torch.cummax(torch.where(new_run, pos, 0), dim=-1).values
    length = pos - start + 1
    best = torch.argmax(length, dim=-1, keepdim=True)
    vals = torch.gather(srt, -1, best)
    hit = (moved == vals)
    last = (n - 1 - torch.argmax(hit.flip(-1).to(torch.int8), dim=-1,
                                 keepdim=True))
    vals, last = vals.squeeze(-1), last.squeeze(-1)
    if keepdim:
        vals, last = vals.unsqueeze(axis), last.unsqueeze(axis)
    return vals, last


@amp_op("argmax_op")
def _argmax(x, axis, keepdim):
    if axis is None:
        return torch.argmax(x.reshape(-1))
    return torch.argmax(x, dim=axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _argmax(x, axis=axis if axis is None else int(axis),
                   keepdim=bool(keepdim)).to(convert_dtype(dtype))


@amp_op("argmin_op")
def _argmin(x, axis, keepdim):
    if axis is None:
        return torch.argmin(x.reshape(-1))
    return torch.argmin(x, dim=axis, keepdim=keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _argmin(x, axis=axis if axis is None else int(axis),
                   keepdim=bool(keepdim)).to(convert_dtype(dtype))


@amp_op("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


@amp_op("bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return torch.searchsorted(sorted_sequence, x, out_int32=out_int32,
                              right=right)


# -- cast, indexing, views --------------------------------------------------------


@amp_op("cast_op")
def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return _cast(x, dtype=convert_dtype(dtype))


def cast_(x, dtype):
    return _rebind(x, cast(x, dtype))


def _norm_index(idx, device):
    """An index with its lists and arrays as tensors on ``device``."""
    if isinstance(idx, tuple):
        return tuple(_norm_index(i, device) for i in idx)
    if isinstance(idx, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(idx), device=device)
    return idx


@amp_op("getitem_op")
def getitem(x, index):
    """``x[index]``."""
    return x[index]


def tensor_getitem(x, idx):
    """``x[idx]``, lists and arrays in ``idx`` read as index tensors."""
    return getitem(x, _norm_index(idx, x.device))


@amp_op("setitem_op")
def _setitem(x, value, idx):
    out = x.clone()
    out[idx] = value
    return out


def tensor_setitem(x, idx, value):
    """``x[idx] = value``, written into ``x``; returns ``x``."""
    return _rebind(x, _setitem(x, value, _norm_index(idx, x.device)))


@amp_op("pad_nd")
def pad_nd(x, pad, mode="constant", value=0.0):
    """numpy's ``pad``: ``pad`` a ``(before, after)`` pair per axis;
    ``mode`` ``"constant"`` (with ``value``), ``"edge"``, ``"reflect"``,
    ``"symmetric"`` or ``"wrap"``."""
    pad = [tuple(int(v) for v in p) for p in pad]
    if mode == "constant":
        flat = [v for b, a in reversed(pad) for v in (b, a)]
        return torch.nn.functional.pad(x, flat, value=value)
    for axis, (b, a) in enumerate(pad):
        if b or a:
            src = np.pad(np.arange(x.shape[axis]), (b, a), mode=mode)
            x = x.index_select(axis, torch.as_tensor(src, device=x.device))
    return x


def as_strided(x, shape, stride, offset=0, name=None):
    """A view of ``x``'s storage with ``shape`` and element ``stride``s
    from element ``offset``."""
    return torch.as_strided(x, tuple(shape), tuple(stride), int(offset))


@amp_op("view_op")
def view_op(x, shape):
    return x.reshape(shape)


def view(x, shape_or_dtype, name=None):
    """``x`` reshaped to a list / tuple shape, or cast to a dtype (the
    reference's reading)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return view_op(x, shape=_shape(shape_or_dtype))
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return view_op(x, shape=tuple(other.shape))


@amp_op("crop")
def crop(x, shape=None, offsets=None, name=None):
    offsets = offsets or [0] * x.dim()
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


@amp_op("shard_index")
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Ids of shard ``shard_id`` (of ``nshards`` over ``index_num``) made
    shard-local; the others ``ignore_value``."""
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    inside = (input >= lo) & (input < lo + size)
    return torch.where(inside, input - lo,
                       torch.full_like(input, ignore_value))


@amp_op("take_op")
def _take(x, index, mode):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.reshape(-1).long()
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    return flat[idx].reshape(index.shape)


def take(x, index, mode="raise", name=None):
    """``x`` flattened, at ``index``: out of range raises (``"raise"``:
    negatives count from the end), wraps or clips."""
    if mode == "raise":
        n = x.numel()
        if bool(((index >= n) | (index < -n)).any()):
            raise IndexError("take: index out of range")
        mode = "wrap"
    return _take(x, index, mode=mode)


@amp_op("unfold_op")
def _unfold(x, axis, size, step):
    return x.unfold(axis, size, step)


def unfold(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis``, as a new last
    axis."""
    return _unfold(x, axis=int(axis), size=int(size), step=int(step))


@amp_op("tensordot_op")
def _tensordot(x, y, axes):
    return torch.tensordot(x, y, dims=axes)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return _tensordot(x, y, axes=axes)


@amp_op("slice_op")
def paddle_slice(input, axes, starts, ends, name=None):
    """paddle.slice: ``input`` cut to ``[start, end)`` along each of
    ``axes`` (negative bounds count from the end; bounds are clamped)."""
    idx = [builtins.slice(None)] * input.dim()
    for ax, s, e in zip(axes, starts, ends):
        dim = input.shape[ax]
        s = int(s) + dim if int(s) < 0 else int(s)
        e = int(e) + dim if int(e) < 0 else int(e)
        idx[ax] = builtins.slice(builtins.max(s, 0), builtins.min(e, dim))
    return input[tuple(idx)]


@amp_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python's slicing per axis, negative strides included."""
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        ax = int(ax)
        pos = range(*builtins.slice(int(st), int(en), int(sd)).indices(
            x.shape[ax]))
        x = x.index_select(ax, torch.tensor(list(pos), dtype=torch.int64,
                                            device=x.device))
    return x


@amp_op("cartesian_prod_op")
def _cartesian_prod_op(xs):
    grids = torch.meshgrid(*xs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def cartesian_prod(x, name=None):
    """The cartesian product of 1-D tensors, ``[prod(lengths), n]``."""
    return _cartesian_prod_op(list(x))


def atleast_1d(*inputs, name=None):
    out = [torch.atleast_1d(v) for v in inputs]
    return out[0] if len(out) == 1 else out


def atleast_2d(*inputs, name=None):
    out = [torch.atleast_2d(v) for v in inputs]
    return out[0] if len(out) == 1 else out


def atleast_3d(*inputs, name=None):
    out = [torch.atleast_3d(v) for v in inputs]
    return out[0] if len(out) == 1 else out


@amp_op("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(input, int(offset), int(dim1), int(dim2))


@amp_op("fill_diagonal")
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``x`` with ``value`` on its ``offset`` diagonal (a tall matrix
    restarts it below, numpy's ``wrap``); at more than 2 axes, all of one
    size, on the ``[i, i, ..., i]`` diagonal."""
    if x.dim() < 2:
        raise ValueError("fill_diagonal needs at least 2 dims")
    if x.dim() > 2:
        if len(set(x.shape)) != 1:
            raise ValueError(
                "fill_diagonal on >2-D tensors requires all dims equal")
        n = x.shape[0]
        grids = torch.meshgrid(*([torch.arange(n, device=x.device)]
                                 * x.dim()), indexing="ij")
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        for g in grids[1:]:
            mask = mask & (grids[0] == g)
    else:
        h, w = x.shape
        i = torch.arange(h, device=x.device)[:, None]
        j = torch.arange(w, device=x.device)[None, :]
        if wrap and h > w and int(offset) == 0:
            mask = (i * w + j) % (w + 1) == 0
        else:
            mask = (j - i) == int(offset)
    return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)


@amp_op("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``x`` with ``y``'s last axis written along the ``offset`` diagonal
    of its ``(dim1, dim2)`` planes."""
    nd = x.dim()
    d1, d2 = int(dim1) % nd, int(dim2) % nd
    perm = [a for a in range(nd) if a not in (d1, d2)] + [d1, d2]
    inv = [perm.index(a) for a in range(nd)]
    xt = x.permute(perm)
    h, w = xt.shape[-2:]
    i = torch.arange(h, device=x.device)[:, None]
    j = torch.arange(w, device=x.device)[None, :]
    mask = (j - i) == int(offset)
    k = (i + torch.zeros_like(j)) if int(offset) >= 0 \
        else (j + torch.zeros_like(i))
    yv = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    vals = torch.index_select(yv, -1, k.clamp(0, yv.shape[-1] - 1).reshape(
        -1)).reshape(yv.shape[:-1] + k.shape)
    return torch.where(mask, vals, xt).permute(inv)


@amp_op("multiplex")
def multiplex(inputs, index, name=None):
    """Row ``r``: row ``r`` of ``inputs[index[r]]``."""
    stacked = torch.stack(list(inputs), dim=0)
    idx = _index(index, stacked.device).reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


__all__ = [
    "as_strided", "atleast_1d", "atleast_2d", "atleast_3d", "argmax",
    "argmin", "argsort", "block_diag", "broadcast_tensors", "broadcast_to",
    "bucketize", "cartesian_prod", "cast", "cast_", "cat", "chunk",
    "column_stack", "concat", "crop", "diag_embed", "diagonal_scatter",
    "dsplit", "dstack", "expand", "expand_as", "fill_diagonal",
    "fill_diagonal_tensor", "flatten", "flip", "gather", "gather_nd",
    "getitem", "hsplit", "hstack", "index_add", "index_fill", "index_fill_",
    "index_put", "index_sample", "index_select", "kthvalue", "masked_fill",
    "masked_fill_", "masked_scatter", "masked_select", "matrix_transpose",
    "mode", "moveaxis", "msort", "multiplex", "nonzero", "pad_nd",
    "paddle_slice", "permute", "put_along_axis", "repeat_interleave",
    "reshape", "reshape_", "reverse", "roll", "rot90", "row_stack",
    "scatter", "scatter_", "scatter_nd", "scatter_nd_add", "scatter_op",
    "searchsorted", "select_scatter", "shard_index", "slice_scatter", "sort",
    "split", "squeeze", "squeeze_", "stack", "strided_slice", "swapaxes",
    "swapdims", "t", "take", "take_along_axis", "tensor_getitem",
    "tensor_setitem", "tensor_split", "tensordot", "tile", "topk",
    "transpose", "unbind", "unflatten", "unfold", "unique",
    "unique_consecutive", "unsqueeze", "unsqueeze_", "unstack", "view",
    "view_as", "view_op", "vsplit", "vstack", "where", "where_", "where_op"]
