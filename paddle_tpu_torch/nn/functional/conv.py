"""Convolution and pooling functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``).

The reference computes these with XLA ops (``lax.conv_general_dilated``,
``lax.reduce_window``), not with a Pallas kernel, so the port calls
torch's convolutions and pools (cuDNN on the card) under Paddle's rules,
which differ from torch's defaults:

- padding: ``"SAME"`` pads asymmetrically with the extra on the right,
  at any stride; a list of ``2 * nsp`` values is per side; a nested list
  keeps its last ``nsp`` pairs (for 2-D too, where the reference misreads
  it). Asymmetric pads are applied with
  ``F.pad`` before an unpadded torch call;
- NHWC / NDHWC (``data_format`` ending in ``C``) transposes around the
  channel-first op, as the reference does;
- transposed convolutions take the weight ``[in, out / groups, *k]``
  (torch's layout too); ``output_padding`` adds on the right and
  ``output_size`` slices the result;
- pools: ``ceil_mode`` always adds ``(stride - rem) % stride`` of right
  padding (torch drops a last window that starts in the padding); max
  pools pad with ``-inf``; ``exclusive=True`` divides each window's sum by
  its count of real cells, ceil extra included, ``exclusive=False`` by
  ``prod(kernel_size)``. Where the final pads are symmetric and at most
  half the window, torch's own padding computes the same windows and is
  used; otherwise the input is padded explicitly and pooled unpadded;
- ``return_mask`` gives each window's argmax as a flat index into the
  unpadded spatial dims, the first maximum on ties.

The convolutions are on the AMP white list under their reference names;
the pools are on neither list, so they cast at O2 only.

Not ported yet (ROADMAP.md §A.6): ``unfold``, ``max_unpool1d/2d/3d``,
``lp_pool1d/2d``. Refused where the reference ignores an argument
(ROADMAP.md §C): ``avg_pool2d/3d``'s ``divisor_override``, the adaptive
max pools' ``return_mask``, ``adaptive_avg_pool3d``'s ``NDHWC``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...framework.op import amp_op

__all__ = [
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "conv1d", "conv1d_transpose",
    "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "max_pool1d", "max_pool2d", "max_pool3d",
]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _conv_padding(padding, nsp, stride, ksize, dilation, in_shape):
    """Paddle's padding spec as ``[(lo, hi)]`` per spatial dim."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * nsp
        if p == "SAME":
            pads = []
            for i in range(nsp):
                out = -(-in_shape[i] // stride[i])
                eff_k = (ksize[i] - 1) * dilation[i] + 1
                total = max(0, (out - 1) * stride[i] + eff_k - in_shape[i])
                pads.append((total // 2, total - total // 2))
            return pads
        raise ValueError(f"bad padding {padding}")
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        # an NCHW-style nested list: the spatial pairs are the last nsp
        # (taken before the per-side form, which the reference tries
        # first and so misreads a 2-D nested list: ROADMAP.md §C.16)
        return [tuple(int(v) for v in p) for p in padding[-nsp:]]
    if len(padding) == nsp:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nsp:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nsp)]
    raise ValueError(f"bad padding {padding}")


def _pad_arg(pads):
    """``[(lo, hi)]`` per spatial dim as ``F.pad``'s last-dim-first list."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _symmetric(pads):
    return all(lo == hi for lo, hi in pads)


def _channel_first(x, data_format):
    return x.movedim(-1, 1) if data_format[-1] == "C" else x


def _channel_back(out, data_format):
    return out.movedim(1, -1) if data_format[-1] == "C" else out


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nsp,
             data_format):
    x = _channel_first(x, data_format)
    stride = _tuple(stride, nsp)
    dilation = _tuple(dilation, nsp)
    pads = _conv_padding(padding, nsp, stride, weight.shape[2:], dilation,
                         x.shape[2:])
    if _symmetric(pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        x = tF.pad(x, _pad_arg(pads))
        pad = 0
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    conv = getattr(tF, f"conv{nsp}d")
    out = conv(x, weight, bias, stride, pad, dilation, groups)
    return _channel_back(out, data_format)


@amp_op("conv1d", "white")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


@amp_op("conv2d", "white")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


@amp_op("conv3d", "white")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nsp, data_format, output_size):
    x = _channel_first(x, data_format)
    stride = _tuple(stride, nsp)
    dilation = _tuple(dilation, nsp)
    ksize = weight.shape[2:]
    pads = _conv_padding(padding, nsp, stride, ksize, dilation, x.shape[2:])
    opad = _tuple(output_padding, nsp) if output_padding else (0,) * nsp
    weight = weight.to(x.dtype)
    convt = getattr(tF, f"conv_transpose{nsp}d")
    if _symmetric(pads) and all(o < max(s, d) for o, s, d
                                in zip(opad, stride, dilation)):
        # torch's own padding and output_padding give the same sizes
        out = convt(x, weight, None, stride, tuple(lo for lo, _ in pads),
                    opad, groups, dilation)
    else:
        # the full transposed conv over [lo, len - hi + output_padding):
        # cells past its end are zeros (no input reaches them)
        out = convt(x, weight, None, stride, 0, 0, groups, dilation)
        extra = [max(0, o - hi) for o, (_, hi) in zip(opad, pads)]
        if any(extra):
            out = tF.pad(out, [v for e in reversed(extra) for v in (0, e)])
        crop = tuple(slice(lo, out.shape[2 + i] - e - hi + o)
                     for i, ((lo, hi), o, e) in enumerate(zip(pads, opad,
                                                              extra)))
        out = out[(slice(None), slice(None)) + crop]
    if output_size is not None:
        tgt = _tuple(output_size, nsp)
        out = out[(slice(None), slice(None))
                  + tuple(slice(0, t) for t in tgt)]
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nsp)
    return _channel_back(out, data_format)


@amp_op("conv1d_transpose", "white")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format, output_size)


@amp_op("conv2d_transpose", "white")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format, output_size)


@amp_op("conv3d_transpose", "white")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format, output_size)


# ------------------------------------------------------------------ pooling --


def _pool_pads(x, ksize, stride, padding, nsp, ceil_mode):
    """Window, stride and final ``[(lo, hi)]`` of a pool over the
    channel-first ``x``, the ceil extra included."""
    ksize = _tuple(ksize, nsp)
    stride = _tuple(stride if stride is not None else ksize, nsp)
    pads = _conv_padding(padding, nsp, stride, ksize, (1,) * nsp,
                         x.shape[2:])
    if ceil_mode:
        new_pads = []
        for i in range(nsp):
            size = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (size - ksize[i]) % stride[i]
            extra = (stride[i] - rem) % stride[i] if rem else 0
            new_pads.append((pads[i][0], pads[i][1] + extra))
        pads = new_pads
    return ksize, stride, pads


def _native(pads, ksize):
    """Whether torch's own padding computes these windows: symmetric pads
    of at most half the window."""
    return _symmetric(pads) and all(lo <= k // 2
                                    for (lo, _), k in zip(pads, ksize))


def _flat_in_unpadded(idx, padded_shape, pads):
    """Flat indices into the padded spatial dims as flat indices into the
    unpadded ones (0 for a cell in the padding, as the reference's
    position padding gives)."""
    coords, rem = [], idx
    for n in reversed(padded_shape):
        coords.append(rem % n)
        rem = rem // n
    coords.reverse()
    flat = torch.zeros_like(idx)
    inside = torch.ones_like(idx, dtype=torch.bool)
    for c, n, (lo, hi) in zip(coords, padded_shape, pads):
        c = c - lo
        real = n - lo - hi
        inside &= (c >= 0) & (c < real)
        flat = flat * real + c
    return torch.where(inside, flat, torch.zeros_like(flat))


def _max_pool(x, kernel_size, stride, padding, nsp, return_mask, ceil_mode,
              data_format):
    if return_mask and (ceil_mode or data_format[-1] == "C"
                        or isinstance(padding, str)):
        raise NotImplementedError(
            f"max_pool{nsp}d(return_mask=True) supports channel-first "
            "data, numeric padding and ceil_mode=False (the reference's "
            "index path)")
    x = _channel_first(x, data_format)
    ksize, stride, pads = _pool_pads(x, kernel_size, stride, padding, nsp,
                                     ceil_mode)
    pool = getattr(tF, f"max_pool{nsp}d")
    if _native(pads, ksize):
        res = pool(x, ksize, stride, tuple(lo for lo, _ in pads),
                   return_indices=return_mask)
    else:
        xp = tF.pad(x, _pad_arg(pads), value=-math.inf)
        res = pool(xp, ksize, stride, 0, return_indices=return_mask)
        if return_mask:
            res = (res[0], _flat_in_unpadded(res[1], xp.shape[2:], pads))
    if return_mask:
        return res
    return _channel_back(res, data_format)


@amp_op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, 1, return_mask,
                     ceil_mode, data_format)


@amp_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, return_mask,
                     ceil_mode, data_format)


@amp_op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, return_mask,
                     ceil_mode, data_format)


def _window_sums(x, ksize, stride, nsp):
    """Each window's sum over the (already padded) channel-first ``x``."""
    if nsp == 1:  # avg_pool1d has no divisor_override: pool as 2-D
        return tF.avg_pool2d(x.unsqueeze(-2), (1,) + ksize, (1,) + stride,
                             divisor_override=1).squeeze(-2)
    pool = getattr(tF, f"avg_pool{nsp}d")
    return pool(x, ksize, stride, divisor_override=1)


def _avg_pool(x, kernel_size, stride, padding, nsp, ceil_mode, exclusive,
              data_format, divisor_override=None):
    if divisor_override is not None:
        raise NotImplementedError(
            f"avg_pool{nsp}d(divisor_override=...) is not ported: the "
            "reference accepts it and ignores it (ROADMAP.md §C.14)")
    x = _channel_first(x, data_format)
    ksize, stride, pads = _pool_pads(x, kernel_size, stride, padding, nsp,
                                     ceil_mode)
    if _native(pads, ksize):
        pool = getattr(tF, f"avg_pool{nsp}d")
        out = pool(x, ksize, stride, tuple(lo for lo, _ in pads),
                   count_include_pad=not exclusive)
    else:
        sums = _window_sums(tF.pad(x, _pad_arg(pads)), ksize, stride, nsp)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = sums / _window_sums(tF.pad(ones, _pad_arg(pads)), ksize,
                                      stride, nsp)
        else:
            out = sums / math.prod(ksize)
    return _channel_back(out, data_format)


@amp_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, ceil_mode,
                     exclusive, data_format)


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, ceil_mode,
                     exclusive, data_format, divisor_override)


@amp_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, ceil_mode,
                     exclusive, data_format, divisor_override)


def _adaptive(x, output_size, nsp, mode):
    """Per-dim bins ``[floor(i n / o), ceil((i + 1) n / o))``: the
    reference's and torch's."""
    pool = getattr(tF, f"adaptive_{mode}_pool{nsp}d")
    return pool(x, _tuple(output_size, nsp))


def _no_mask(return_mask, nsp):
    if return_mask:
        raise NotImplementedError(
            f"adaptive_max_pool{nsp}d(return_mask=True) is not ported: the "
            "reference accepts it and returns no mask (ROADMAP.md §C.16)")


@amp_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg")


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    out = _adaptive(_channel_first(x, data_format), output_size, 2, "avg")
    return _channel_back(out, data_format)


@amp_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    if data_format != "NCDHW":
        raise NotImplementedError(
            "adaptive_avg_pool3d supports NCDHW only: the reference pools "
            "an NDHWC input as if it were NCDHW (ROADMAP.md §C.16)")
    return _adaptive(x, output_size, 3, "avg")


@amp_op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, 1)
    return _adaptive(x, output_size, 1, "max")


@amp_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, 2)
    return _adaptive(x, output_size, 2, "max")


@amp_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, 3)
    return _adaptive(x, output_size, 3, "max")
