"""Convolution layers (counterpart of ``paddle_tpu/nn/layers/conv.py``):
``Conv1D/2D/3D`` with the weight ``[out, in / groups, *k]`` and the
transposed ``Conv1DTranspose/2D/3D`` with ``[in, out / groups, *k]``,
XavierNormal by default (``weight_attr`` / ``bias_attr`` through
``ParamAttr``; ``bias_attr=False`` drops the bias), over the functionals
of ``nn/functional/conv.py``.

``padding_mode`` other than ``"zeros"`` raises: the reference stores it
and never reads it (ROADMAP.md §C.15)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import initializer as I
from ..functional import conv as F
from ..layer import Layer, create_parameter


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nsp, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, transposed=False, output_padding=0,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r} is not ported: the reference "
                "accepts it and pads with zeros (ROADMAP.md §C.15)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nsp)
        self._stride = _ntuple(stride, nsp)
        self._padding = padding
        self._dilation = _ntuple(dilation, nsp)
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._output_padding = output_padding
        if transposed:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = create_parameter(
            shape, weight_attr, default_initializer=I.XavierNormal(), **kw)
        self.bias = (None if bias_attr is False else create_parameter(
            (out_channels,), bias_attr, is_bias=True, **kw))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation, output_size,
            self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation, output_size,
            self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation, output_size,
            self._data_format)


__all__ = ["Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose"]
