"""Pooling layers (counterpart of ``paddle_tpu/nn/layers/pooling.py``)
over the functionals of ``nn/functional/conv.py``, with the reference's
arguments. The reference's max-pool layers take ``return_mask`` and
return no mask; here ``return_mask=True`` raises (ROADMAP.md §C.16), as
``divisor_override`` does in the functional (§C.14).
``MaxUnPool1D/2D/3D`` wait with their functionals (ROADMAP.md §A.6)."""
from __future__ import annotations


from ..functional import conv as F
from ..layer import Layer


def _refuse_mask(return_mask):
    if return_mask:
        raise NotImplementedError(
            "return_mask=True on a max-pool layer is not ported: the "
            "reference's layer accepts it and returns no mask (ROADMAP.md "
            "§C.16); call the functional max_pool*d(return_mask=True)")


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        _refuse_mask(return_mask)
        self.k, self.s, self.p, self.ceil = (kernel_size, stride, padding,
                                             ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p, ceil_mode=self.ceil)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        _refuse_mask(return_mask)
        self.k, self.s, self.p, self.ceil, self.df = (
            kernel_size, stride, padding, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, ceil_mode=self.ceil,
                            data_format=self.df)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__()
        _refuse_mask(return_mask)
        self.k, self.s, self.p, self.ceil, self.df = (
            kernel_size, stride, padding, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p, ceil_mode=self.ceil,
                            data_format=self.df)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p, self.ex, self.ceil = (
            kernel_size, stride, padding, exclusive, ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.ex, self.ceil)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil, self.ex, self.df = (
            kernel_size, stride, padding, ceil_mode, exclusive, data_format)
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil, self.ex,
                            self.divisor_override, data_format=self.df)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil, self.ex, self.df = (
            kernel_size, stride, padding, ceil_mode, exclusive, data_format)
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool3d(x, self.k, self.s, self.p, self.ceil, self.ex,
                            self.divisor_override, data_format=self.df)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.df = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.df)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.df = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.df)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        _refuse_mask(return_mask)
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        _refuse_mask(return_mask)
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        _refuse_mask(return_mask)
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)


__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D"]
