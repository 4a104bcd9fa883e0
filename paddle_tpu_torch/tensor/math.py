"""Elementwise ops, reductions, cumulative ops and special functions
(counterparts of ``paddle_tpu/tensor/math.py``), under the reference's op
names. Operands of different dtypes promote as jnp promotes them (bf16
with f32 gives f32).

Where the reference departs from torch's same-named call, the reference
holds: ``max`` / ``min`` return values only, ``median`` averages the two
middle values, an integer reduction stays in the input's dtype, ``mean`` /
``var`` / ``std`` of integers are float32, ``igamma`` is the upper
regularized incomplete gamma and ``igammac`` the lower. ``cummax`` /
``cummin`` return ``(values, int64 indices)`` as upstream Paddle does;
the reference returns no indices (ROADMAP §C.23)."""
from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.op import amp_op

_ASIS = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
         torch.complex64, torch.complex128)


def _fp(x):
    """``x`` as the reference's float functions read it: integers and bool
    as float32."""
    return x if x.dtype in _ASIS else x.to(torch.float32)


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    return (int(axis),) if isinstance(axis, (int, np.integer)) \
        else tuple(int(a) for a in axis)


def _int_dtype(x, dtype):
    """A reduction's dtype: ``dtype`` if given, else ``x``'s (int64 for
    bool), where torch would widen an integer ``x``."""
    dtype = convert_dtype(dtype)
    if dtype is None:
        dtype = torch.int64 if x.dtype == torch.bool else x.dtype
    return dtype


# -- binary -----------------------------------------------------------------------


@amp_op("add")
def add(x, y, name=None):
    return x + y


@amp_op("subtract")
def subtract(x, y, name=None):
    return x - y


@amp_op("multiply")
def multiply(x, y, name=None):
    return x * y


@amp_op("divide")
def divide(x, y, name=None):
    return x / y


@amp_op("floor_divide")
def floor_divide(x, y, name=None):
    return torch.floor_divide(x, y)


@amp_op("remainder")
def remainder(x, y, name=None):
    """Python's ``%``: the result takes ``y``'s sign."""
    return torch.remainder(x, y)


mod = remainder
floor_mod = remainder


@amp_op("pow")
def pow(x, y, name=None):  # noqa: A001 — paddle.pow
    return torch.pow(x, y)


@amp_op("maximum")
def maximum(x, y, name=None):
    return torch.maximum(x, y)


@amp_op("minimum")
def minimum(x, y, name=None):
    return torch.minimum(x, y)


@amp_op("fmax")
def fmax(x, y, name=None):
    return torch.fmax(x, y)


@amp_op("fmin")
def fmin(x, y, name=None):
    return torch.fmin(x, y)


@amp_op("atan2")
def atan2(x, y, name=None):
    return torch.atan2(_fp(x), _fp(y))


@amp_op("lerp")
def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


@amp_op("inner")
def inner(x, y, name=None):
    return torch.inner(x, y)


@amp_op("outer")
def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@amp_op("kron")
def kron(x, y, name=None):
    return torch.kron(x, y)


@amp_op("logaddexp")
def logaddexp(x, y, name=None):
    return torch.logaddexp(_fp(x), _fp(y))


@amp_op("logaddexp2")
def logaddexp2(x, y, name=None):
    return torch.logaddexp2(_fp(x), _fp(y))


@amp_op("heaviside")
def heaviside(x, y, name=None):
    return torch.heaviside(x, y)


@amp_op("copysign")
def copysign(x, y, name=None):
    return torch.copysign(x, y)


@amp_op("gcd")
def gcd(x, y, name=None):
    return torch.gcd(x, y)


@amp_op("lcm")
def lcm(x, y, name=None):
    return torch.lcm(x, y)


@amp_op("hypot")
def hypot(x, y, name=None):
    return torch.hypot(x, y)


@amp_op("nextafter")
def nextafter(x, y, name=None):
    return torch.nextafter(x, y)


@amp_op("ldexp")
def ldexp(x, y, name=None):
    """``x * 2 ** y`` in ``x``'s float dtype (float32 for an integer
    ``x``)."""
    return x * torch.exp2(y.to(torch.float32)).to(_fp(x).dtype)


@amp_op("multiply_no_nan")
def multiply_no_nan(x, y, name=None):
    """``x * y``, 0 where ``y`` is 0 (even where ``x`` is inf or NaN)."""
    return torch.where(y == 0, torch.zeros_like(x * y), x * y)


# -- unary --------------------------------------------------------------------------


def _unary(opname, fn, amp=None, doc=None):
    def op(x, name=None):
        return fn(x)

    op.__name__ = op.__qualname__ = opname
    op.__doc__ = doc
    return amp_op(opname, amp)(op)


sqrt = _unary("sqrt", lambda x: torch.sqrt(_fp(x)))
rsqrt = _unary("rsqrt", lambda x: torch.rsqrt(_fp(x)))
square = _unary("square", torch.square)
exp = _unary("exp", torch.exp, "black")
expm1 = _unary("expm1", lambda x: torch.expm1(_fp(x)))
log = _unary("log", torch.log, "black")
log2 = _unary("log2", lambda x: torch.log2(_fp(x)))
log10 = _unary("log10", lambda x: torch.log10(_fp(x)))
log1p = _unary("log1p", lambda x: torch.log1p(_fp(x)))
abs = _unary("abs", torch.abs)  # noqa: A001 — paddle.abs
neg = _unary("neg", torch.neg)
sign = _unary("sign", torch.sign)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round,  # noqa: A001 — paddle.round
               doc="Halves round to even, as jnp and torch round them.")
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda x: x - torch.trunc(x))
sin = _unary("sin", lambda x: torch.sin(_fp(x)))
cos = _unary("cos", lambda x: torch.cos(_fp(x)))
tan = _unary("tan", lambda x: torch.tan(_fp(x)))
asin = _unary("asin", lambda x: torch.asin(_fp(x)))
acos = _unary("acos", lambda x: torch.acos(_fp(x)))
atan = _unary("atan", lambda x: torch.atan(_fp(x)))
sinh = _unary("sinh", lambda x: torch.sinh(_fp(x)))
cosh = _unary("cosh", lambda x: torch.cosh(_fp(x)))
tanh = _unary("tanh", lambda x: torch.tanh(_fp(x)))
asinh = _unary("asinh", lambda x: torch.asinh(_fp(x)))
acosh = _unary("acosh", lambda x: torch.acosh(_fp(x)))
atanh = _unary("atanh", lambda x: torch.atanh(_fp(x)))
reciprocal = _unary("reciprocal", torch.reciprocal)
erf = _unary("erf", lambda x: torch.erf(_fp(x)))
erfinv = _unary("erfinv", lambda x: torch.erfinv(_fp(x)))
digamma = _unary("digamma", lambda x: torch.special.digamma(_fp(x)))
lgamma = _unary("lgamma", lambda x: torch.lgamma(_fp(x)))
gammaln = _unary("gammaln", lambda x: torch.special.gammaln(_fp(x)))
sigmoid = _unary("sigmoid", lambda x: torch.sigmoid(_fp(x)))
rad2deg = _unary("rad2deg", lambda x: torch.rad2deg(_fp(x)))
deg2rad = _unary("deg2rad", lambda x: torch.deg2rad(_fp(x)))
angle = _unary("angle", lambda x: torch.angle(_fp(x)))
conj = _unary("conj", lambda x: torch.conj(x).resolve_conj())
real = _unary("real", lambda x: torch.real(x) if x.is_complex() else x)
imag = _unary("imag", lambda x: torch.imag(x) if x.is_complex()
              else torch.zeros_like(x))
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
isposinf = _unary("isposinf", torch.isposinf)
isneginf = _unary("isneginf", torch.isneginf)
isreal = _unary("isreal", torch.isreal)
signbit = _unary("signbit", torch.signbit)
sgn = _unary("sgn", torch.sgn, doc="``x / |x|`` for complex, else sign.")
positive = _unary("positive", lambda x: x.clone())
sinc = _unary("sinc", lambda x: torch.sinc(_fp(x)))
i0 = _unary("i0", lambda x: torch.special.i0(_fp(x)))
i0e = _unary("i0e", lambda x: torch.special.i0e(_fp(x)))
i1 = _unary("i1", lambda x: torch.special.i1(_fp(x)))
i1e = _unary("i1e", lambda x: torch.special.i1e(_fp(x)))


def fix(x, name=None):
    """Alias of trunc."""
    return trunc(x)


@amp_op("logit")
def logit(x, eps=None, name=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@amp_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@amp_op("clip")
def clip(x, min=None, max=None, name=None):  # noqa: A002
    return torch.clamp(x, min=min, max=max)


def clip_(x, min=None, max=None, name=None):  # noqa: A002
    return x.clamp_(min=min, max=max)


@amp_op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias``, or ``(x + bias) * scale`` without
    ``bias_after_scale``; ``act`` is accepted and not applied, as in the
    reference."""
    return x * scale + bias if bias_after_scale else (x + bias) * scale


@amp_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


@amp_op("increment")
def increment(x, value=1.0, name=None):
    """``x + value``, ``value`` in ``x``'s dtype."""
    return x + torch.tensor(value, dtype=x.dtype, device=x.device)


@amp_op("polygamma")
def polygamma(x, n, name=None):
    return torch.special.polygamma(int(n), _fp(x))


@amp_op("igamma")
def igamma(x, a, name=None):
    """The upper regularized incomplete gamma Q(x, a), as the reference
    computes ``paddle.igamma``."""
    return torch.special.gammaincc(_fp(x), _fp(a))


@amp_op("igammac")
def igammac(x, a, name=None):
    """The lower regularized incomplete gamma P(x, a)."""
    return torch.special.gammainc(_fp(x), _fp(a))


@amp_op("gammainc")
def gammainc(x, y, name=None):
    return torch.special.gammainc(_fp(x), _fp(y))


@amp_op("gammaincc")
def gammaincc(x, y, name=None):
    return torch.special.gammaincc(_fp(x), _fp(y))


@amp_op("multigammaln")
def multigammaln(x, p, name=None):
    return torch.special.multigammaln(_fp(x), int(p))


# -- reductions ------------------------------------------------------------------------


@amp_op("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    """Sum over ``axis`` (all axes when None), accumulated and returned in
    ``dtype`` (default: x's dtype, where torch would widen an integer x;
    int64 for a bool x), with the reference's argument order."""
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim,
                     dtype=_int_dtype(x, dtype))


@amp_op("mean")
def mean(x, axis=None, keepdim=False, name=None):
    """The mean over ``axis`` (all axes when None); float32 for integer
    and bool ``x``, as the reference's."""
    return torch.mean(_fp(x), dim=_dims(x, axis), keepdim=keepdim)


@amp_op("max")
def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """The maximum over ``axis``: values only."""
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@amp_op("min")
def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """The minimum over ``axis``: values only."""
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax = max
amin = min


@amp_op("prod")
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dtype = _int_dtype(x, dtype)
    for d in sorted(_dims(x, axis), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim, dtype=dtype)
    return x.to(dtype)


@amp_op("all")
def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.all(x.to(torch.bool), dim=_dims(x, axis), keepdim=keepdim)


@amp_op("any")
def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.any(x.to(torch.bool), dim=_dims(x, axis), keepdim=keepdim)


@amp_op("var_op")
def _var(x, axis, unbiased, keepdim):
    return torch.var(_fp(x), dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _var(x, axis=axis, unbiased=bool(unbiased), keepdim=keepdim)


@amp_op("std_op")
def _std(x, axis, unbiased, keepdim):
    return torch.std(_fp(x), dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _std(x, axis=axis, unbiased=bool(unbiased), keepdim=keepdim)


def _over_axes(fn, x, axis, keepdim, *args):
    """``fn(x2d, *args)`` reducing the last axis of ``x`` with the axes
    ``axis`` moved last and merged; ``fn`` may add leading axes (a list
    of quantiles)."""
    dims = _dims(x, axis)
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, *args)
    if keepdim:
        lead = out.dim() - len(rest)
        shape = list(out.shape[:lead]) + [1 if d in dims else x.shape[d]
                                          for d in range(x.dim())]
        out = out.reshape(shape)
    return out


def _quantile_fn(torch_fn):
    """Quantiles ``q`` of the last axis by ``torch_fn``; a half-precision
    ``v`` (an O2 cast) is interpolated in float32 and returned in its
    dtype (torch's quantiles take float32 and float64 only)."""
    def fn(v, q):
        w = v if v.dtype in (torch.float32, torch.float64) else v.float()
        qt = torch.as_tensor(q, dtype=w.dtype, device=w.device)
        return torch_fn(w, qt, dim=-1).to(v.dtype)
    return fn


@amp_op("median_op")
def _median(x, axis, keepdim):
    return _over_axes(_quantile_fn(torch.quantile), _fp(x), axis, keepdim,
                      0.5)


def median(x, axis=None, keepdim=False, name=None):
    """The median over ``axis``: the mean of the two middle values where
    their count is even."""
    return _median(x, axis=axis, keepdim=keepdim)


@amp_op("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _over_axes(_quantile_fn(torch.nanquantile), _fp(x), axis,
                      keepdim, 0.5)


@amp_op("quantile_op")
def _quantile(x, q, axis, keepdim):
    return _over_axes(_quantile_fn(torch.quantile), _fp(x), axis, keepdim,
                      q)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Linear-interpolated quantiles ``q`` (a number, or a list giving a
    leading axis) over ``axis``."""
    return _quantile(x, q, axis=axis, keepdim=keepdim)


@amp_op("nanquantile_op")
def _nanquantile(x, q, axis, keepdim):
    return _over_axes(_quantile_fn(torch.nanquantile), _fp(x), axis,
                      keepdim, q)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _nanquantile(x, q, axis=axis, keepdim=keepdim)


@amp_op("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim,
                        dtype=convert_dtype(dtype))


@amp_op("nanmean")
def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(_fp(x), dim=_dims(x, axis), keepdim=keepdim)


@amp_op("logsumexp_op")
def _logsumexp(x, axis, keepdim):
    return torch.logsumexp(_fp(x), dim=_dims(x, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _logsumexp(x, axis=axis, keepdim=keepdim)


@amp_op("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        out = out.reshape([1 if d in dims else s
                           for d, s in enumerate(x.shape)])
    return out


# -- cumulative -----------------------------------------------------------------------


def _along(x, axis):
    """``(x, axis)``, ``x`` flattened and the axis 0 when ``axis`` is
    None."""
    return (x.reshape(-1), 0) if axis is None else (x, int(axis))


@amp_op("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _along(x, axis)
    return torch.cumsum(x, dim=axis, dtype=_int_dtype(x, dtype))


@amp_op("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _along(x, dim)
    return torch.cumprod(x, dim=dim, dtype=_int_dtype(x, dtype))


@amp_op("cummax_op")
def _cummax(x, axis):
    return torch.cummax(x, dim=axis)


@amp_op("cummin_op")
def _cummin(x, axis):
    return torch.cummin(x, dim=axis)


def cummax_op(x, axis):
    return _cummax(x, axis).values


def cummin_op(x, axis):
    return _cummin(x, axis).values


def cummax(x, axis=None, dtype="int64", name=None):
    """``(values, indices)``: the running maximum along ``axis`` (over the
    flattened ``x`` when None) and where it was found."""
    x, axis = _along(x, axis)
    out = _cummax(x, axis)
    return out.values, out.indices.to(convert_dtype(dtype))


def cummin(x, axis=None, dtype="int64", name=None):
    """``(values, indices)`` of the running minimum, as :func:`cummax`."""
    x, axis = _along(x, axis)
    out = _cummin(x, axis)
    return out.values, out.indices.to(convert_dtype(dtype))


@amp_op("logcumsumexp")
def logcumsumexp(x, axis=None, name=None):
    x, axis = _along(x, axis)
    return torch.logcumsumexp(_fp(x), dim=axis)


@amp_op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.cumulative_trapezoid(y, x, dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx,
                                      dim=axis)


@amp_op("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


# -- others --------------------------------------------------------------------------


@amp_op("add_n_op")
def _add_n(inputs):
    out = inputs[0]
    for v in inputs[1:]:
        out = out + v
    return out


def add_n(inputs, name=None):
    """The sum of a list of tensors (a tensor is returned as given)."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    return _add_n(list(inputs))


@amp_op("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    d = torch.diagonal(x, offset, axis1, axis2)
    return torch.sum(d, dim=-1, dtype=_int_dtype(d, None))


@amp_op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


@amp_op("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, dim=axis, prepend=prepend, append=append)


def _hist_counts(v, bins, lo, hi):
    """numpy's histogram counts of the flat ``v`` over ``bins`` equal
    bins of ``[lo, hi]`` (the last bin closed), as jnp counts them: a
    value's bin is found among the float32 edges."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float32,
                           device=v.device)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1]


def _data_range(v, lo, hi):
    if lo == 0 and hi == 0:
        return float(v.min()), float(v.max())
    return float(lo), float(hi)


@amp_op("histogram_op")
def histogram_op(x, bins, min, max):  # noqa: A002
    v = _fp(x)
    return _hist_counts(v.reshape(-1), bins, min, max).to(v.dtype)


def histogram(x, bins=100, min=0, max=0, name=None):  # noqa: A002
    """int64 counts of ``x`` in ``bins`` equal bins of ``[min, max]``
    (``min == max == 0``: the data's range)."""
    lo, hi = _data_range(_fp(x), min, max)
    return histogram_op(x, bins=int(bins), min=lo, max=hi).to(torch.int64)


@amp_op("histc_op")
def _histc(x, bins, min, max):  # noqa: A002
    v = _fp(x)
    lo, hi = _data_range(v, min, max)
    return _hist_counts(v.reshape(-1), bins, lo, hi).to(v.dtype)


def histc(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """Counts as :func:`histogram`'s, in ``input``'s float dtype."""
    return _histc(input, bins=int(bins), min=float(min), max=float(max))


@amp_op("histogram_bin_edges")
def histogram_bin_edges(input, bins=100, min=0.0, max=0.0,  # noqa: A002
                        name=None):
    """The ``bins + 1`` edges :func:`histogram` uses; a constant input's
    range is widened by 1 each side."""
    lo, hi = _data_range(_fp(input), float(min), float(max))
    if lo == hi:
        lo, hi = lo - 1.0, hi + 1.0
    return torch.linspace(lo, hi, int(bins) + 1, dtype=torch.float32,
                          device=input.device)


@amp_op("histogramdd_op")
def _histogramdd_op(sample, bins, ranges, density, weights):
    n, d = sample.shape
    nbins = [bins] * d if isinstance(bins, int) else bins
    edges = []
    for i in range(d):
        b = nbins[i]
        if isinstance(b, torch.Tensor):
            edges.append(b.to(sample.dtype))
            continue
        if ranges is None:
            lo, hi = float(sample[:, i].min()), float(sample[:, i].max())
        else:
            lo, hi = float(ranges[2 * i]), float(ranges[2 * i + 1])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges.append(torch.linspace(lo, hi, int(b) + 1, dtype=sample.dtype,
                                    device=sample.device))
    flat = torch.zeros(n, dtype=torch.int64, device=sample.device)
    for i, e in enumerate(edges):
        idx = torch.searchsorted(e, sample[:, i].contiguous(), right=True)
        idx = torch.where(sample[:, i] == e[-1], len(e) - 1, idx)
        flat = flat * (len(e) + 1) + idx
    sizes = [len(e) + 1 for e in edges]
    total = int(np.prod(sizes))
    w = None if weights is None else weights.reshape(-1).to(sample.dtype)
    hist = torch.bincount(flat, weights=w, minlength=total)[:total]
    hist = hist.reshape(sizes)[tuple(builtins.slice(1, -1)
                                     for _ in sizes)]
    if w is not None or density:
        hist = hist.to(sample.dtype)
    if density:
        widths = torch.meshgrid(*(torch.diff(e) for e in edges),
                                indexing="ij")
        vol = torch.ones_like(hist)
        for wd in widths:
            vol = vol * wd
        hist = hist / (vol * hist.sum())
    return hist, edges


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``(hist, edges)`` of the ``[N, D]`` sample ``x``, as numpy's
    ``histogramdd``."""
    return _histogramdd_op(x, bins, ranges, bool(density), weights)


@amp_op("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x, weights=weights, minlength=int(minlength))
    return out if weights is None else out.to(weights.dtype)


@amp_op("broadcast_shape_helper")
def broadcast_shape_helper(x, y):
    return torch.broadcast_tensors(x, y)[0]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@amp_op("renorm_op")
def _renorm(x, p, axis, max_norm):
    dims = tuple(d for d in range(x.dim()) if d != axis)
    norms = (torch.abs(x) ** p).sum(dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-12),
                         torch.ones_like(norms))
    return x * factor


def renorm(x, p, axis, max_norm, name=None):
    """``x`` with each slice along ``axis`` whose ``p``-norm passes
    ``max_norm`` scaled back to it."""
    return _renorm(x, p=float(p), axis=int(axis), max_norm=float(max_norm))


@amp_op("frexp")
def frexp(x, name=None):
    """``(mantissa, int32 exponent)`` with ``x = mantissa * 2 ** exponent``."""
    return tuple(torch.frexp(x))


@amp_op("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * torch.matmul(x, y)


@amp_op("baddbmm")
def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """``beta * input + alpha * (x @ y)``, batched; at ``beta == 0``
    ``input`` is not read."""
    if beta == 0:
        return alpha * torch.matmul(x, y)
    return beta * input + alpha * torch.matmul(x, y)


def combinations(x, r=2, with_replacement=False, name=None):
    """All ``r``-combinations of a 1-D tensor's elements, ``[K, r]``."""
    pick = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = torch.tensor(list(pick(range(x.shape[0]), r)), dtype=torch.int64,
                       device=x.device).reshape(-1, r)
    return x[idx]


@amp_op("polar")
def polar(abs, angle, name=None):  # noqa: A002
    return torch.polar(abs.to(torch.float32), angle.to(torch.float32))


@amp_op("as_complex")
def as_complex(x, name=None):
    """``[..., 2]`` floats as ``[...]`` complex."""
    return torch.view_as_complex(x.contiguous())


@amp_op("as_real")
def as_real(x, name=None):
    """``[...]`` complex as ``[..., 2]`` floats."""
    return torch.view_as_real(x)


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_complex(x):
    return x.is_complex()


def tolist(x):
    return x.tolist()


__all__ = [
    "abs", "acos", "acosh", "add", "add_n", "addmm", "all", "amax", "amin",
    "angle", "any", "as_complex", "as_real", "asin", "asinh", "atan",
    "atan2", "atanh", "baddbmm", "bincount", "broadcast_shape",
    "broadcast_shape_helper", "ceil", "clip", "clip_", "combinations",
    "conj", "copysign", "cos", "cosh", "count_nonzero", "cummax",
    "cummax_op", "cummin", "cummin_op", "cumprod", "cumsum",
    "cumulative_trapezoid", "deg2rad", "diagonal", "diff", "digamma",
    "divide", "erf", "erfinv", "exp", "expm1", "fix", "floor",
    "floor_divide", "floor_mod", "fmax", "fmin", "frac", "frexp", "gammainc",
    "gammaincc", "gammaln", "gcd", "heaviside", "histc", "histogram",
    "histogram_bin_edges", "histogram_op", "histogramdd", "hypot", "i0",
    "i0e", "i1", "i1e", "igamma", "igammac", "imag", "increment", "inner",
    "is_complex", "is_floating_point", "is_integer", "isfinite", "isinf",
    "isnan", "isneginf", "isposinf", "isreal", "kron", "lcm", "ldexp",
    "lerp", "lgamma", "log", "log10", "log1p", "log2", "logaddexp",
    "logaddexp2", "logcumsumexp", "logit", "logsumexp", "max", "maximum",
    "mean", "median", "min", "minimum", "mod", "multigammaln", "multiply",
    "multiply_no_nan", "nan_to_num", "nanmean", "nanmedian", "nanquantile",
    "nansum", "neg", "nextafter", "outer", "polar", "polygamma", "positive",
    "pow", "prod", "quantile", "rad2deg", "real", "reciprocal", "remainder",
    "renorm", "round", "rsqrt", "scale", "sgn", "sigmoid", "sign", "signbit",
    "sin", "sinc", "sinh", "sqrt", "square", "stanh", "std", "subtract",
    "sum", "tan", "tanh", "tolist", "trace", "trapezoid", "trunc", "var"]
