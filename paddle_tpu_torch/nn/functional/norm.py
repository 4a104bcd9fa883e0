"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): plain tensor ops, as in the
reference, where they are jnp and no kernel; batch norm calls
``torch.nn.functional.batch_norm`` (cuDNN on the card), except in
training over one value per channel, which it refuses, and in training
on a batch split over data-parallel ranks, where its statistics are the
global batch's. All are on the AMP black list: under ``auto_cast`` they
take and return f32."""
from __future__ import annotations

import torch

from ...framework.op import amp_op


@amp_op("layer_norm_op", "black")
def _layer_norm(x, weight, bias, epsilon, normalized_shape):
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _layer_norm(x, weight, bias, float(epsilon),
                       tuple(normalized_shape))


@amp_op("rms_norm_op", "black")
def _rms_norm(x, weight, epsilon, begin_axis):
    axes = tuple(range(begin_axis, x.dim()))
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=axes, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the trailing ``weight.dim()`` axes (the last axis
    without a weight): normalised in f32, cast back to ``x``'s dtype, then
    scaled by ``weight``."""
    begin = x.dim() - (weight.dim() if weight is not None else 1)
    return _rms_norm(x, weight, float(epsilon), begin)


def _channels_first(x, data_format):
    """Whether ``data_format`` puts the channels at axis 1 (the
    reference's ``data_format[1] == "C"``; else they are the last axis)."""
    return data_format[1] == "C"


@amp_op("batch_norm_infer", "black")
def _bn_infer(x, mean, var, weight, bias, epsilon, data_format):
    if not _channels_first(x, data_format):
        return _bn_infer.raw(x.movedim(-1, 1), mean, var, weight, bias,
                             epsilon, "NC").movedim(1, -1)
    return torch.nn.functional.batch_norm(x, mean, var, weight, bias, False,
                                          0.0, epsilon)


@amp_op("batch_norm_train", "black",
        uncast=("running_mean", "running_var"))
def _bn_train(x, weight, bias, epsilon, data_format, momentum, *,
              running_mean, running_var):
    """Normalised by the batch's biased variance; the running buffers
    updated in place as ``running * m + batch * (1 - m)``, the variance's
    batch term unbiased (``n / (n - 1)``): torch's rule at its momentum
    ``1 - m``."""
    if not _channels_first(x, data_format):
        return _bn_train.raw(x.movedim(-1, 1), weight, bias, epsilon, "NC",
                             momentum, running_mean=running_mean,
                             running_var=running_var).movedim(1, -1)
    from .loss import _split_group

    if _split_group is not None:
        return _bn_train_split(x, weight, bias, epsilon, momentum,
                               running_mean, running_var, _split_group)
    if x.numel() == x.shape[1]:
        return _bn_train_one_value(x, weight, bias, epsilon, momentum,
                                   running_mean, running_var)
    return torch.nn.functional.batch_norm(
        x, running_mean, running_var, weight, bias, True, 1.0 - momentum,
        epsilon)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` in the forward and in the backward: each
    rank's statistic feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed import collective

        ctx.group = group
        out = x.clone()
        collective.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def _bn_train_split(x, weight, bias, epsilon, momentum, running_mean,
                    running_var, group):
    """Training on a batch split over ``group`` (``fleet.DistTrainStep``):
    the statistics of the global batch, as the reference's one program
    over the global batch takes them (upstream Paddle's SyncBatchNorm).
    The per-channel sums are summed over the group, then the sums of
    squared deviations from the global mean (two passes, as ``jnp.var``);
    the gradient flows through both sums. The running buffers come out
    equal on every rank."""
    axes = [a for a in range(x.dim()) if a != 1]
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    n = (x.numel() // x.shape[1]) * group.nranks
    mean = _AllReduceSum.apply(x.sum(axes), group) / n
    d = x - mean.reshape(shape)
    var = _AllReduceSum.apply(torch.square(d).sum(axes), group) / n
    out = d * torch.reciprocal(torch.sqrt(var + epsilon)).reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        running_mean.copy_(running_mean * momentum + mean * (1 - momentum))
        running_var.copy_(running_var * momentum
                          + unbiased * (1 - momentum))
    return out


def _bn_train_one_value(x, weight, bias, epsilon, momentum, running_mean,
                        running_var):
    """Training over one value per channel, which torch's ``batch_norm``
    refuses: the reference's arithmetic. The batch variance is 0, so the
    output is the bias (0 without one); the running variance's batch term
    is unbiased by ``n / max(n - 1, 1)`` = 1."""
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    mean = x.reshape(-1)
    var = torch.zeros_like(mean)
    out = (x - mean.reshape(shape)) * torch.reciprocal(
        torch.sqrt(var + epsilon)).reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    with torch.no_grad():
        running_mean.copy_(running_mean * momentum
                           + mean * (1 - momentum))
        running_var.copy_(running_var * momentum + var * (1 - momentum))
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channels'. In training (unless
    ``use_global_stats``) it normalises by the batch's statistics and
    updates ``running_mean`` / ``running_var`` in place; otherwise it
    normalises by them and updates nothing. ``momentum`` weighs the
    running value, as Paddle's does."""
    if training and not use_global_stats:
        return _bn_train(x, weight, bias, float(epsilon), data_format,
                         float(momentum), running_mean=running_mean,
                         running_var=running_var)
    return _bn_infer(x, running_mean, running_var, weight, bias,
                     float(epsilon), data_format)


__all__ = ["batch_norm", "layer_norm", "rms_norm"]
