"""Losses of the port.

``cross_entropy``, ``softmax_with_cross_entropy``, ``nll_loss`` and
``mse_loss`` mirror ``paddle_tpu/nn/functional/loss.py``: hard (integer)
or soft labels, ``ignore_index`` (a mean over the valid rows only),
per-class ``weight``, ``axis``, ``label_smoothing`` and
``use_softmax=False`` (the input is already a distribution). The softmax
cross entropy is the reference's ``cross_entropy_op``, on the AMP black
list: it runs in f32 under ``auto_cast``.
``_parallel_softmax_ce`` is the counterpart of
``paddle_tpu/distributed/fleet/layers/mpu.py::_parallel_softmax_ce`` (the
loss under ``GPTPretrainingCriterion``) at model-parallel degree 1: plain
tensor ops, as in the reference, where it is jnp and no kernel. It is on
neither AMP list, as in the reference: under ``auto_cast`` it runs in the
logits' dtype, bf16 included (upstream Paddle keeps its softmax cross
entropy in f32; ROADMAP.md C lists the difference). Its vocab-parallel
form is ``distributed/fleet/layers/mpu.py::parallel_cross_entropy``.

Under ``fleet.DistTrainStep`` (:func:`split_batch`) each rank runs the
loss on its rows of the global batch: every count or weight a mean
divides by is summed over the group first (:func:`_denominator`) and a
sum is scaled by the group's size (:func:`_batch_sum`), so the ranks'
mean is the reference's loss over the global batch.
"""
from __future__ import annotations

import contextlib

import torch

from ... import tensor as T
from ...framework.op import amp_op


@amp_op("parallel_cross_entropy")
def _parallel_softmax_ce(logits, label, ignore_index=-100):
    """Per-token cross entropy of ``logits [..., V]`` against integer
    ``label [...]``: a max-shifted log-softmax (the max carries no
    gradient), 0 where ``label == ignore_index``. Returns ``label``'s
    shape in the logits' dtype."""
    m = logits.amax(-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(-1, keepdim=True))
    logprobs = shifted - lse
    ignored = label == ignore_index
    safe = torch.where(ignored, torch.zeros_like(label), label).long()
    picked = torch.gather(logprobs, -1, safe.unsqueeze(-1)).squeeze(-1)
    return -torch.where(ignored, torch.zeros_like(picked), picked)


#: the group whose ranks each hold a part of the batch (rows over the data
#: axes, sequence blocks over sep) while ``fleet.DistTrainStep`` runs the
#: loss (None otherwise); MoE gating reads it too
_split_group = None
#: the group whose ranks all hold this rank's tokens (the data axes when
#: ``fleet.DistTrainStep`` leaves the rows whole: they do not divide by
#: the data degree), or None; MoE expert parallelism reads it
_replica_group = None
#: the counts that :func:`_denominator` met in the pipeline schedule's
#: current micro-batch (None outside one)
_micro_counts = None


@contextlib.contextmanager
def split_batch(group, replica=None):
    """Within: the batch is split over ``group``'s ranks (None: not split),
    and :func:`_denominator` counts over all of them; ``replica`` (None:
    none) is a group whose ranks hold the same tokens."""
    global _split_group, _replica_group
    prev = _split_group, _replica_group
    _split_group, _replica_group = group, replica
    try:
        yield
    finally:
        _split_group, _replica_group = prev


@contextlib.contextmanager
def micro_batch():
    """Within: the loss of one pipeline micro-batch. :func:`_denominator`
    records its count in the list this yields and divides by 1, so a
    masked mean gives the micro-batch's sum: the pipeline schedule divides
    the summed gradients by the total count once every micro-batch is in
    (a micro-batch's own count cannot wait for the others under 1F1B)."""
    global _micro_counts
    prev, _micro_counts = _micro_counts, []
    try:
        yield _micro_counts
    finally:
        _micro_counts = prev


def _denominator(count, floor=1.0, clip=T.clip):
    """``clip(count, min=floor)`` (``T.clip``, the reference's op of a
    masked mean; a loss whose reference divides inside one op passes
    ``torch.clamp``). On a batch split over a data-parallel group of
    ``n`` ranks, ``max(total, floor) / n`` with ``total`` the count summed
    over the group (no gradient): each rank's loss is then ``n`` times its
    share of the global mean, and the ranks' mean (the gradients'
    average) is the global mean however the count splits. In a pipeline
    micro-batch (:func:`micro_batch`), 1, the count recorded."""
    if _micro_counts is not None:
        _micro_counts.append(count.detach())
        return torch.ones_like(count)
    if _split_group is None:
        return clip(count, min=floor)
    from ...distributed import collective

    total = count.detach().clone()
    collective.all_reduce(total, group=_split_group)
    return torch.clamp(total, min=floor) / _split_group.nranks


def _batch_sum(out):
    """``out.sum()``; on a batch split over ``n`` ranks (outside a pipeline
    micro-batch) ``n`` times the rank's sum, so that the ranks' mean is
    the global sum, as :func:`_denominator` makes a mean global."""
    total = out.sum()
    if _split_group is None or _micro_counts is not None:
        return total
    return total * _split_group.nranks


def _masked_mean(loss, loss_mask):
    """``sum(loss * mask) / max(sum(mask), 1)`` with the reference's ops:
    a float mask promotes with the loss (a bf16 loss with an f32 mask
    gives f32). The denominator counts over a split batch's data group
    (:func:`_denominator`)."""
    lm = T.reshape(loss_mask, loss.shape)
    if not lm.is_floating_point():
        lm = lm.to(loss.dtype)
    return T.divide(T.sum(T.multiply(loss, lm)), _denominator(T.sum(lm)))


def _reduce(out, reduction):
    """A mean over equal row counts is global as it is (the split cuts
    equal rows); a sum goes through :func:`_batch_sum`."""
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return _batch_sum(out)
    return out


def _hard_labels(label, ndim, axis):
    """Integer class ids: a trailing singleton class axis squeezed."""
    if label.dim() == ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    return label.long()


def _pick(logp, label, axis):
    return torch.gather(logp, axis, label.unsqueeze(axis)).squeeze(axis)


@amp_op("cross_entropy_op", "black")
def _cross_entropy(input, label, weight, ignore_index, reduction, soft_label,
                   axis, label_smoothing):
    axis = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=axis)
    if soft_label:
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1.0 - label_smoothing) \
                + label_smoothing / input.shape[axis]
        return _reduce(-(soft * logp).sum(axis), reduction)
    lbl = _hard_labels(label, input.dim(), axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = _pick(logp, safe, axis)
    if label_smoothing > 0.0:
        per = (-(1.0 - label_smoothing) * picked
               - label_smoothing * logp.mean(axis))
    else:
        per = -picked
    zero = torch.zeros((), dtype=per.dtype, device=per.device)
    if weight is not None:
        w = weight[safe]
        per = torch.where(valid, per * w, zero)
        if reduction == "mean":
            return per.sum() / _denominator(
                torch.where(valid, w, zero).sum(), 1e-12, torch.clamp)
    else:
        per = torch.where(valid, per, zero)
        if reduction == "mean":
            return per.sum() / _denominator(valid.float().sum(), 1.0,
                                            torch.clamp)
    return _reduce(per, reduction)


@amp_op("log_of")
def _log_of(x, eps):
    return torch.log(torch.clamp(x, min=eps))


@amp_op("nll_from_logp")
def _nll_from_logp(logp, label, weight, ignore_index, reduction, soft_label,
                   axis):
    axis = axis % logp.dim()
    if soft_label:
        return _reduce(-(label * logp).sum(axis), reduction)
    lbl = _hard_labels(label, logp.dim(), axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = _pick(logp, safe, axis)
    per = torch.where(valid, -picked, torch.zeros_like(picked))
    if weight is not None:
        per = per * weight[safe]
    if reduction == "mean":
        return per.sum() / _denominator(valid.float().sum(), 1.0,
                                            torch.clamp)
    return _reduce(per, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of ``input`` (logits along ``axis``) against
    ``label``: class ids (with a trailing singleton axis or without) or,
    with ``soft_label``, a distribution. ``reduction`` ``"mean"`` averages
    over the rows whose label is not ``ignore_index`` (weighted by
    ``weight`` where given), ``"sum"`` sums, ``"none"`` keeps them. With
    ``use_softmax=False`` the input is taken as probabilities."""
    if not use_softmax:
        return _nll_from_logp(_log_of(input, 1e-12), label, weight,
                              int(ignore_index), reduction, bool(soft_label),
                              int(axis))
    return _cross_entropy(input, label, weight, int(ignore_index), reduction,
                          bool(soft_label), int(axis), float(label_smoothing))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row cross entropy, the class axis kept with size 1; with
    ``return_softmax`` also the softmax of ``logits``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` ``[N, C, ...]``
    (or ``[C]``) at the class ids ``label``."""
    return _nll_from_logp(input, label, weight, int(ignore_index), reduction,
                          False, 1 if input.dim() > 1 else -1)


def mse_loss(input, label, reduction="mean", name=None):
    """``(input - label)^2``, averaged (``"mean"``), summed (``"sum"``) or
    kept elementwise (any other value), as in the reference."""
    return _reduce(torch.square(input - label), reduction)


__all__ = ["_denominator", "_masked_mean", "_parallel_softmax_ce", "cross_entropy",
           "mse_loss", "nll_loss", "softmax_with_cross_entropy"]
