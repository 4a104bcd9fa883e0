"""Losses of the port.

``mse_loss`` mirrors ``paddle_tpu/nn/functional/loss.py::mse_loss``.
``_parallel_softmax_ce`` is the counterpart of
``paddle_tpu/distributed/fleet/layers/mpu.py::_parallel_softmax_ce`` (the
loss under ``GPTPretrainingCriterion``) at model-parallel degree 1: plain
tensor ops, as in the reference, where it is jnp and no kernel. It is on
neither AMP list, as in the reference: under ``auto_cast`` it runs in the
logits' dtype, bf16 included (upstream Paddle keeps its softmax cross
entropy in f32; ROADMAP.md C lists the difference).
"""
from __future__ import annotations

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


def _masked_mean(loss, loss_mask):
    """``sum(loss * mask) / max(sum(mask), 1)`` with the reference's ops:
    a float mask promotes with the loss (a bf16 loss with an f32 mask
    gives f32)."""
    lm = T.reshape(loss_mask, loss.shape)
    if not lm.is_floating_point():
        lm = lm.to(loss.dtype)
    return T.divide(T.sum(T.multiply(loss, lm)), T.clip(T.sum(lm), min=1.0))


def mse_loss(input, label, reduction="mean", name=None):
    """``(input - label)^2``, averaged (``"mean"``), summed (``"sum"``) or
    kept elementwise (any other value), as in the reference."""
    out = torch.square(input - label)
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


__all__ = ["_masked_mean", "_parallel_softmax_ce", "mse_loss"]
