"""Masked attention and attention dropout under the sequence split of the
PyTorch port (``nn/functional/ring_attention.py``), against the reference.

One spawn of 2 gloo ranks at sep 2 runs, on each rank's block of one
global q / k / v / dout:

- the plain ring and the kernels' route (the autograd function on the
  kernels' plain versions) under each mask layout: a ``[B, T_local]``
  bool padding block and a ``[B, 1, 1, T_local]`` additive padding bias
  (key-only: they rotate with K / V), a ``[B, 1, T_local, T]`` additive
  bias and a ``[1, 1, T_local, T]`` bool mask (query rows: sliced by the
  source block), with and without causal masking. The gathered blocks and
  gradients are held against the reference's ``_sdpa_reference`` (and its
  ``jax.vjp``) on the whole sequence, within the ring test's tolerance;
- the plain ring with attention dropout, against the port's unsplit plain
  attention under the keep mask its blocks tile
  (``ring_attention.dropout_keep_mask``), and the same call through
  ``scaled_dot_product_attention`` under the split with the flash route
  asked for (dropout goes to the plain ring);
- a tiny ERNIE masked LM with its padding mask for 3 AdamW steps through
  ``DistTrainStep`` on both routes, against the reference's ``TrainStep``
  in one process.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.nn.functional import ring_attention as ra

from torch_port_utils import (encoder_batch, jax_tiny_encoder, join_ranks,
                              numpy_state, sep_mask_job, spawn_ranks)

SEP = 2
B, T, H, D = 2, 32, 2, 8
TL = T // SEP
# tests/test_ring_attention.py's tolerance (the ring's block merge against
# one softmax)
RTOL, ATOL = 1e-4, 1e-5
DROP = dict(seed=11, p=0.3)
ERNIE_STEPS, ERNIE_LR = 3, 1e-2
LOSS_RTOL = 1e-5


def _masks(rng):
    """The global masks: padding keep masks that keep every row's first
    key (the reference's -inf softmax gives NaN on a row with none), a
    random bias, a bool mask that keeps the diagonal."""
    keep = np.ones((B, T), bool)
    keep[0, T - 13:] = False           # about 40 % of the keys masked
    keep[1, 5:T:2] = False
    rows = rng.random((T, T)) < 0.6
    np.fill_diagonal(rows, True)
    return dict(
        pad_bool=keep,
        pad_bias=np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None],
        rows_bias=rng.standard_normal((B, 1, T, T)).astype(np.float32),
        rows_bool=rows[None, None])


LAYOUTS = {"pad_bool": "pad", "pad_bias": "keys", "rows_bias": "rows",
           "rows_bool": "rows"}


def _cases(masks):
    return [dict(name=f"{m}_{'causal' if c else 'full'}", mask=masks[m],
                 layout=LAYOUTS[m], causal=c)
            for m in masks for c in (False, True)]


def _ref_attention(batch, mask, causal):
    """The reference's dense attention on the whole sequence and its
    q / k / v gradients under ``do``."""
    from paddle_tpu.nn.functional.attention import _sdpa_reference

    if mask.ndim == 2:  # a [B, T] padding mask
        mask = mask[:, None, None, :]
    q, k, v, do = (jnp.asarray(batch[x]) for x in ("q", "k", "v", "do"))
    out, vjp = jax.vjp(lambda a, b, c: _sdpa_reference(
        a, b, c, jnp.asarray(mask), 0.0, causal, None), q, k, v)
    dq, dk, dv = vjp(do)
    return {n: np.asarray(a) for n, a in
            dict(o=out, dq=dq, dk=dk, dv=dv).items()}


def _ernie_batch():
    ids, types, mask = encoder_batch(b=3, t=T, seed=6)
    rng = np.random.default_rng(6)
    labels = np.where((rng.random(ids.shape) < 0.3) & (mask > 0), ids, -100)
    labels[0, 0] = ids[0, 0]
    labels[2, T - 1] = -100
    return ids, types, mask, labels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import paddle_tpu as paddle
    from paddle_tpu.framework.core import Tensor
    from paddle_tpu.framework.op import raw
    from paddle_tpu.jit import TrainStep as RefTrainStep

    rng = np.random.default_rng(4)
    batch = {x: rng.standard_normal((B, T, H, D)).astype(np.float32)
             for x in ("q", "k", "v", "do")}
    cases = _cases(_masks(rng))
    eb = _ernie_batch()
    with jax_tiny_encoder("ernie", "ErnieForMaskedLM", train=True) as jm:
        state = numpy_state(jm)
        out = tmp_path_factory.mktemp("sep_mask")
        ctx = spawn_ranks(sep_mask_job, SEP, out, cases, batch, DROP,
                          dict(state=state, batch=eb, steps=ERNIE_STEPS,
                               lr=ERNIE_LR))

        def loss_fn(model, ids, types, mask, labels):
            return model(ids, types, attention_mask=mask, labels=labels)

        ref = RefTrainStep(jm, loss_fn, paddle.optimizer.AdamW(
            learning_rate=ERNIE_LR, parameters=jm.parameters(),
            weight_decay=0.01))
        ernie_ref = [float(np.asarray(raw(ref(*(Tensor(jnp.asarray(x))
                                                for x in eb)))))
                     for _ in range(ERNIE_STEPS)]
    refs = {c["name"]: _ref_attention(batch, c["mask"], c["causal"])
            for c in cases}
    ranks = sorted(join_ranks(ctx, out), key=lambda r: r["sep_rank"])
    return dict(ranks=ranks, refs=refs, batch=batch, cases=cases,
                ernie_ref=ernie_ref)


def _gathered(ranks, name, route, key):
    return np.concatenate([r[name][route][key] for r in ranks], axis=1)


CASE_NAMES = [f"{m}_{c}" for m in LAYOUTS for c in ("full", "causal")]


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_masked_ring_matches_whole_sequence(runs, name, route):
    want = runs["refs"][name]
    for key in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(
            _gathered(runs["ranks"], name, route, key), want[key],
            rtol=RTOL, atol=ATOL, err_msg=f"{name} {route} {key}")
    for r in runs["ranks"]:
        # the ring really ran: K / V (and a key bias) forward, dK / dV home
        extra = (SEP - 1) if LAYOUTS[name.rsplit("_", 1)[0]] in (
            "pad", "keys") else 0
        assert r[name][route]["p2p"] == 2 * (SEP - 1) + extra


def test_key_rows_that_see_no_key_emit_zeros():
    """A row masked everywhere gives zeros on both routes (K1's rule),
    one rank standing for the ring (its own block is every key)."""
    from paddle_tpu_torch.distributed.env import Group

    g = Group([0])
    q = torch.randn(1, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    mask[..., 2, :] = False
    for fn in (ra.ring_flash_attention_plain, ra.ring_flash_attention):
        o = fn(q, q, q, g, mask=mask)
        assert torch.all(o[:, 2] == 0)
        assert torch.all(o[:, :2].abs().sum(-1) > 0)


@pytest.mark.parametrize("shape", [(B, 1, TL, TL), (B, 1, 3, T), (TL, TL),
                                   (B, 3, 1, TL)])
def test_other_mask_layouts_raise(shape):
    with pytest.raises(ValueError, match="split"):
        ra.split_bias(torch.zeros(shape), B, H, TL, SEP)


def _dense_with_keep(q, k, v, keep, p):
    """The unsplit plain attention (causal) under the keep mask ``keep``
    ``[B * H, T, T]`` at rate ``p``."""
    b, t, h, d = q.shape
    qf, kf, vf = (x.transpose(1, 2).reshape(b * h, t, d) for x in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) / d ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    probs = torch.softmax(torch.where(causal, s, float("-inf")), dim=-1)
    out = torch.einsum("bqk,bkd->bqd",
                       torch.where(keep, probs / (1 - p), 0.0), vf)
    return out.reshape(b, h, t, d).transpose(1, 2)


def test_dropout_under_the_split_equals_the_unsplit_keep_mask(runs):
    torch.manual_seed(DROP["seed"])
    seed = ra.draw_dropout_seed()
    keep = torch.cat([torch.cat([
        ra.dropout_keep_mask(seed, i, j, (B * H, TL, TL), DROP["p"], "cpu")
        for j in range(SEP)], dim=2) for i in range(SEP)], dim=1)
    q, k, v = (torch.from_numpy(runs["batch"][x]).requires_grad_()
               for x in ("q", "k", "v"))
    o = _dense_with_keep(q, k, v, keep, DROP["p"])
    o.backward(torch.from_numpy(runs["batch"]["do"]))
    drop = [r["dropout"] for r in runs["ranks"]]
    got = {key: np.concatenate([d[key] for d in drop], axis=1)
           for key in ("o", "dq", "dk", "dv", "sdpa")}
    for key, want in (("o", o), ("dq", q.grad), ("dk", k.grad),
                      ("dv", v.grad)):
        np.testing.assert_allclose(got[key], want.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # the split's flash route with dropout active is the plain ring
    np.testing.assert_array_equal(got["sdpa"], got["o"])
    kept = keep.float().mean().item()
    assert abs(kept - (1 - DROP["p"])) < 0.05


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_ernie_with_padding_at_sep2_matches_reference(runs, route):
    for r in runs["ranks"]:
        got = r[f"ernie_{route}"]
        np.testing.assert_allclose(got["losses"], runs["ernie_ref"],
                                   rtol=LOSS_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        assert got["p2p"] > 0  # the ring ran
