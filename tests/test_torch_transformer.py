"""``nn.MultiHeadAttention`` and the ``Transformer*`` stacks of the PyTorch
port (``paddle_tpu_torch/nn/layers/transformer.py``) against the
reference's on the CPU, on bridged weights (embed 32, 4 heads of 8).

- MHA with no cache, under a bool keep-mask ``[B, 1, Tq, Tk]`` and an
  additive float mask ``[Tq, Tk]``, cross-attention with ``kdim`` /
  ``vdim``, ``need_weights``: outputs, and the input and projection
  gradients under a seeded cotangent;
- the three incremental caches of a ``TransformerDecoder`` (2 layers):
  the ``Cache`` growing by concatenation, the ``Cache`` of ``max_length``
  positions written at ``cache_position``, the ``PagedCache`` (page size
  3, which does not divide ``max_length``; the pool and identity table of
  ``tests/test_paged_kv.py::test_transformer_paged_cache_matches_static``):
  a 3-token prefix, then one token a step, each step's output against
  the reference's same route and against the uncached decoder;
- ``Transformer`` (2 + 2 layers) forward and gradients under a source
  padding mask and the causal target mask (the key projections' biases,
  whose gradient is 0, within rel 1e-4 of the largest gradient);
- one greedy stream (a seeded embedding and head in numpy on both
  sides) equal across the three caches and to the reference's.

Tolerance: outputs within rel 1e-5 of the largest reference magnitude,
gradients within rel 1e-4; greedy streams equal."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import load_numpy_state

from torch_port_utils import numpy_state, one_torch_thread  # noqa: F401

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
E, H, FF = 32, 4, 64
B, TS, PREFIX, NEW, VOCAB = 2, 6, 3, 6, 23
MAX_LEN = PREFIX + NEW + 1
ROUTES = ("concat", "static", "paged")


def close(got, want, rtol, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


def rt(a, grad=False):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


def pt(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _pair(make_ref, make_port, seed=3):
    paddle.seed(seed)
    ref = make_ref()
    ref.eval()
    port = load_numpy_state(make_port(), numpy_state(ref))
    port.eval()
    return ref, port


def _mha(**kw):
    return _pair(lambda: rnn.MultiHeadAttention(E, H, **kw),
                 lambda: tnn.MultiHeadAttention(E, H, device="cpu", **kw))


def _data(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bool_mask(seed=1):
    m = np.random.default_rng(seed).random((B, 1, 5, 7)) > 0.4
    m[..., 0] = True                     # every query row keeps a key
    return m


MHA_CASES = {
    "plain": dict(),
    "bool_mask": dict(mask="bool"),
    "float_mask": dict(mask="float"),
    "cross_kdim_vdim": dict(layer=dict(kdim=24, vdim=20)),
    "need_weights": dict(layer=dict(need_weights=True)),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_multi_head_attention_matches_reference(case):
    spec = MHA_CASES[case]
    lkw = spec.get("layer", {})
    ref, port = _mha(**lkw)
    q, k, v, w = _data((B, 5, E), (B, 7, lkw.get("kdim", E)),
                       (B, 7, lkw.get("vdim", E)), (B, 5, E))
    cross = "kdim" in lkw or spec.get("mask")
    mask = None
    if spec.get("mask") == "bool":
        mask = _bool_mask()
    elif spec.get("mask") == "float":
        mask = np.where(np.tril(np.ones((5, 7))), 0.0, -1e4).astype(
            np.float32)
    rq, pq = rt(q, True), pt(q, True)
    rargs = (rq, rt(k), rt(v)) if cross else (rq,)
    pargs = (pq, pt(k), pt(v)) if cross else (pq,)
    ro = ref(*rargs, attn_mask=None if mask is None else rt(mask))
    po = port(*pargs, attn_mask=None if mask is None else pt(mask))
    if lkw.get("need_weights"):
        assert isinstance(po, tuple) and po[1] is None
        ro, po = ro[0], po[0]
    close(po.detach().numpy(), np.asarray(raw(ro)), FWD_RTOL, "output")
    (ro * rt(w)).sum().backward()
    (po * pt(w)).sum().backward()
    close(pq.grad.numpy(), np.asarray(raw(rq.grad)), GRAD_RTOL, "dq")
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        close(getattr(port, name).weight.grad.numpy(),
              np.asarray(raw(getattr(ref, name).weight.grad)), GRAD_RTOL,
              f"{name}.weight grad")


def _decoders():
    return _pair(lambda: rnn.TransformerDecoder(
        rnn.TransformerDecoderLayer(E, H, FF, dropout=0.0), 2),
        lambda: tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
            E, H, FF, dropout=0.0, device="cpu"), 2))


def _gen_cache(dec, mem, route):
    if route == "concat":
        return dec.gen_cache(mem)
    if route == "static":
        return dec.gen_cache(mem, max_length=MAX_LEN)
    return dec.gen_cache(mem, max_length=MAX_LEN, page_size=3)


def _decode_steps(dec, mask_fn, wrap, x, mem, route):
    """The decoder's outputs over ``x`` [B, T, E]: the prefix in one call,
    then one position a call, through ``route``'s cache."""
    cache = _gen_cache(dec, mem, route)
    outs = []
    spans = [(0, PREFIX)] + [(i, i + 1) for i in range(PREFIX, x.shape[1])]
    for a, b in spans:
        xt = wrap(x[:, a:b])
        if route == "concat":
            mask = mask_fn(b - a) if b - a > 1 else None
            o, cache = dec(xt, mem, mask, None, cache)
        else:
            o, cache = dec(xt, mem, cache=cache, cache_position=a)
        outs.append(o)
    return cache, outs


def _ref_mask(n):
    return rnn.Transformer.generate_square_subsequent_mask(n)


def _port_mask(n):
    return tnn.Transformer.generate_square_subsequent_mask(n, device="cpu")


@pytest.mark.parametrize("route", ROUTES)
def test_decoder_caches_match_reference_and_uncached(route):
    ref, port = _decoders()
    x, mem = _data((B, PREFIX + 4, E), (B, TS, E))
    rmem, pmem = rt(mem), pt(mem)
    rc, rout = _decode_steps(ref, _ref_mask, rt, x, rmem, route)
    pc, pout = _decode_steps(port, _port_mask, pt, x, pmem, route)
    full = port(pt(x), pmem, _port_mask(x.shape[1]))
    for i, (r, p) in enumerate(zip(rout, pout)):
        close(p.detach().numpy(), np.asarray(raw(r)), FWD_RTOL, f"step {i}")
    close(torch.cat(pout, 1).detach().numpy(), full.detach().numpy(),
          FWD_RTOL, "cached vs uncached")
    if route == "paged":
        pool = pc[0][0].k
        assert tuple(pool.shape) == (1 + B * 4, H, 3, E // H)
        table = pc[0][0].page_table
        np.testing.assert_array_equal(
            table.numpy(), np.asarray(raw(rc[0][0].page_table)))
        np.testing.assert_array_equal(table.numpy(),
                                      np.arange(B * 4).reshape(B, 4) + 1)
        assert pool[0].abs().max() == 0            # the trash page unused
        np.testing.assert_allclose(pool.numpy(), np.asarray(raw(rc[0][0].k)),
                                   rtol=0, atol=1e-6)


def _transformers():
    return _pair(lambda: rnn.Transformer(E, H, 2, 2, FF, dropout=0.0),
                 lambda: tnn.Transformer(E, H, 2, 2, FF, dropout=0.0,
                                         device="cpu"))


def test_transformer_forward_and_gradients_match_reference():
    ref, port = _transformers()
    src, tgt, w = _data((B, TS, E), (B, 5, E), (B, 5, E))
    keep = np.ones((B, 1, 1, TS), bool)
    keep[1, ..., -2:] = False            # row 1's last two source tokens
    rs, ps = rt(src, True), pt(src, True)
    ro = ref(rs, rt(tgt), src_mask=rt(keep), tgt_mask=_ref_mask(5),
             memory_mask=rt(keep))
    po = port(ps, pt(tgt), src_mask=pt(keep), tgt_mask=_port_mask(5),
              memory_mask=pt(keep))
    close(po.detach().numpy(), np.asarray(raw(ro)), FWD_RTOL, "output")
    (ro * rt(w)).sum().backward()
    (po * pt(w)).sum().backward()
    close(ps.grad.numpy(), np.asarray(raw(rs.grad)), GRAD_RTOL, "dsrc")
    rgrads = {n: np.asarray(raw(p.grad)) for n, p in ref.named_parameters()}
    top = max(float(np.abs(g).max()) for g in rgrads.values())
    for n, p in port.named_parameters():
        if n.endswith("k_proj.bias"):
            # a key bias shifts every logit of a query row alike: its
            # gradient is 0, float noise on both sides
            assert float(p.grad.abs().max()) <= GRAD_RTOL * top, n
            continue
        close(p.grad.numpy(), rgrads[n], GRAD_RTOL, n)


def _greedy(model, route, src_ids, emb, head, wrap, mask_fn, to_np):
    """Greedy tokens after ``PREFIX`` seeded tokens: embeddings and head in
    numpy, the model between them."""
    mem = model.encoder(wrap(emb[src_ids]))
    rng = np.random.default_rng(4)
    toks = [list(r) for r in rng.integers(0, VOCAB, (B, PREFIX))]
    cache = _gen_cache(model.decoder, mem, route)
    pos, feed = 0, np.array(toks)
    for _ in range(NEW):
        x = wrap(emb[feed])
        t = feed.shape[1]
        if route == "concat":
            out, cache = model.decoder(x, mem, mask_fn(t) if t > 1 else None,
                                       None, cache)
        else:
            out, cache = model.decoder(x, mem, cache=cache,
                                       cache_position=pos)
        pos += t
        nxt = (to_np(out)[:, -1].astype(np.float64) @ head).argmax(-1)
        for row, n in zip(toks, nxt):
            row.append(int(n))
        feed = nxt[:, None]
    return [r[PREFIX:] for r in toks]


def test_greedy_stream_equal_across_caches_and_reference():
    ref, port = _transformers()
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((VOCAB, E)).astype(np.float32)
    head = rng.standard_normal((E, VOCAB))
    src = rng.integers(0, VOCAB, (B, TS))
    streams = {}
    for route in ROUTES:
        streams[("port", route)] = _greedy(
            port, route, src, emb, head, pt, _port_mask,
            lambda o: o.detach().numpy())
        streams[("ref", route)] = _greedy(
            ref, route, src, emb, head, rt, _ref_mask,
            lambda o: np.asarray(raw(o)))
    first = streams[("ref", "concat")]
    assert len(first[0]) == NEW
    for k, s in streams.items():
        assert s == first, k


def test_paged_cache_needs_a_position_and_a_length():
    _, port = _mha()
    x = pt(_data((B, 2, E))[0])
    with pytest.raises(ValueError, match="max_length"):
        port.gen_cache(x, page_size=4)
    cache = port.gen_cache(x, max_length=8, page_size=4)
    with pytest.raises(ValueError, match="cache_position"):
        port(x, cache=cache)
