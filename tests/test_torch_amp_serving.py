"""A ``decorate``d O2 bf16 model served by the PyTorch port's
``DecodeEngine`` against the reference's engine, and the bf16 query of the
paged attention (K3's plain version) against the reference's oracle.

Both packages decorate the same weights: the reference model is decorated
(every parameter bf16) and its state bridged through
``torch_port_utils.numpy_state`` (bf16 widened to f32, exact) into a port
model decorated alike, so the bf16 parameters are equal bit for bit. Both
engines then run every hook in bf16 (embeddings, norms, projections, K3's
query and output, MLP, logits) and cast the logits to f32 before sampling.

Tolerance. XLA on the CPU and torch on the CPU round a bf16 layer's
intermediates at different points (the reference's layer norm rounds
``x - mean`` and the variance to bf16, torch's fuses them in f32), so the
logits part by a few bf16 roundings: the measured worst first-step gap is
4.3 u of the largest logit (u = 2^-8, bf16's unit roundoff; GPT 0.0059 at
0.35, Llama at G = 4 0.023 at 2.5), held at ``LOGIT_RTOL`` = 8 u. Greedy streams
are equal, or part where the reference's own top-2 logits lie within twice
that gap (a near tie, measured margins 0 to 0.016): the reference's full
forward over the common context gives the margin.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.op import raw
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.nn import functional as PF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.inference.engine import DecodeEngine
from paddle_tpu_torch.ops import paged_attention as tpa

from test_torch_paged_attention import _case
from torch_port_utils import (VOCAB, jax_tiny_gpt, jax_tiny_llama,
                              numpy_state, tiny_gpt_kwargs,
                              tiny_llama_kwargs)

BF16_U = 2.0 ** -8
LOGIT_RTOL = 8 * BF16_U
NEW_TOKENS = 12
GEOMETRY = dict(num_slots=3, max_length=64, page_size=4)


def _prompts():
    """4 mixed-length requests; the first two share two full pages."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, VOCAB, 8)
    return [np.concatenate([shared, rng.integers(1, VOCAB, 3)]),
            np.concatenate([shared, rng.integers(1, VOCAB, 6)]),
            rng.integers(1, VOCAB, 5),
            np.concatenate([rng.integers(1, VOCAB, 4)] * 3)]


def _serve(engine):
    rids = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in _prompts()]
    engine.run()
    return [np.asarray(engine.result(r)).tolist() for r in rids]


def _port_twin(kind, state, group):
    """The port's model of ``kind``, decorated O2 bf16, carrying the
    decorated reference's state."""
    if kind == "gpt":
        from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

        m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs()), device="cpu")
    else:
        from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                        LlamaForCausalLM)

        m = LlamaForCausalLM(LlamaConfig(**tiny_llama_kwargs(group=group)),
                             device="cpu")
    m = tamp.decorate(m, level="O2", dtype="bfloat16")
    m.load_numpy_state(state)
    m.eval()
    return m


@pytest.fixture(scope="module", params=[("gpt", 1), ("llama", 4)],
                ids=["gpt", "llama_g4"])
def decorated(request):
    kind, group = request.param
    ctx = jax_tiny_gpt() if kind == "gpt" else jax_tiny_llama(group=group)
    with ctx as jm:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        yield kind, jm, _port_twin(kind, numpy_state(jm), group)


def _ref_logits(jm, ids):
    out = jm(paddle.to_tensor(np.asarray(ids)[None]))
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(raw(out)).astype(np.float32)[0, -1]


def test_decorated_parameters_bridge_bit_for_bit(decorated):
    _, jm, tm = decorated
    want = {k: np.asarray(raw(v)) for k, v in jm.state_dict().items()}
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        if want[k].dtype.name == "bfloat16":
            assert v.dtype == torch.bfloat16, k
        assert np.array_equal(v.float().numpy(),
                              want[k].astype(np.float32)), k


def test_first_step_logits_within_bf16_rounding(decorated):
    """The full forward's last-position logits of the longest prompt (the
    reference's eager bf16 forward takes seconds a shape on the CPU)."""
    _, jm, tm = decorated
    for p in _prompts()[3:]:
        want = _ref_logits(jm, p)
        with torch.no_grad():
            out = tm(torch.as_tensor(p[None]))
        got = (out[0] if isinstance(out, tuple) else out)[0, -1]
        assert got.dtype == torch.bfloat16
        gap = np.abs(got.float().numpy() - want).max()
        assert gap <= LOGIT_RTOL * np.abs(want).max(), gap


CASES = {"gpt": [("f32", 0), ("bf16", 2), ("int8", 2)],
         "llama": [("f32", 2), ("int8", 0)]}


def test_served_streams_equal_reference(decorated):
    """Both engines on the decorated model, kv f32 / bf16 / int8 and
    speculation off / on: greedy streams equal up to a reported near tie
    of the reference's own logits."""
    kind, jm, tm = decorated
    for kv, k in CASES[kind]:
        cfg = dict(GEOMETRY, kv_dtype=kv, speculate_k=k, spec_adaptive=False)
        ref = _serve(ref_engine.DecodeEngine(jm, attn_kernel="einsum", **cfg))
        eng = DecodeEngine(tm, device="cpu", **cfg)
        got = _serve(eng)
        assert eng.last_step[1].dtype == torch.float32
        for i, (a, b) in enumerate(zip(got, ref)):
            assert len(a) == len(b) == len(_prompts()[i]) + NEW_TOKENS
            if a == b:
                continue
            j = next(x for x in range(len(a)) if a[x] != b[x])
            lg = _ref_logits(jm, b[:j])
            top = np.sort(lg)[-2:]
            margin = top[1] - top[0]
            assert {a[j], b[j]} <= set(np.argsort(lg)[-2:].tolist()), (
                kv, k, i, j)
            assert margin <= 2 * LOGIT_RTOL * np.abs(lg).max(), (
                f"kv={kv} k={k} request {i} parts at position {j} with a "
                f"top-2 margin of {margin}")


def test_export_import_carry_a_bf16_model():
    """Disaggregated prefill of a decorated model: the decode engine that
    imports the pages (bf16 slabs) emits the streams of one engine that
    did both."""
    from paddle_tpu_torch.inference.engine import SamplingParams
    from torch_port_utils import torch_tiny_gpt

    with jax_tiny_gpt() as jm:
        state = numpy_state(jm)
    tm = tamp.decorate(torch_tiny_gpt(state), level="O2")
    prompts = _prompts()[:GEOMETRY["num_slots"]]
    cfg = dict(GEOMETRY, kv_dtype="bf16", speculate_k=2, spec_adaptive=False)
    one = DecodeEngine(tm, device="cpu", **cfg)
    rids = [one.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    one.run()
    want = [np.asarray(one.result(r)).tolist() for r in rids]
    pre = DecodeEngine(tm, device="cpu", **cfg)
    dec = DecodeEngine(tm, device="cpu", **cfg)
    params = SamplingParams(max_new_tokens=NEW_TOKENS)
    rids = []
    for p in prompts:
        kv = pre.prefill_export(p, params)
        assert kv["dtype"] == "bfloat16"
        rids.append(dec.try_import_prefill(p, params, kv))
    dec.run()
    assert [np.asarray(dec.result(r)).tolist() for r in rids] == want


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("t, group", [(1, 1), (3, 2), (8, 1)])
def test_plain_k3_bf16_query_matches_reference_oracle(kv, t, group):
    """``paged_attention_plain`` on a bf16 query returns bf16, equal to the
    reference's einsum oracle on the same bf16 query within one bf16
    rounding of the output (both compute in f32 and round once)."""
    rng = np.random.default_rng(3)
    q, kp, vp, ks, vs, table, start = _case(rng, t=t, hkv=2, group=group,
                                            page_size=4, kv=kv)
    qb = torch.from_numpy(q).bfloat16()
    pool = (lambda x: torch.from_numpy(x).bfloat16()) if kv == "bf16" \
        else torch.from_numpy
    jpool = (lambda x: jnp.asarray(x, jnp.bfloat16)) if kv == "bf16" \
        else jnp.asarray
    sc = {} if ks is None else dict(k_scales=torch.from_numpy(ks),
                                    v_scales=torch.from_numpy(vs))
    got = tpa.paged_attention_plain(qb, pool(kp), pool(vp),
                                    torch.from_numpy(table),
                                    torch.from_numpy(start), **sc)
    want = PF.paged_attention(
        paddle.to_tensor(jnp.asarray(qb.float().numpy(), jnp.bfloat16)),
        paddle.to_tensor(jpool(kp)), paddle.to_tensor(jpool(vp)),
        paddle.to_tensor(table), paddle.to_tensor(start),
        k_scales=None if ks is None else paddle.to_tensor(ks),
        v_scales=None if vs is None else paddle.to_tensor(vs),
        kernel="einsum")
    want = np.asarray(raw(want))
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    w = want.astype(np.float32)
    assert np.abs(got.float().numpy() - w).max() <= \
        2 * BF16_U * np.abs(w).max()
    # the f32 query keeps its f32 output
    assert tpa.paged_attention_plain(
        qb.float(), pool(kp), pool(vp), torch.from_numpy(table),
        torch.from_numpy(start), **sc).dtype == torch.float32


def test_kernel_takes_bf16_and_refuses_fp16_query():
    q = torch.zeros((2, 1, 4, 64))
    pool = torch.zeros((5, 2, 4, 64))
    table = torch.zeros((2, 3), dtype=torch.int32)
    start = torch.zeros((2,), dtype=torch.int32)
    tpa._check_cuda(q.bfloat16(), pool, pool, table, start, None, None)
    with pytest.raises(TypeError, match="float16"):
        tpa._check_cuda(q.half(), pool, pool, table, start, None, None)
