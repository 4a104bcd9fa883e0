"""GPT of the PyTorch port against the reference on bridged weights."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu_torch.framework.io_state import state_from_numpy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

from torch_port_utils import (VOCAB, jax_tiny_gpt, numpy_state,
                              tiny_gpt_kwargs, torch_tiny_gpt)

# f32 forward through two blocks and a tied LM head on both sides: the
# frameworks' matmul / layer-norm reduction orders differ by ulps
ATOL = 1e-4


@pytest.fixture(scope="module")
def bridged():
    with jax_tiny_gpt() as jm:
        state = numpy_state(jm)
        yield jm, state, torch_tiny_gpt(state)


def test_bridge_names_equal_reference_state_dict(bridged):
    _, state, tm = bridged
    assert list(tm.state_dict()) == list(state)
    assert tuple(tm.state_dict()[
        "gpt.decoder.0.attn.qkv_proj.weight"].shape) == (32, 96)


@pytest.mark.parametrize("t", [1, 7, 19])
def test_full_forward_logits_match(bridged, t):
    jm, _, tm = bridged
    ids = np.random.default_rng(t).integers(0, VOCAB, (2, t))
    ref = np.asarray(raw(jm(Tensor(jnp.asarray(ids)))))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, t, VOCAB)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_explicit_position_ids_match(bridged):
    jm, _, tm = bridged
    rng = np.random.default_rng(5)
    ids = rng.integers(0, VOCAB, (2, 6))
    pos = np.stack([np.arange(3, 9), np.arange(10, 16)])
    ref = np.asarray(raw(jm(Tensor(jnp.asarray(ids)),
                            Tensor(jnp.asarray(pos)))))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_bridge_rejects_wrong_name_and_shape(bridged):
    _, state, tm = bridged
    renamed = dict(state)
    renamed["gpt.decoder.0.attn.qkv.weight"] = renamed.pop(
        "gpt.decoder.0.attn.qkv_proj.weight")
    with pytest.raises(KeyError, match="qkv_proj"):
        tm.load_numpy_state(renamed)
    extra = dict(state, **{"lm_head.weight": np.zeros((32, VOCAB))})
    with pytest.raises(KeyError, match="lm_head"):
        tm.load_numpy_state(extra)
    reshaped = dict(state)
    reshaped["gpt.decoder.1.mlp.fc_in.weight"] = np.zeros((128, 32),
                                                          np.float32)
    with pytest.raises(ValueError, match="fc_in"):
        tm.load_numpy_state(reshaped)


def test_state_from_numpy_casts_onto_device():
    out = state_from_numpy({"w": np.ones((2, 3), np.float64)}, "cpu",
                           torch.float32)
    assert out["w"].dtype == torch.float32 and out["w"].device.type == "cpu"


def test_model_builds_from_explicit_generator():
    cfg = GPTConfig(**tiny_gpt_kwargs())
    a = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = GPTForCausalLM(cfg, device="cpu", seed=3)
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert all(p.device.type == "cpu" for p in a.parameters())


def test_gpt3_1p3b_geometry():
    c = GPTConfig.gpt3_1p3b()
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads,
            c.vocab_size, c.max_position_embeddings,
            c.intermediate_size) == (2048, 24, 16, 50304, 2048, 8192)


def test_sdpa_matches_reference_with_mask():
    from paddle_tpu.nn.functional import attention as ref_attn

    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    ref = np.asarray(ref_attn._sdpa_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        0.0, True, None))
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=torch.from_numpy(bias), is_causal=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
