"""Shared helpers of the PyTorch-port parity tests: a tiny reference GPT
built in ``paddle_tpu`` (JAX, CPU) and the numpy bridge of its weights."""
import contextlib

import numpy as np

from paddle_tpu.framework.op import raw

VOCAB = 61


def tiny_gpt_kwargs():
    return dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@contextlib.contextmanager
def no_mesh():
    """Run the reference with no hybrid-parallel group or global mesh in
    force (a fleet test may have left one behind in this interpreter)."""
    from paddle_tpu.distributed import mesh as _mesh
    from paddle_tpu.distributed.fleet.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)

    prev = get_hybrid_communicate_group()
    prev_mesh = _mesh.get_global_mesh()
    set_hybrid_communicate_group(None)
    _mesh.set_global_mesh(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)
        _mesh.set_global_mesh(prev_mesh)


@contextlib.contextmanager
def jax_tiny_gpt(seed=7):
    """The reference GPTForCausalLM at the tiny size, built and run under
    :func:`no_mesh`."""
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

    with no_mesh():
        paddle.seed(seed)
        m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs()))
        m.eval()
        yield m


def numpy_state(model):
    """The reference model's parameters as {name: ndarray}."""
    return {k: np.asarray(raw(v)) for k, v in model.state_dict().items()}


def torch_tiny_gpt(np_state):
    """The port's GPT on the CPU carrying the bridged reference weights."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs()), device="cpu")
    return m.load_numpy_state(np_state)
