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


# -- TF32 emulation (the tensor-core products of kernels K1, K2 and K3) ------

def tf32_round(x):
    """``cvt.rna.tf32.f32`` on a f32 tensor: round to 10 mantissa bits,
    to nearest with ties away from zero (add half of the 13 dropped bits
    to the magnitude's bit pattern, then clear them)."""
    import torch

    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What a TF32 tensor core reads of a f32 operand: its top 19 bits
    (the low 13 mantissa bits dropped)."""
    import torch

    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def tf32_split(x):
    """The kernels' split as the tensor core sees it: ``hi`` = x rounded
    to TF32 (``cvt.rna``), ``lo`` = the exact remainder ``x - hi`` read to
    TF32 (truncated)."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x.float() - hi)


def tf32_split_trunc(x):
    """The backward kernels' split (K2a, K2b) as the tensor core sees it:
    ``hi`` = x read to TF32 (truncated), ``lo`` = the exact remainder
    ``x - trunc(x)`` read to TF32 (truncated)."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x.float() - hi)


def tf32_matmul(a, b, passes, split="rna"):
    """``a @ b`` as the kernels compute it on TF32 tensor cores: products
    of TF32 operands are exact and summed in (here: better than) f32.
    ``passes`` 1: one TF32 product of the operands as the tensor core reads
    them; 2: ``a`` split, ``b`` already exact in TF32 (a bf16 or int8
    value); 3: both split, ``lo.hi + hi.lo + hi.hi``. ``split``: ``"rna"``
    (hi rounded, :func:`tf32_split`: K1, K3) or ``"trunc"`` (hi truncated,
    :func:`tf32_split_trunc`: K2a, K2b). Returns f32."""
    import torch

    def mm(x, y):
        return torch.matmul(x.double(), y.double())

    read, halves = {"rna": (tf32_round, tf32_split),
                    "trunc": (tf32_trunc, tf32_split_trunc)}[split]
    if passes == 1:
        out = mm(read(a), read(b))
    elif passes == 2:
        if not torch.equal(tf32_round(b), b.float()):
            raise ValueError("two-pass products need b exact in TF32")
        ah, al = halves(a)
        out = mm(al, b) + mm(ah, b)
    elif passes == 3:
        ah, al = halves(a)
        bh, bl = halves(b)
        out = mm(al, bh) + mm(ah, bl) + mm(ah, bh)
    else:
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    return out.float()
