"""``F.decode_attention`` of the PyTorch port (``paddle_tpu_torch/nn/
functional/attention.py``) against the reference's on the CPU: one query
row per slot over a ``[S, Hkv, T, D]`` cache, keys past each slot's
``cache_position`` masked (positions differ per slot, one slot at 0 so a
single key is visible), grouped-query heads G in {1, 4} without
replication, the default scale ``1 / sqrt(D)`` and an explicit one. The
cache beyond each position holds large garbage, so an unmasked key would
show. Tolerance: atol 1e-5 on f32 outputs of magnitude ~1.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.op import raw
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch.nn import functional as TF

from torch_port_utils import no_mesh

ATOL = 1e-5
S, HKV, T, D = 3, 2, 24, 16


def _inputs(group, seed=0):
    rng = np.random.default_rng(seed)
    h = HKV * group
    q = rng.standard_normal((S, 1, h, D)).astype(np.float32)
    ck = rng.standard_normal((S, HKV, T, D)).astype(np.float32)
    cv = rng.standard_normal((S, HKV, T, D)).astype(np.float32)
    pos = np.array([0, 9, T - 1], np.int32)
    for s, p in enumerate(pos):  # garbage past each slot's position
        ck[s, :, p + 1:] = 50.0
        cv[s, :, p + 1:] = 1e3
    return q, ck, cv, pos


@pytest.mark.parametrize("scale", [None, 0.3], ids=["default", "explicit"])
@pytest.mark.parametrize("group", [1, 4], ids=["G1", "G4"])
def test_decode_attention_matches_reference(group, scale):
    q, ck, cv, pos = _inputs(group)
    with no_mesh():
        want = np.asarray(raw(RF.decode_attention(
            paddle.to_tensor(q), paddle.to_tensor(ck), paddle.to_tensor(cv),
            paddle.to_tensor(pos), scale=scale)))
    got = TF.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), torch.from_numpy(pos),
                              scale=scale)
    assert got.shape == (S, 1, HKV * group, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # slot 0 sees its single key: the output is that key's value row
    np.testing.assert_allclose(
        got[0, 0].numpy(), np.repeat(cv[0, :, 0], group, axis=0), atol=ATOL)
    assert np.abs(got.numpy()).max() < 10.0  # no garbage value leaked


def test_decode_attention_groups_heads_without_replication():
    """G = 4 equals G = 1 over kv heads repeated to every query head
    (query head h reads kv head h // 4)."""
    q, ck, cv, pos = _inputs(4, seed=1)
    args = [torch.from_numpy(a) for a in (q, ck, cv, pos)]
    grouped = TF.decode_attention(*args)
    rep = [torch.from_numpy(a).repeat_interleave(4, dim=1) for a in (ck, cv)]
    flat = TF.decode_attention(args[0], *rep, args[3])
    torch.testing.assert_close(grouped, flat, rtol=0, atol=ATOL)
