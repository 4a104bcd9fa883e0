"""The port's tensor-parallel layers at mp = 2 (two processes, gloo, the
CPU) on bridged weights, against the reference's layers under its fleet
(``tests/test_distributed.py::test_mp_layers_match_dense``'s pattern):
Column / Row / VocabParallel forward and gradients (each rank's shard
gradients gathered to the full ones), ``ParallelCrossEntropy`` with
``ignore_index``, the sequence-parallel ops, ``paddle.distributed.split``,
the RNG tracker and the full <-> shard weight round trip."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed.fleet.layers import mpu as ref_mpu
from paddle_tpu.distributed.fleet.utils import (
    sequence_parallel_utils as ref_spu)
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.distributed.fleet.layers import mpu

from torch_port_utils import (join_ranks, mpu_inputs, mpu_job, no_mesh,
                              numpy_state, spawn_ranks, tiny_gpt_kwargs)

MP = 2
# f32 products of 8-16 terms and their gradients, summed in other orders
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp = mpu_inputs()
    with no_mesh():
        paddle.seed(3)
        gpt = numpy_state(GPTForCausalLM(GPTConfig(
            **tiny_gpt_kwargs(vocab_size=64))))
    out = tmp_path_factory.mktemp("mpu")
    ctx = spawn_ranks(mpu_job, MP, out, inp, gpt)
    try:
        ref = _reference(inp)
    finally:
        port = join_ranks(ctx, out)
    return inp, gpt, ref, port


def _t(v):
    return Tensor(jnp.asarray(v))


def _grads(layer):
    return {n: np.asarray(raw(p.grad)) for n, p in layer.named_parameters()}


def _reference(inp):
    out = {}
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, mp_degree=MP)
        ref_fleet.init(is_collective=True, strategy=s)
        for gather_output, input_is_parallel in ((False, True),
                                                 (True, False)):
            col = ref_fleet.meta_parallel.ColumnParallelLinear(
                8, 16, gather_output=gather_output)
            row = ref_fleet.meta_parallel.RowParallelLinear(
                16, 8, input_is_parallel=input_is_parallel)
            col.set_state_dict({"weight": _t(inp["col_w"]),
                                "bias": _t(inp["col_b"])})
            row.set_state_dict({"weight": _t(inp["row_w"]),
                                "bias": _t(inp["row_b"])})
            ref_fleet.shard_model_parameters(col)
            ref_fleet.shard_model_parameters(row)
            x = paddle.to_tensor(inp["x"], stop_gradient=False)
            y = row(col(x))
            (y * y).sum().backward()
            out[f"linear_{gather_output}"] = dict(
                y=y.numpy(), dx=x.grad.numpy(), col=_grads(col),
                row=_grads(row))
        emb = ref_fleet.meta_parallel.VocabParallelEmbedding(32, 8)
        emb.set_state_dict({"weight": _t(inp["emb_w"])})
        ref_fleet.shard_model_parameters(emb)
        e = emb(_t(inp["ids"]))
        (e * e).sum().backward()
        out["embedding"] = dict(y=e.numpy(), grads=_grads(emb))
        w = jnp.arange(1.0, 16.0).reshape(3, 5)
        labels = jnp.asarray(inp["labels"])

        def ce(logits):
            return raw(ref_mpu._parallel_softmax_ce(logits, labels, -100))

        logits = jnp.asarray(inp["logits"])
        out["ce"] = dict(loss=np.asarray(ce(logits)), dlogits=np.asarray(
            jax.grad(lambda v: (ce(v) * w).sum())(logits)))
        seq = _t(inp["seq"])
        for name, fn in (("scatter", ref_spu.scatter),
                         ("gather", ref_spu.all_gather)):
            y, vjp = jax.vjp(lambda v: raw(fn(Tensor(v))), raw(seq))
            out[f"sp_{name}"] = dict(
                y=np.asarray(y),
                dx=np.asarray(vjp(jnp.asarray(inp["seq_grad"]))[0]))
    return out


def _chunk(a, rank, axis=1):
    return np.split(np.asarray(a), MP, axis=axis)[rank]


@pytest.mark.parametrize("gather_output", [False, True])
def test_column_row_linear_match_reference(case, gather_output):
    _, _, ref, port = case
    want = ref[f"linear_{gather_output}"]
    for r in range(MP):
        got = port[r][f"linear_{gather_output}"]
        np.testing.assert_allclose(got["y"], want["y"], **TOL)
        np.testing.assert_allclose(got["dx"], want["dx"], **TOL)
        for layer in ("col", "row"):
            assert sorted(got[layer]) == sorted(want[layer])
            for n, g in want[layer].items():
                np.testing.assert_allclose(got[layer][n], g, **TOL,
                                           err_msg=f"{layer}.{n}")


def test_vocab_parallel_embedding_matches_reference(case):
    _, _, ref, port = case
    for r in range(MP):
        got = port[r]["embedding"]
        np.testing.assert_allclose(got["y"], ref["embedding"]["y"], **TOL)
        np.testing.assert_allclose(got["grads"]["weight"],
                                   ref["embedding"]["grads"]["weight"],
                                   **TOL)


def test_parallel_cross_entropy_matches_reference(case):
    inp, _, ref, port = case
    ignored = inp["labels"] == -100
    for r in range(MP):
        got = port[r]["ce"]
        np.testing.assert_allclose(got["loss"], ref["ce"]["loss"], **TOL)
        assert (got["loss"][ignored] == 0).all()
        np.testing.assert_allclose(got["dlogits"], ref["ce"]["dlogits"],
                                   **TOL)
        assert (got["dlogits"][ignored] == 0).all()


@pytest.mark.parametrize("op", ["scatter", "gather"])
def test_sequence_parallel_ops_match_reference(case, op):
    """ScatterOp / GatherOp on rank r: its part of the reference's global
    view (an identity there), forward and backward."""
    _, _, ref, port = case
    want = ref[f"sp_{op}"]
    for r in range(MP):
        got = port[r][f"sp_{op}"]
        if op == "scatter":
            np.testing.assert_array_equal(got["y"], _chunk(want["y"], r))
            np.testing.assert_array_equal(got["dx"], want["dx"])
        else:
            np.testing.assert_array_equal(got["y"], want["y"])
            np.testing.assert_array_equal(got["dx"], _chunk(want["dx"], r))


def test_sequence_parallel_collective_ops(case):
    """AllGatherOp reduce-scatters its gradient (the ranks' partial input
    gradients summed) and ReduceScatterOp sums its input over the ranks
    then splits, all-gathering the gradient."""
    inp, _, _, port = case
    x, g = inp["seq"], inp["seq_grad"]
    for r in range(MP):
        got = port[r]["sp_all_gather"]
        np.testing.assert_array_equal(got["y"], x)
        np.testing.assert_allclose(got["dx"], MP * _chunk(g, r), **TOL)
        got = port[r]["sp_reduce_scatter"]
        np.testing.assert_allclose(got["y"], MP * _chunk(x, r), **TOL)
        np.testing.assert_array_equal(got["dx"], g)


def test_distributed_split_matches_the_dense_layers(case):
    inp, _, _, port = case
    torch.manual_seed(0)
    col = mpu.ColumnParallelLinear(8, 16, device="cpu")
    emb = mpu.VocabParallelEmbedding(32, 8, device="cpu")
    with torch.no_grad():
        lin = col(torch.from_numpy(inp["x"])).numpy()
        e = emb(torch.from_numpy(inp["ids"])).numpy()
    for r in range(MP):
        np.testing.assert_allclose(port[r]["split_linear"], lin, **TOL)
        np.testing.assert_array_equal(port[r]["split_embedding"], e)


def test_full_shard_round_trip_is_exact(case):
    _, gpt, _, port = case
    split = {"gpt.embeddings.word_embeddings.weight": 0}
    for i in range(2):
        pre = f"gpt.decoder.{i}."
        split.update({pre + "attn.qkv_proj.weight": 1,
                      pre + "attn.qkv_proj.bias": 0,
                      pre + "attn.out_proj.weight": 0,
                      pre + "mlp.fc_in.weight": 1, pre + "mlp.fc_in.bias": 0,
                      pre + "mlp.fc_out.weight": 0})
    for r in range(MP):
        for n, shape in port[r]["shapes"].items():
            want = list(gpt[n].shape)
            if n in split:
                want[split[n]] //= MP
            assert list(shape) == want, n
        assert sorted(port[r]["round_trip"]) == sorted(gpt)
        for n, v in gpt.items():
            np.testing.assert_array_equal(port[r]["round_trip"][n], v)


def test_rng_tracker_streams(case):
    _, _, _, port = case
    a, b = port[0]["rng"], port[1]["rng"]
    np.testing.assert_array_equal(a["global_seed"], b["global_seed"])
    assert not np.array_equal(a["local_seed"], b["local_seed"])
