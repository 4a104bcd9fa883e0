"""Ring attention of the PyTorch port against the reference, on gloo ranks
(one spawn of 4 ranks, ``file://`` rendezvous, joined under its own time
limit).

At sep 2 and 4 (dp filling the world) each rank runs its block of the
global q / k / v through the plain ring and through the kernels' route
(the autograd function on the kernels' plain versions here), causal and
not, with a backward on its block of one cotangent; the blocks, gathered
in sep order, are held against the reference's
``context_parallel_attention`` and its ``jax.vjp`` on its 8-device CPU
mesh, within the reference's own test tolerance. A GQA case (k / v at half
the heads, which the reference's ring does not take) is held against the
port's ``scaled_dot_product_attention`` over repeated heads. The Ulysses
pair's outputs and input gradient equal slices of the global arrays."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.nn.functional.ring_attention import (
    context_parallel_attention as ref_cp_attention)
from paddle_tpu_torch.distributed.fleet import topology
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import ring_attention as ra

from torch_port_utils import fleet_jobs, join_ranks, no_mesh, spawn_ranks

WORLD = 4
# the reference's test_ring_attention_exactness / _grad tolerance
RTOL, ATOL = 1e-4, 1e-5
SEPS = (2, 4)
CAUSAL = (False, True)
B, T, H, D = 2, 64, 2, 16


def _inputs(seed, hkv=H):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    x = rng.standard_normal((2, 8, 4, 3)).astype(np.float32)
    return dict(q=q, k=k, v=v, do=do, x=x, c=rng.standard_normal(
        x.shape).astype(np.float32))


def _name(sep, causal, gqa=False):
    return f"sep{sep}_{'causal' if causal else 'full'}{'_gqa' if gqa else ''}"


def _jobs():
    jobs = [dict(name=_name(s, c), kind="ring", sep=s, causal=c,
                 batch=_name(s, c)) for s in SEPS for c in CAUSAL]
    jobs.append(dict(name=_name(2, True, True), kind="ring", sep=2,
                     causal=True, batch=_name(2, True, True)))
    return jobs


def _ref(sep, causal, batch):
    """The reference's output and q / k / v gradients under ``dout``."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, sep_degree=sep)
        ref_fleet.init(is_collective=True, strategy=s)
        q, k, v, do = (jnp.asarray(batch[x]) for x in ("q", "k", "v", "do"))
        out, vjp = jax.vjp(
            lambda a, b, c: ref_cp_attention(a, b, c, causal=causal), q, k, v)
        dq, dk, dv = vjp(do)
    return {n: np.asarray(a) for n, a in
            dict(o=out, dq=dq, dk=dk, dv=dv).items()}


def _port_dense(batch, causal):
    """The port's scaled_dot_product_attention over repeated kv heads and
    its gradients (the GQA yardstick)."""
    q, k, v = (torch.from_numpy(batch[x]).requires_grad_()
               for x in ("q", "k", "v"))
    g = q.shape[2] // k.shape[2]
    o = F.scaled_dot_product_attention(
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2),
        is_causal=causal)
    o.backward(torch.from_numpy(batch["do"]))
    return dict(o=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
                dv=v.grad.numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = _jobs()
    batches = {j["batch"]: _inputs(i, H // 2 if "gqa" in j["name"] else H)
               for i, j in enumerate(jobs)}
    out = tmp_path_factory.mktemp("ring")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, {}, batches)
    try:
        ref = {}
        for j in jobs:
            b = batches[j["batch"]]
            ref[j["name"]] = (_port_dense(b, j["causal"]) if "gqa" in
                              j["name"] else _ref(j["sep"], j["causal"], b))
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, batches=batches, jobs=jobs)


def _gathered(runs, name, route, key):
    """The ranks' blocks of one sep group (world ranks 0 .. sep-1 hold sep
    ranks 0 .. sep-1 of the first dp rank) in sep order."""
    sep = next(j["sep"] for j in runs["jobs"] if j["name"] == name)
    blocks = {}
    for r in range(WORLD):
        res = runs["port"][r][name]
        blocks.setdefault(res["sep_rank"], res[route][key])
    assert sorted(blocks) == list(range(sep))
    return np.concatenate([blocks[i] for i in range(sep)], axis=1)


@pytest.mark.parametrize("key", ["o", "dq", "dk", "dv"])
@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("sep", SEPS)
def test_ring_matches_reference_context_parallel_attention(runs, sep, causal,
                                                           route, key):
    name = _name(sep, causal)
    got = _gathered(runs, name, route, key)
    np.testing.assert_allclose(got, runs["ref"][name][key], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("key", ["o", "dq", "dk", "dv"])
@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_ring_with_grouped_kv_heads(runs, route, key):
    name = _name(2, True, True)
    got = _gathered(runs, name, route, key)
    np.testing.assert_allclose(got, runs["ref"][name][key], rtol=RTOL,
                               atol=ATOL)


def test_every_dp_rank_runs_the_same_ring(runs):
    """At sep 2 on 4 ranks the two dp rows of the grid hold the same
    blocks: their outputs are bit-equal."""
    name = _name(2, True)
    by_sep = {}
    for r in range(WORLD):
        res = runs["port"][r][name]
        by_sep.setdefault(res["sep_rank"], []).append(res["kernels"]["o"])
    for outs in by_sep.values():
        assert len(outs) == 2 and np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("sep", SEPS)
def test_ulysses_round_trip(runs, sep):
    name = _name(sep, False)
    batch = runs["batches"][name]
    x, c = batch["x"], batch["c"]
    h = x.shape[2] // sep
    for r in range(WORLD):
        res = runs["port"][r][name]
        i = res["sep_rank"]
        np.testing.assert_array_equal(res["heads"], x[:, :, i * h:(i + 1) * h])
        t = x.shape[1] // sep
        np.testing.assert_array_equal(res["back"], x[:, i * t:(i + 1) * t])
        np.testing.assert_array_equal(res["x_grad"], c[:, i * t:(i + 1) * t])


@pytest.mark.parametrize("causal", CAUSAL)
def test_sep1_is_scaled_dot_product_attention(causal, monkeypatch):
    """Without a sep axis ``context_parallel_attention`` is the port's
    ``scaled_dot_product_attention``."""
    monkeypatch.setattr(topology, "_hcg", None)
    batch = _inputs(7)
    q, k, v = (torch.from_numpy(batch[x]) for x in ("q", "k", "v"))
    got = ra.context_parallel_attention(q, k, v, causal=causal)
    want = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    assert torch.equal(got, want)
