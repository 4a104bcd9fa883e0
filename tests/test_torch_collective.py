"""The collectives of ``paddle_tpu_torch.distributed`` at world size 4 on
the CPU (gloo, one spawn, ``file://`` rendezvous, under its own time
limit), in f32 / bf16 / int64, against the reference's traced semantics
(``shard_map`` over a 4-device group of its CPU mesh, as
``tests/test_distributed.py`` drives them: device ``r`` plays rank ``r``)
and, where every rank holds the same value, its eager single-controller
results. The inputs are small integers, exact in every dtype under any
summation order, so every comparison is exact.

Where the two define a collective differently, the port follows Paddle:
``reduce``'s result is defined on ``dst`` only (the reference's is an
all-reduce); integer AVG truncates (the reference's ``pmean`` divides
into a float); ``scatter`` gives rank ``i`` part ``i`` of ``src``'s list
(checked against numpy: the reference's traced form gives every rank
``src``'s own part)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed as ref_dist
from paddle_tpu._jax_compat import shard_map
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw

from torch_port_utils import (COLLECTIVE_DTYPES, collective_inputs,
                              collective_job, join_ranks, no_mesh,
                              spawn_ranks)

WORLD = 4
TRACED = ["all_reduce_SUM", "all_reduce_MAX", "all_reduce_MIN",
          "all_reduce_PROD", "all_reduce_AVG", "reduce", "all_gather",
          "all_gather_axis1", "broadcast", "reduce_scatter",
          "reduce_scatter_functional", "reduce_scatter_list", "alltoall",
          "alltoall_single", "gather", "send_recv", "ring_fwd", "ring_bwd",
          "async_all_reduce", "stream_all_reduce"]
EAGER = ["eager_all_reduce", "eager_all_gather", "eager_broadcast",
         "eager_reduce_scatter"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("collective")
    return join_ranks(spawn_ranks(collective_job, WORLD, out), out)


@pytest.fixture(scope="module")
def group():
    with no_mesh():
        ref_dist.init_parallel_env()
        yield ref_dist.new_group(list(range(WORLD)))


def _traced(group, body, xs):
    """``body(x)`` on each of the group's devices, device ``r`` given
    ``xs[r]``; the per-device results stacked."""
    ax = group.axis_names[0]

    def per_device(x):
        return jax.tree_util.tree_map(lambda v: v[None],
                                      body(x[0]))

    f = jax.jit(shard_map(per_device, mesh=group.mesh, in_specs=P(ax),
                          out_specs=P(ax), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, f(xs))


def _ring(group, x, shift_back):
    fwd, bwd = Tensor(jnp.zeros_like(x)), Tensor(jnp.zeros_like(x))
    ref_dist.batch_isend_irecv([
        ref_dist.P2POp(ref_dist.isend, Tensor(x), 1, group=group),
        ref_dist.P2POp(ref_dist.isend, Tensor(x * 10), WORLD - 1,
                       group=group),
        ref_dist.P2POp(ref_dist.irecv, fwd, WORLD - 1, group=group),
        ref_dist.P2POp(ref_dist.irecv, bwd, 1, group=group)])
    return raw(bwd if shift_back else fwd)


def _ref_body(case, group):
    op = case.rsplit("_", 1)[-1]
    g = dict(group=group)
    return {
        "reduce": lambda x: ref_dist.reduce(x, dst=1, **g),
        "all_gather": lambda x: ref_dist.all_gather(None, x, **g),
        "all_gather_axis1": lambda x: jnp.concatenate(
            list(ref_dist.all_gather(None, x, **g)), axis=1),
        "broadcast": lambda x: ref_dist.broadcast(x, src=2, **g),
        "reduce_scatter": lambda x: ref_dist.reduce_scatter(x, **g),
        "reduce_scatter_functional": lambda x: ref_dist.reduce_scatter(x,
                                                                        **g),
        "reduce_scatter_list": lambda x: ref_dist.reduce_scatter(x, **g),
        "alltoall": lambda x: ref_dist.alltoall(x, **g),
        "alltoall_single": lambda x: ref_dist.alltoall_single(x, **g),
        "gather": lambda x: jnp.stack(ref_dist.gather(x, **g)),
        "send_recv": lambda x: _ring(group, x, False),
        "ring_fwd": lambda x: _ring(group, x, False),
        "ring_bwd": lambda x: _ring(group, x, True),
    }.get(case, lambda x: ref_dist.all_reduce(
        x, getattr(ref_dist.ReduceOp, op if op in (
            "SUM", "MAX", "MIN", "PROD", "AVG") else "SUM"), **g))


def _jax_inputs(dtype):
    x = collective_inputs(WORLD, dtype)
    return jnp.asarray(x, {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                           "int64": jnp.int32}[dtype])


@pytest.mark.parametrize("case", TRACED)
@pytest.mark.parametrize("dtype", COLLECTIVE_DTYPES)
def test_matches_reference_traced(port, group, dtype, case):
    want = _traced(group, _ref_body(case, group), _jax_inputs(dtype))
    if case == "all_reduce_AVG" and dtype == "int64":
        want = np.trunc(want)
    ranks = {"reduce": [1], "gather": [3], "send_recv": [1, 3]}.get(
        case, range(WORLD))
    for r in ranks:
        got = port[r][dtype, case]
        np.testing.assert_array_equal(np.asarray(got, np.float64),
                                      np.asarray(want[r], np.float64),
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", COLLECTIVE_DTYPES)
def test_scatter_gives_rank_i_part_i(port, group, dtype):
    xs = collective_inputs(WORLD, dtype)
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r][dtype, "scatter"], xs[0][r])
    # the reference's eager scatter (single controller: rank 0's view)
    want = ref_dist.scatter(Tensor(jnp.zeros(3)),
                            [Tensor(jnp.asarray(v)) for v in xs[0][:WORLD]],
                            src=0, group=group)
    np.testing.assert_array_equal(port[0][dtype, "scatter"],
                                  np.asarray(raw(want)))


@pytest.mark.parametrize("case", EAGER)
@pytest.mark.parametrize("dtype", COLLECTIVE_DTYPES)
def test_matches_reference_eager(port, group, dtype, case):
    """Every rank holding the same ``v``: the reference's eager reading
    (``all_reduce`` gives ``n * v``, ``all_gather`` n copies,
    ``broadcast`` ``v``, ``reduce_scatter`` rank 0's part times n)."""
    v = _jax_inputs(dtype)[0]
    fn = {"eager_all_reduce": lambda: ref_dist.all_reduce(Tensor(v),
                                                          group=group),
          "eager_all_gather": lambda: ref_dist.all_gather([], Tensor(v),
                                                          group=group),
          "eager_broadcast": lambda: ref_dist.broadcast(Tensor(v),
                                                        group=group),
          "eager_reduce_scatter": lambda: ref_dist.reduce_scatter(
              Tensor(v), group=group)}[case]
    want = fn()
    want = ([np.asarray(raw(t)) for t in want] if isinstance(want, list)
            else np.asarray(raw(want)))
    ranks = [0] if case == "eager_reduce_scatter" else range(WORLD)
    for r in ranks:
        np.testing.assert_array_equal(
            np.asarray(port[r][dtype, case], np.float64),
            np.asarray(want, np.float64), err_msg=f"rank {r}")


def test_object_collectives(port):
    for r in range(WORLD):
        assert port[r]["all_gather_object"] == [{"rank": i}
                                                for i in range(WORLD)]
        assert port[r]["broadcast_object_list"] == [1, "r1"]
        assert port[r]["scatter_object_list"] == [f"part{r}"]


def test_backend_world_groups_and_counts(port):
    for r in range(WORLD):
        assert port[r]["backend"] == "GLOO"
        assert port[r]["world"] == (WORLD, r, WORLD, r)
        member = r in (1, 3)
        sub_rank, t = port[r]["subgroup"]
        assert sub_rank == ((1, 3).index(r) if member else -1)
        # a process outside the group leaves the tensor as it was
        np.testing.assert_array_equal(t, np.full(2, 2.0 if member else 1.0))
        counts = port[r]["counts"]
        assert counts["all_reduce"] == 3 * 8 + (1 if member else 0)
        assert counts["batch_isend_irecv"] == 3
        # send / recv / batch_isend_irecv ran on CPU tensors: nothing was
        # staged through the host
        assert counts["send" if r % 2 == 0 else "recv"] == 3
        assert counts.get("p2p_staged_bytes", 0) == 0


class _CudaStandIn:
    """What the staging choice reads of a CUDA tensor."""

    is_cuda = True


@pytest.mark.parametrize("backend, cuda, staged", [
    ("gloo", True, True), ("nccl", True, False), ("gloo", False, False),
    ("nccl", False, False)])
def test_point_to_point_staging_is_chosen_by_backend(monkeypatch, backend,
                                                     cuda, staged):
    """A CUDA tensor on a gloo group goes through a pinned host buffer
    (gloo's send hands the pointer to its socket); on NCCL it passes as
    it is, and a CPU tensor is never staged. The choice reads the
    group's backend (the staging itself runs on the card, chip_smoke.py
    phase 41, which counts its bytes)."""
    import torch

    from paddle_tpu_torch.distributed import collective as C

    monkeypatch.setattr(C.dist, "get_backend", lambda pg: pg)
    t = _CudaStandIn() if cuda else torch.ones(2)
    assert C._host_staged(t, backend) is staged
    if not cuda:
        before = dict(C.counts)
        buf, then = C._p2p_buffer(t, backend, True)
        assert buf is t and then is None and dict(C.counts) == before
