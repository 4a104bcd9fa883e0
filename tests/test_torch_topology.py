"""``CommunicateTopology`` / ``HybridCommunicateGroup`` of the port against
the reference's, in pure Python (no process group: the groups hold their
rank lists only), for the hybrid degrees dp x mp x sharding of an
8-device world."""
import numpy as np
import pytest

from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed.fleet import topology as ref_topology
from paddle_tpu_torch.distributed.fleet import topology

from torch_port_utils import no_mesh

NAMES = ("data", "pipe", "sharding", "sep", "model")
DEGREES = [(2, 2, 2), (1, 2, 4), (4, 2, 1), (8, 1, 1)]  # dp, mp, sharding


def _dims(dp, mp, sh):
    return (dp, 1, sh, 1, mp)


@pytest.fixture(params=DEGREES, ids=lambda d: "dp{}_mp{}_sh{}".format(*d))
def degrees(request):
    return request.param


def test_topology_rank_lists_match_reference(degrees):
    dims = _dims(*degrees)
    got = topology.CommunicateTopology(NAMES, dims)
    want = ref_topology.CommunicateTopology(NAMES, dims)
    assert got.world_size() == want.world_size() == 8
    assert got.get_hybrid_group_names() == want.get_hybrid_group_names()
    for name in NAMES:
        assert got.get_dim(name) == want.get_dim(name)
        assert got.get_comm_list(name) == want.get_comm_list(name), name
        for i in range(got.get_dim(name)):
            assert got.get_axis_list(name, i) == want.get_axis_list(name, i)
    for r in range(8):
        assert got.get_coord(r) == want.get_coord(r)
        assert got.get_rank(**dict(zip(NAMES, got.get_coord(r)))) == r


def test_hybrid_group_matches_reference(degrees):
    dp, mp, sh = degrees
    s = ref_fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=dp, mp_degree=mp, sharding_degree=sh)
    with no_mesh():
        ref_fleet.init(is_collective=True, strategy=s)
        want = ref_fleet.get_hybrid_communicate_group()
        mesh_devices = np.vectorize(lambda d: d.id)(want.mesh.devices)
    topo = topology.CommunicateTopology(NAMES, _dims(*degrees))
    # the reference's view is device 0's: the port's rank 0
    got = topology.HybridCommunicateGroup(topo, global_rank=0)
    for axis, fn in (("data", "get_data_parallel"),
                     ("model", "get_model_parallel"),
                     ("sharding", "get_sharding_parallel"),
                     ("pipe", "get_pipe_parallel"),
                     ("sep", "get_sep_parallel")):
        assert getattr(got, fn + "_world_size")() == \
            getattr(want, fn + "_world_size")(), axis
        assert getattr(got, fn + "_group")().ranks == \
            getattr(want, fn + "_group")().ranks, axis
    assert got.get_parallel_mode() == want.get_parallel_mode()
    assert got.get_model_parallel_group_src_rank() == \
        want.get_model_parallel_group_src_rank()
    # the fused data group is the reference's batch axes (dp, sharding):
    # mesh devices varying on those two, data-major
    fused = np.moveaxis(mesh_devices, (0, 2), (-2, -1)).reshape(-1, dp * sh)
    assert topo.get_fused_comm_list(["data", "sharding"]) == fused.tolist()
    assert got.get_data_sharding_parallel_group().ranks == fused[0].tolist()


@pytest.mark.parametrize("rank", range(8))
def test_every_rank_sees_its_coordinate(rank):
    dp, mp, sh = 2, 2, 2
    topo = topology.CommunicateTopology(NAMES, _dims(dp, mp, sh))
    hcg = topology.HybridCommunicateGroup(topo, global_rank=rank)
    d, _, s, _, m = topo.get_coord(rank)
    assert (hcg.get_data_parallel_rank(), hcg.get_sharding_parallel_rank(),
            hcg.get_model_parallel_rank()) == (d, s, m)
    assert hcg.get_data_sharding_parallel_rank() == d * sh + s
    assert hcg.get_data_sharding_parallel_world_size() == dp * sh
    for g in (hcg.get_data_parallel_group(), hcg.get_model_parallel_group(),
              hcg.get_sharding_parallel_group(),
              hcg.get_data_sharding_parallel_group()):
        assert rank in g.ranks and g.process_group is None
    assert hcg.get_data_sharding_parallel_group().ranks[
        hcg.get_data_sharding_parallel_rank()] == rank
