"""paddle.distributed (counterpart of ``paddle_tpu/distributed/``), on
``torch.distributed``: one process per rank, NCCL on the card.

- ``env``: ``init_parallel_env``, ``Group``, ``new_group``, ranks;
- ``collective`` / ``communication``: Paddle's collectives;
- ``parallel``: ``DataParallel`` and ``spawn``;
- ``fleet``: the hybrid topology, the mp layers, sequence parallelism,
  ZeRO-1/2/3, gradient merge, pipeline parallelism, the sep axis (the
  sequence split and the ring attention of
  ``nn/functional/ring_attention.py``), expert parallelism (with
  ``incubate/moe.py``) and ``DistTrainStep``;
- ``sharding``: ``group_sharded_parallel``;
- ``grad_comm``: the gradient buckets and the quantized gradient wire
  (and the int8 helpers the serving engine uses);
- ``mp_comm``: the quantized mp activation wire;
- ``split``: a tensor-parallel embedding or linear, built and applied;
- ``mesh``: ``ProcessMesh`` (ranks with named axes, over the fleet
  topology's groups) and the global mesh;
- ``auto_parallel``: placements, ``shard_tensor`` / ``reshard`` (DTensors
  at the API edge), ``shard_dataloader`` and the ``Engine``;
- ``parallelize``: ``parallelize`` / ``to_distributed`` and the plans;
- ``reshard``: the slice / all-to-all / all-gather planner and its
  executor;
- ``checkpoint``: per-rank checkpoints that restore onto any layout, and
  their canonical form;
- ``launch``: ``python -m paddle_tpu_torch.distributed.launch``, the
  launcher that starts a host's ranks and relaunches them as a group;
  ``fleet.elastic``: checkpoint-resume (``ElasticManager``), the MPMD
  stage shards and the resize signals;
- ``mpmd``: the MPMD pipeline (a stage per device subset, boundary queues
  between them);
- ``rpc``: worker-to-worker RPC; ``ps``: the split embedding table and the
  async tiers (geo-SGD, the host-offloaded table).

Not ported yet (ROADMAP.md §A.7): the auto-parallel planner.
"""
from __future__ import annotations

import importlib

from . import collective, communication, env, grad_comm, mp_comm  # noqa: F401
from .collective import (  # noqa: F401
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    gather,
    get_backend,
    irecv,
    isend,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    scatter_object_list,
    send,
    stream,
    wait,
)
from .env import (  # noqa: F401
    Group,
    ParallelEnv,
    destroy_process_group,
    get_group,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
    new_group,
)
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from . import sharding as sharding_api  # noqa: F401
from .fleet.utils.recompute_helper import recompute  # noqa: F401
from .parallel import DataParallel, spawn  # noqa: F401
from . import mesh  # noqa: F401
from .mesh import (  # noqa: F401
    build_mesh,
    get_global_mesh,
    global_mesh,
    set_global_mesh,
    sharding_constraint,
)
from . import auto_parallel  # noqa: F401
from .auto_parallel import (  # noqa: F401
    Partial,
    Placement,
    ProcessMesh,
    Replicate,
    Shard,
    dtensor_from_fn,
    get_mesh,
    reshard,
    set_mesh,
    shard_dataloader,
    shard_layer,
    shard_tensor,
)
# the reshard module, callable as the placement API (as the reference's)
reshard = importlib.import_module(".reshard", __name__)  # noqa: F811
from . import checkpoint  # noqa: F401
from . import launch  # noqa: F401
from . import mpmd  # noqa: F401
from . import rpc  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from .parallelize import (  # noqa: F401
    ColWiseParallel,
    RowWiseParallel,
    SequenceParallelBegin,
    SequenceParallelEnd,
    parallelize,
    to_distributed,
)

all_to_all = alltoall  # reference alias


def split(x, size, operation, axis=0, num_partitions=None, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split (reference :118-144): build a
    tensor-parallel embedding (``operation="embedding"``, ``size`` =
    ``(vocab, dim)``) or linear (``"linear"``, ``size`` = ``(in, out)``;
    ``axis`` 0 splits the weight's rows, 1 its columns) over the mp group
    and apply it to ``x``, on ``x``'s device."""
    from .fleet import meta_parallel as mp_layers

    kw = dict(device=x.device)
    if operation == "embedding":
        return mp_layers.VocabParallelEmbedding(
            size[0], size[1], weight_attr=weight_attr, **kw)(x)
    if operation == "linear":
        if axis == 0:
            layer = mp_layers.RowParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                has_bias=bias_attr is not False, input_is_parallel=False,
                **kw)
        else:
            layer = mp_layers.ColumnParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                has_bias=bias_attr is not False, gather_output=gather_out,
                **kw)
        return layer(x)
    raise ValueError(f"unsupported split operation {operation!r}")
