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
- ``split``: a tensor-parallel embedding or linear, built and applied.

Not ported yet (ROADMAP.md §A.7): the mesh / auto-parallel / reshard /
checkpoint modules, mpmd, the launch CLI, elastic, rpc and the parameter
server.
"""
from __future__ import annotations

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
from .fleet.utils.recompute_helper import recompute  # noqa: F401
from .parallel import DataParallel, spawn  # noqa: F401

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
