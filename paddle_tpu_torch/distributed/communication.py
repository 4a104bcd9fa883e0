"""paddle.distributed.communication path (counterpart of
``paddle_tpu/distributed/communication.py``): upstream Paddle implements
the user-level collectives and their ``stream.*`` variants in this
package. Here they live in :mod:`.collective`; this module re-exports
them so code importing the reference's path keeps working."""
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
    recv,
    reduce,
    reduce_scatter,
    scatter,
    scatter_object_list,
    send,
    stream,
    wait,
)
