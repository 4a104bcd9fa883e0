"""Parallel environment and process groups (counterpart of
``paddle_tpu/distributed/env.py``).

The reference is one process holding every device; the port is one
process per rank, as upstream Paddle's dygraph and PyTorch are. A
:class:`Group` wraps a ``torch.distributed`` process group and the global
ranks it spans.

:func:`init_parallel_env` takes the rendezvous from the launch
environment: Paddle's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_MASTER`` (``host:port``, or any ``torch.distributed`` init URL
such as ``file:///path``), else torchrun's ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``. A single process with neither gets an
in-process store. The backend is NCCL when the default device is the
CUDA card; gloo only when the caller asks for the CPU
(``paddle.set_device("cpu")``) or passes ``backend="gloo"``. Nothing
switches between them on its own: without CUDA the default device raises.
Each rank sets its CUDA device from its local rank (``PADDLE_LOCAL_RANK``
or ``LOCAL_RANK``, else the rank), modulo the visible devices. When the
launcher exported ``PADDLE_HEARTBEAT_INTERVAL``, the rank joins the
heartbeat watchdog (``runtime/watchdog.py``) once the process group is up;
``destroy_process_group`` stops it.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device


def _env_int(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


class ParallelEnv:
    """paddle.distributed.ParallelEnv parity: rank, world size and device
    of this process, read from the launch environment until
    :func:`init_parallel_env` has run, then from the default group."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def local_rank(self) -> int:
        return _local_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    nranks = world_size

    @property
    def device_id(self) -> int:
        n = torch.cuda.device_count()
        return _local_rank() % n if n else 0

    dev_id = device_id


class Group:
    """A communication group: the global ranks it spans, in order, and the
    ``torch.distributed`` process group over them (``None`` on a process
    that is not a member)."""

    _next_gid = 0

    def __init__(self, ranks: Sequence[int], pg=None,
                 name: Optional[str] = None):
        self.ranks: List[int] = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.id = Group._next_gid
        Group._next_gid += 1
        self.name = name or f"group_{self.id}"
        self._pg = pg

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        """This process's index in the group; -1 when not a member."""
        return self.get_group_rank(get_rank())

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    @property
    def process_group(self):
        return self._pg

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, name={self.name})"


_default_group: Optional[Group] = None
_groups: List[Group] = []


def _local_rank() -> int:
    return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", "PADDLE_TRAINER_ID",
                    "RANK", default=0)


def is_initialized() -> bool:
    return _default_group is not None


def _init_method(world: int) -> Optional[str]:
    master = os.environ.get("PADDLE_MASTER")
    if master:
        return master if "://" in master else f"tcp://{master}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ['MASTER_PORT']}")
    if world > 1:
        raise RuntimeError(
            f"init_parallel_env: world size {world} but no rendezvous: set "
            "PADDLE_MASTER (host:port or an init URL) or MASTER_ADDR / "
            "MASTER_PORT")
    return None


def init_parallel_env(backend: Optional[str] = None) -> Group:
    """Join the default (world) group; returns it. ``backend`` None picks
    NCCL on the CUDA default device and gloo when the default device is
    the CPU; an explicit ``"nccl"`` or ``"gloo"`` is taken as given."""
    global _default_group
    if _default_group is not None:
        return _default_group
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    if backend is None:
        backend = os.environ.get("PADDLE_DISTRI_BACKEND") or (
            "nccl" if resolve_device(None).type == "cuda" else "gloo")
    backend = backend.lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" or resolve_device(None).type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("init_parallel_env: the NCCL backend needs "
                               "CUDA, which is not available")
        torch.cuda.set_device(_local_rank() % n)
    if not dist.is_initialized():
        url = _init_method(world)
        if url is None:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=rank, world_size=world)
        else:
            dist.init_process_group(backend, init_method=url, rank=rank,
                                    world_size=world)
        # hung-rank detection: when the launcher exported a heartbeat
        # interval, join the store-backed watchdog, so a wedged peer ends
        # the job with a diagnosis instead of stalling every collective
        from ..runtime.watchdog import maybe_start_from_env

        maybe_start_from_env()
        from .. import observability as _obs

        if url is not None and world > 1 and _obs.enabled():
            _obs.event("init_parallel_env", coordinator=url,
                       world_size=world, process_id=rank, backend=backend)
            # ranks that never call fleet_sync themselves still
            # contribute to fleet_metrics.json on a clean exit
            import atexit

            from ..observability.fleet import fleet_sync_atexit

            atexit.register(fleet_sync_atexit)
    _default_group = Group(range(dist.get_world_size()), dist.group.WORLD,
                           name="world")
    _groups.append(_default_group)
    return _default_group


def get_default_group() -> Group:
    if _default_group is None:
        raise RuntimeError("call paddle.distributed.init_parallel_env() "
                           "first")
    return _default_group


def _resolve_group(group: Optional[Group]) -> Group:
    return group if group is not None else get_default_group()


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """paddle.distributed.new_group: a subgroup over global ``ranks``.
    Every process of the world calls it, in the same order, members or
    not (torch.distributed's rule)."""
    world = get_default_group()
    ranks = list(world.ranks if ranks is None else ranks)
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    if pg is dist.GroupMember.NON_GROUP_MEMBER:
        pg = None
    g = Group(ranks, pg)
    _groups.append(g)
    return g


def get_rank(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def destroy_process_group(group: Optional[Group] = None):
    """Leave ``group``; with None (or the world group) tear down every
    group and the default process group."""
    global _default_group
    if group is None or group is _default_group:
        from ..runtime.watchdog import stop_active
        from .fleet import topology

        stop_active()  # leaving the world ends this rank's heartbeat
        topology.set_hybrid_communicate_group(None)
        if dist.is_initialized():
            dist.destroy_process_group()
        _default_group = None
        _groups.clear()
    elif group in _groups:
        if group.process_group is not None:
            dist.destroy_process_group(group.process_group)
        _groups.remove(group)


def get_group(gid: Optional[int] = None) -> Optional[Group]:
    if gid is None:
        return _default_group
    for g in _groups:
        if g.id == gid:
            return g
    return None


__all__ = ["Group", "ParallelEnv", "destroy_process_group", "get_group",
           "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "new_group"]
