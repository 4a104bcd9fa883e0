"""``DataParallel`` and ``spawn`` (counterparts of
``paddle_tpu/distributed/parallel.py``).

``DataParallel(layers)`` broadcasts the layers' parameters from rank 0 of
its group (the world by default) and averages their gradients over it
after every ``backward``: the gradients are packed into flat buckets of
``comm_buffer_size`` MiB, all-reduced and divided by the group's size
(``grad_comm.allreduce_mean``), once the backward has finished (the
buckets are not overlapped with the backward). Inside ``no_sync()`` the
gradients stay local. ``apply_collective_grads()`` runs the exchange by
hand, for gradients set without ``backward``.

``spawn(func, args, nprocs)`` starts ``nprocs`` processes by the spawn
start method (``torch.multiprocessing``), each with the launch
environment ``init_parallel_env`` reads (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK`` and a ``file://``
rendezvous in ``PADDLE_MASTER``, unless ``options["master"]`` names
another), and runs ``func(*args)`` in each. ``options["backend"]`` sets
``PADDLE_DISTRI_BACKEND``; ``options["timeout"]`` (seconds) bounds the
join: on expiry every child is killed and ``TimeoutError`` raised.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch
import torch.multiprocessing as tmp

from ..nn.layer import Layer
from . import grad_comm
from .collective import broadcast
from .env import _resolve_group, init_parallel_env


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        init_parallel_env()
        self._layers = layers
        self._group = _resolve_group(group)
        self._bucket_mb = float(comm_buffer_size)
        self._sync = True
        self._queued = False
        with torch.no_grad():
            for p in layers.parameters():
                broadcast(p.data, src=self._group.ranks[0],
                          group=self._group)
        for p in layers.parameters():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._on_grad)

    def _on_grad(self, p):
        if self._sync and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)

    def _finish(self):
        self._queued = False
        self.apply_collective_grads()

    def apply_collective_grads(self):
        """Average every present gradient over the group, in buckets."""
        with torch.no_grad():
            grad_comm.allreduce_mean(
                [p.grad for p in self._layers.parameters()
                 if p.requires_grad], self._group, self._bucket_mb)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


def _spawn_target(index, func, args, env):
    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = os.environ["PADDLE_LOCAL_RANK"] = \
        str(index)
    func(*args)


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes (-1: one per CUDA
    device). Returns the ``torch.multiprocessing`` context; with ``join``
    it returns once every child has exited, raising if one failed."""
    if nprocs in (-1, None):
        nprocs = max(torch.cuda.device_count(), 1)
    env = {"PADDLE_TRAINERS_NUM": str(nprocs)}
    master = options.get("master")
    tmpdir = None
    if master is None:
        tmpdir = tempfile.mkdtemp(prefix="paddle_spawn_")
        master = "file://" + os.path.join(tmpdir, "rendezvous")
    env["PADDLE_MASTER"] = master
    if options.get("backend"):
        env["PADDLE_DISTRI_BACKEND"] = options["backend"]
    ctx = tmp.start_processes(_spawn_target, args=(func, tuple(args), env),
                              nprocs=nprocs, join=False, daemon=daemon,
                              start_method="spawn")
    if join:
        join_spawned(ctx, options.get("timeout"))
    return ctx


def join_spawned(ctx, timeout: Optional[float]):
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
            raise TimeoutError(f"spawned processes did not finish within "
                               f"{timeout} s; killed")
        if ctx.join(timeout=1.0 if left is None else min(left, 1.0)):
            return
