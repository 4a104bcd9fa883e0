"""Point to point between neighbouring pipeline stages (named after
upstream Paddle's ``fleet/meta_parallel/pp_utils/p2p_communication.py``).

Stage ``s`` of ``S`` sends activations to stage ``(s + 1) % S`` and
cotangents to stage ``(s - 1) % S`` of its pipe group: the ranks that
differ from it only on the pipe axis, so under mp + sequence parallelism
each mp rank exchanges its own sequence shard ``[mb, T / mp, H]`` with the
peer of the same mp rank. The receiver allocates its buffer from a tensor
of the boundary's shape and dtype that it already holds, so nothing sends
a header. Sends are asynchronous (:meth:`P2pHelper.wait_sends` completes
them); a receive returns once its tensor has arrived. Activations and
cotangents travel under separate tags. Every op goes through
``batch_isend_irecv``, which stages CUDA tensors through pinned host
buffers on a gloo group.
"""
from __future__ import annotations

import torch

from .... import collective as C

FORWARD_TAG, BACKWARD_TAG = 0, 1


class P2pHelper:
    """The point-to-point of one pipeline rank over its pipe ``group``."""

    def __init__(self, group, stage: int, num_stages: int):
        self.group = group
        self.next = group.ranks[(stage + 1) % num_stages]
        self.prev = group.ranks[(stage - 1) % num_stages]
        self._pending = []

    def _send(self, tensor, peer, tag):
        self._pending += C.batch_isend_irecv(
            [C.P2POp(C.isend, tensor.detach(), peer, self.group, tag)])

    def _recv(self, like, peer, tag):
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        for task in C.batch_isend_irecv(
                [C.P2POp(C.irecv, buf, peer, self.group, tag)]):
            task.wait()
        return buf

    def send_forward(self, activation):
        self._send(activation, self.next, FORWARD_TAG)

    def recv_forward(self, like):
        return self._recv(like, self.prev, FORWARD_TAG)

    def send_backward(self, cotangent):
        self._send(cotangent, self.prev, BACKWARD_TAG)

    def recv_backward(self, like):
        return self._recv(like, self.next, BACKWARD_TAG)

    def wait_sends(self):
        for task in self._pending:
            task.wait()
        self._pending = []


__all__ = ["BACKWARD_TAG", "FORWARD_TAG", "P2pHelper"]
