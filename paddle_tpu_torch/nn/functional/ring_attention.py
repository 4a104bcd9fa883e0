"""Ring attention: exact attention over a sequence split across the ranks
of the ``sep`` (context-parallel) group (counterpart of
``paddle_tpu/nn/functional/ring_attention.py``).

Each rank holds its contiguous ``T / sep`` block of q, k and v, in rank
order. The K/V blocks travel around the ring (rank ``r`` sends to
``r + 1`` and receives from ``r - 1``, ``batch_isend_irecv`` over the sep
group); after ``s`` rotations a rank holds the block that started on rank
``r - s``. Causal masking uses global positions: a block from a lower rank
is fully visible, the rank's own block is causal, and a block from a
higher rank is fully masked.

Two routes, chosen by the tensors' device as the flash route is:

- :func:`ring_flash_attention_plain` mirrors the reference's loop: einsum
  scores, the ``-1e30`` fill, an f32 online softmax (``m``, ``l``, ``acc``)
  and ``acc / max(l, 1e-30)``; the rotation is a differentiable op, so
  autograd runs the backward. It serves CPU tensors.
- :class:`RingFlashAttentionFunction` runs each visible block through the
  flash kernels: K1 forward (the diagonal block causal, the lower ones
  not, the masked ones skipped without a launch), the blocks' ``(O_i,
  lse_i)`` merged in f32 as ``lse = logsumexp_i lse_i``, ``O = sum_i
  exp(lse_i - lse) O_i``. The forward keeps the visible blocks it
  received; the backward runs K2a / K2b on each with the *merged* ``lse``
  and ``delta = rowsum(dO * O)`` of the merged output: dQ is summed on
  the rank, and each block's f32 dK / dV sum travels the ring back to
  its owner (``n - 1`` rotations each way, as the plain ring's
  autograd). On CUDA tensors it launches the kernels or raises; on CPU
  tensors (the test hook ``attention._FLASH_ON_CPU``) it runs their
  plain versions.

A mask or an additive bias rides the ring in one of two layouts, told
apart by its last dim (``T_local`` the rank's block, ``T = sep * T_local``):

- **key-only**, ``[B|1, H|1, 1, T_local]`` (or a ``[B|1, T_local]`` padding
  block): this rank's keys. It **rotates with K and V**, so the block a
  rank holds after ``s`` rotations comes with its own bias;
- **with query rows**, ``[B|1, H|1, T_local|1, T]`` (a 2-D mask
  ``[T_local|1, T]``): this rank's queries against every key. It stays,
  and each step **slices the source block's columns**.

Anything else raises ``ValueError``. A bool mask folds into the bias with
``NEG_INF`` (as the unsplit flash route folds it); a float mask is never
differentiated. K1, K2a and K2b take each visible block's bias slice (K2a
with no dS pass); the plain ring adds the same slice. A query row that
sees no key anywhere emits zeros, as K1 does.

Attention dropout runs on the plain ring (the unsplit route takes its
dense version for dropout too). The keep mask of the block (query block
``i``, key block ``j``) is drawn from a ``torch.Generator`` seeded from
(one seed drawn from torch's default generator a call, ``i``, ``j``):
:func:`dropout_keep_mask`, so the split result equals the unsplit plain
attention under the keep mask those blocks tile (the reference's threefry
stream is not reproduced).

Under ``fleet.DistTrainStep`` at ``sep_degree > 1`` every batch tensor of
rank >= 2 is cut along dim 1 and :func:`sequence_split` names the sep
group: ``scaled_dot_product_attention`` (and so the models' attention)
runs as the ring, and :func:`sequence_offset` gives the first global
position of the rank's block (the models' default positions). So a
padding mask enters as ``[B, T]`` and reaches the attention as the rank's
``[B, T_local]`` key block (the encoders build their ``[B, 1, 1,
T_local]`` bias from it); a ``[B, 1, 1, T]`` or ``[B, 1, T, T]`` batch
tensor would be cut along its dim 1 and is refused there, so a mask with
query rows is built inside the model from the rank's block, or passed to
the attention as the rank's ``[B|1, H|1, T_local, T]`` rows. Contiguous
blocks leave the causal work unbalanced: rank ``r`` runs ``r + 1``
blocks.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ...ops import flash_attention as _fa

NEG_INF = -1e30

#: the sep group whose ranks each hold a block of the sequence while
#: ``fleet.DistTrainStep`` runs the model (None otherwise)
_sep_group = None


@contextlib.contextmanager
def sequence_split(group):
    """Within: the sequence (dim 1 of the batch) is split over ``group``'s
    ranks in contiguous blocks, in group order (None or one rank: not
    split)."""
    global _sep_group
    prev = _sep_group
    _sep_group = group if group is not None and group.nranks > 1 else None
    try:
        yield
    finally:
        _sep_group = prev


def split_group():
    """The sep group of the sequence split in force, or None."""
    return _sep_group


def sequence_offset(t_local: int) -> int:
    """The global position of this rank's first token when the sequence
    is split (:func:`sequence_split`) into blocks of ``t_local``; else 0."""
    g = _sep_group
    return 0 if g is None else g.rank * t_local


# ---------------------------------------------------------- mask layouts
def split_bias(mask, b, h, tl, n):
    """``(bias, rotates)`` of a mask under the split of ``n`` blocks of
    ``tl`` queries (see the module docstring): ``bias`` f32 rank 4 with
    the bool mask folded in, ``rotates`` True for the key-only layout;
    ``(None, False)`` without a mask."""
    if mask is None:
        return None, False
    t = n * tl
    shape = tuple(mask.shape)
    if mask.dim() == 2 and shape[-1] == tl:       # a [B, T_local] padding
        mask = mask.reshape(shape[0], 1, 1, tl)
    elif mask.dim() < 4:
        mask = mask.reshape((1,) * (4 - mask.dim()) + shape)
    if mask.dim() != 4:
        raise ValueError(f"an attention mask under the split must have rank "
                         f"<= 4, got {shape}")
    mb, mh, mq, mk = mask.shape
    rotates = mk == tl and mq == 1
    if not (rotates or (mk == t and mq in (1, tl))) \
            or mb not in (1, b) or mh not in (1, h):
        raise ValueError(
            f"attention mask {shape} under a sequence split of {n} blocks of "
            f"{tl}: give this rank's keys [B|1, H|1, 1, {tl}] (or a [B, {tl}] "
            f"padding block), or its queries' rows [B|1, H|1, {tl}|1, {t}]")
    if mask.dtype == torch.bool:
        bias = torch.where(mask, torch.tensor(0.0, device=mask.device),
                           torch.tensor(NEG_INF, device=mask.device))
    else:
        bias = mask.detach().float()
    return bias.contiguous(), rotates


def _source_bias(bias, rotates, src, tl):
    """The bias of key block ``src`` (the rank's held one when it
    rotates)."""
    if bias is None or rotates:
        return bias
    return bias[..., src * tl:(src + 1) * tl].contiguous()


_MASK64 = (1 << 64) - 1


def _mix(*xs) -> int:
    """splitmix64 over ``xs``: a 63-bit generator seed."""
    z = 0x9E3779B97F4A7C15
    for x in xs:
        z = (z + int(x) * 0xBF58476D1CE4E5B9 + 0x632BE59BD9B4E5B) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def draw_dropout_seed() -> int:
    """The seed of one call's keep masks, drawn from torch's default
    generator (ranks seeded alike draw alike)."""
    return int(torch.randint(0, 2 ** 62, (1,)).item())


def dropout_keep_mask(seed: int, q_block: int, k_block: int, shape, p: float,
                      device):
    """The keep mask (bool, ``shape``) of the attention probabilities of
    query block ``q_block`` against key block ``k_block`` at dropout rate
    ``p``: uniform draws from a generator seeded from ``(seed, q_block,
    k_block)``, kept where ``>= p``."""
    gen = torch.Generator(device=device).manual_seed(
        _mix(seed, q_block, k_block))
    return torch.rand(shape, generator=gen, device=device) >= p


# -------------------------------------------------------------- the rotation
def _rotate(x, group, reverse=False):
    """Send ``x`` to the next rank of ``group``'s ring and return the one
    received from the previous rank (the other way with ``reverse``)."""
    from ...distributed import collective as C

    n, r = group.nranks, group.rank
    to = group.ranks[(r - 1) % n if reverse else (r + 1) % n]
    frm = group.ranks[(r + 1) % n if reverse else (r - 1) % n]
    x = x.contiguous()
    out = torch.empty_like(x)
    for task in C.batch_isend_irecv([C.P2POp(C.isend, x, to, group),
                                     C.P2POp(C.irecv, out, frm, group)]):
        task.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One step of the ring; its backward is the step back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotate(x, group)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, reverse=True), None


def _kv_heads(q, k, v):
    """k / v with q's heads (a GQA group's kv head repeated)."""
    g = q.shape[2] // k.shape[2]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


# ------------------------------------------------------------ plain version
def ring_flash_attention_plain(q, k, v, group, causal=False, scale=None,
                               mask=None, dropout_p=0.0):
    """The reference's ring on this rank's ``[B, T/sep, H, D]`` blocks
    (k / v may carry fewer heads), differentiable by autograd, under an
    optional ``mask`` (the layouts of :func:`split_bias`) and attention
    dropout at rate ``dropout_p`` (keep masks :func:`dropout_keep_mask`
    from one :func:`draw_dropout_seed`). Returns the rank's
    ``[B, T/sep, H, D]`` output block in q's dtype."""
    k, v = _kv_heads(q, k, v)
    n, rank = group.nranks, group.rank
    b, tl, h, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    bias, rotates = split_bias(mask, b, h, tl, n)
    dropout_seed = draw_dropout_seed() if dropout_p else None

    qf = q.transpose(1, 2).reshape(b * h, tl, d)
    kv = torch.stack([k.transpose(1, 2).reshape(b * h, tl, d),
                      v.transpose(1, 2).reshape(b * h, tl, d)])

    m = torch.full((b * h, tl, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b * h, tl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b * h, tl, d), dtype=torch.float32, device=q.device)
    iq = torch.arange(tl, device=q.device)
    q_pos = rank * tl + iq[:, None]
    fill = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    for step in range(n):
        # after `step` rotations this rank holds the block of rank - step
        src = (rank - step) % n
        k_cur, v_cur = kv[0], kv[1]
        s = torch.einsum("bqd,bkd->bqk", qf, k_cur).float() * sc
        blk = _source_bias(bias, rotates, src, tl)
        if blk is not None:
            s = s + blk.expand(b, h, tl, tl).reshape(b * h, tl, tl)
        if causal:
            k_pos = src * tl + iq[None, :]
            s = torch.where((k_pos <= q_pos)[None], s, fill)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        # a masked logit weighs 0 even while the row has seen no key (K1's
        # rule: a row that sees none emits zeros)
        p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        if dropout_p:
            keep = dropout_keep_mask(dropout_seed, rank, src, p.shape,
                                     dropout_p, q.device)
            p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
        acc = acc * alpha + torch.einsum(
            "bqk,bkd->bqd", p.to(v_cur.dtype), v_cur).float()
        m = m_new
        if step != n - 1:
            kv = _Rotate.apply(kv, group)
            if rotates:
                bias = _rotate(bias, group)

    out = (acc / l.clamp(min=1e-30)).to(q.dtype)
    return out.reshape(b, h, tl, d).transpose(1, 2)


# ------------------------------------------------------------ kernel route
def _visible(src, rank, causal):
    """``None`` (masked: no launch), or the block's own causal flag."""
    if not causal or src < rank:
        return False
    return True if src == rank else None


def _kernels(q):
    """(K1, K2a, K2b) for q's device: the launches on CUDA tensors, their
    plain versions on CPU tensors."""
    if _fa._is_cuda(q):
        return (_fa.flash_attention_forward_cuda,
                _fa.flash_attention_bwd_dq_cuda,
                _fa.flash_attention_bwd_dkv_cuda)
    return (_fa.flash_attention_forward_plain,
            _fa.flash_attention_bwd_dq_plain,
            _fa.flash_attention_bwd_dkv_plain)


def _merge(o, lse, o_i, lse_i):
    """The running (f32 ``o``, ``lse``) merged with a block's output
    ``o_i`` ``[B, T, H, D]`` and ``lse_i`` ``[B, H, T]``."""
    if o is None:
        return o_i.float(), lse_i
    new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - new).transpose(1, 2)[..., None]
    return o * w_old + o_i.float() * w_new, new


class RingFlashAttentionFunction(torch.autograd.Function):
    """The ring on the flash kernels (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, bias, rotates):
        fwd, _, _ = _kernels(q)
        n, rank = group.nranks, group.rank
        tl = q.shape[1]
        kv = torch.stack([k, v])
        held = bias  # the key block's bias, when it rotates with K / V
        o = lse = None
        visible, received, biases = [], [], []
        for step in range(n):
            src = (rank - step) % n
            vis = _visible(src, rank, causal)
            if vis is not None:
                blk = _source_bias(held, rotates, src, tl)
                o_i, lse_i = fwd(q, kv[0], kv[1], blk, causal=vis,
                                 scale=scale)
                o, lse = _merge(o, lse, o_i, lse_i)
                visible.append((step, vis))
                if step:
                    received.append(kv)
                    if rotates:
                        biases.append(held)
            if step != n - 1:
                kv = _rotate(kv, group)
                if rotates:
                    held = _rotate(held, group)
        o = o.to(q.dtype)
        # the received blocks (and their biases) stay for the backward,
        # which then sends only their dK / dV home
        ctx.save_for_backward(q, k, v, o, lse, *received)
        ctx.group, ctx.scale, ctx.visible = group, scale, visible
        ctx.bias, ctx.rotates, ctx.biases = bias, rotates, biases
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *received = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        _, dq_fn, dkv_fn = _kernels(q)
        n = group.nranks
        b, tl, h, d = q.shape
        hkv = k.shape[2]
        causal_of = dict(ctx.visible)
        blocks = dict(zip([s for s in causal_of if s], received))
        blocks[0] = (k, v)
        rank, tl = group.rank, q.shape[1]
        if ctx.rotates:
            bias_of = dict(zip([s for s in causal_of if s], ctx.biases))
            bias_of[0] = ctx.bias
        else:
            bias_of = {s: _source_bias(ctx.bias, False, (rank - s) % n, tl)
                       for s in causal_of}
        do = do.contiguous()
        delta = _fa._delta(o, do).contiguous()
        dkv = torch.zeros((2, b, tl, hkv, d), dtype=torch.float32,
                          device=q.device)
        dq = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
        # the blocks of forward steps 1, 2, ..., n - 1, then the rank's own:
        # a block's dK / dV sum moves one hop down the ring a step, and the
        # last hop brings each rank the sum of its own block
        for i in range(n):
            step = (i + 1) % n
            if step in causal_of:
                kb, vb = blocks[step]
                vis, blk = causal_of[step], bias_of[step]
                # a mask takes no gradient: K2a runs without its dS pass
                dq_i, _ = dq_fn(q, kb, vb, blk, do, lse, delta,
                                causal=vis, scale=scale)
                dk_i, dv_i = dkv_fn(q, kb, vb, blk, do, lse, delta,
                                    causal=vis, scale=scale)
                dq += dq_i.float()
                if h != hkv:
                    dk_i = dk_i.reshape(b, tl, hkv, h // hkv, d).sum(3)
                    dv_i = dv_i.reshape(b, tl, hkv, h // hkv, d).sum(3)
                dkv[0] += dk_i
                dkv[1] += dv_i
            if i != n - 1:
                dkv = _rotate(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None,
                None, None, None, None)


def ring_flash_attention(q, k, v, group, causal=False, scale=None,
                         mask=None):
    """Exact attention over the ring of ``group`` on this rank's
    ``[B, T/sep, H, D]`` blocks (k / v may carry fewer heads, dividing H),
    through the flash kernels (:class:`RingFlashAttentionFunction`), under
    an optional ``mask`` (the layouts of :func:`split_bias`). Returns the
    rank's output block in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _fa._check(q, k, v, None)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring blocks of q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in length")
    b, tl, h, _ = q.shape
    bias, rotates = split_bias(mask, b, h, tl, group.nranks)
    return RingFlashAttentionFunction.apply(q, k, v, group, bool(causal),
                                            float(scale), bias, rotates)


def _sep_group_of(axis_name):
    if axis_name != "sep":
        raise ValueError(f"context_parallel_attention runs over the 'sep' "
                         f"axis, got {axis_name!r}")
    from ...distributed.fleet.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_sep_parallel_world_size() == 1:
        return None
    return hcg.get_sep_parallel_group()


def ring_attention(q, k, v, causal, scale, flash: bool,
                   group: Optional[object] = None, mask=None,
                   dropout_p: float = 0.0):
    """The ring over ``group`` (default: the sequence split's): the flash
    kernels' route when ``flash`` and no dropout, else the plain version
    (which carries dropout)."""
    if group is None:
        group = _sep_group
    if flash and not dropout_p:
        return ring_flash_attention(q, k, v, group, causal, scale, mask)
    return ring_flash_attention_plain(q, k, v, group, causal, scale, mask,
                                      dropout_p)


def context_parallel_attention(q, k, v, causal: bool = False, scale=None,
                               axis_name: str = "sep"):
    """Attention with the sequence split over the hybrid group's sep ranks:
    q / k / v are this rank's ``[B, T/sep, H, D]`` blocks, the ring runs
    over the sep group (the kernels on CUDA tensors, the plain version on
    CPU tensors). At sep 1 it is the port's
    ``scaled_dot_product_attention``."""
    group = _sep_group_of(axis_name)
    if group is None:
        from .attention import scaled_dot_product_attention

        return scaled_dot_product_attention(q, k, v, is_causal=causal,
                                            scale=scale)
    from . import attention

    return ring_attention(q, k, v, causal, scale,
                          _fa._is_cuda(q) or attention._FLASH_ON_CPU, group)


__all__ = ["RingFlashAttentionFunction", "context_parallel_attention",
           "dropout_keep_mask", "draw_dropout_seed", "ring_flash_attention",
           "ring_flash_attention_plain", "sequence_offset", "sequence_split",
           "split_bias"]
