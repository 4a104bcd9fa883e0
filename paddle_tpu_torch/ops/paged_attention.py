"""Fused paged attention: CUDA kernel K3 and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. One function
serves the decode step (T=1), the speculative verify step (T=k+1) and the
prefix-cached tail prefill (S=1, T=bucket) of the serving engine:
queries ``[S, T, H, D]`` attend, through a page table ``[S, MP]``, to a
K/V page pool ``[N, Hkv, P, D]`` (page 0 is the trash page), causal at
``start_position[s] + t`` per query row.

``paged_attention`` launches the hand-written kernel
(``ops/cuda/paged_attention.cu``) for CUDA tensors and takes
``paged_attention_plain`` only for CPU tensors; on a CUDA tensor it
launches or raises. The kernel has two regimes, picked from the shapes by
:func:`_k3_regime`: ``tile`` (tensor cores over 64-row tiles, for the tail
prefill) and ``split`` (flash-decoding over key splits and an in-order
merge, for decode and verify); :func:`paged_attention_split_plain` is the
plain version of the split decomposition, kept as the tests' oracle for it.
``launches`` counts calls that launched, ``launches_tile`` /
``launches_split`` the calls of each regime, and ``launches_decode`` /
``launches_verify`` the split-regime calls with one query row per slot
(T = 1) and with several (T > 1).
"""
from __future__ import annotations

import math

import torch

#: kernel launches made by :func:`paged_attention` (a plain count; callers
#: reset it to 0 around a run they want to attribute), of them those of the
#: tile regime and of the split regime, and of the split ones those with
#: T = 1 (decode) and with T > 1 (verify)
launches = 0
launches_tile = 0
launches_split = 0
launches_decode = 0
launches_verify = 0

#: keys of one split of the split regime (the kernel's kSplitKeys)
SPLIT_KEYS = 64
#: calls with at least this many folded rows (T * G) take the tile
#: regime: the engine's smallest prefill bucket (16) included
TILE_MIN_ROWS = 16

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)


def mask_fill_value() -> float:
    """Masked-logit fill shared by the kernel and the plain version: half
    of ``finfo(float32).min``, so ``exp(fill - row_max)`` underflows to 0
    while ``fill - row_max`` and the online-softmax rescale stay finite
    for a row that is still all-masked."""
    return float(torch.finfo(torch.float32).min) * 0.5


def paged_attention_plain(q, k_pool, v_pool, page_table, start_position, *,
                          scale=None, k_scales=None, v_scales=None):
    """Plain PyTorch version: the einsum oracle of the reference
    (``nn/functional/attention.py::_paged_attention_op``) line by line.
    Gathers every page slot densely, dequantizes int8 pools up front and
    runs a dense masked softmax. Returns ``[S, T, H, D]`` f32."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    s_, t, h, d = q.shape
    hkv, p = k_pool.shape[1], k_pool.shape[2]
    mp = page_table.shape[1]
    group = h // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    pk, pv = k_pool, v_pool
    if k_scales is not None:
        pk = pk.float() * k_scales[..., None]
        pv = pv.float() * v_scales[..., None]

    def gather(pool):
        g = pool[page_table.long()]            # [S, MP, Hkv, P, D]
        g = g.transpose(1, 2)                  # [S, Hkv, MP, P, D]
        return g.reshape(s_, hkv, mp * p, d)

    k = gather(pk).float()
    v = gather(pv).float()
    qf = q.float().reshape(s_, t, hkv, group, d)
    logits = torch.einsum("sthgd,shkd->shgtk", qf, k) * sc
    dev = q.device
    qpos = (start_position.long()[:, None]
            + torch.arange(t, device=dev)[None, :])                  # [S, T]
    mask = (torch.arange(mp * p, device=dev)[None, None, :]
            <= qpos[:, :, None])                                     # [S, T, K]
    logits = torch.where(mask[:, None, None, :, :], logits,
                         mask_fill_value())
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shgtk,shkd->sthgd", probs, v)
    return out.reshape(s_, t, h, d)


def _k3_regime(t: int, group: int) -> str:
    """``"tile"`` when the call has 16 or more folded rows (``T * G``: the
    tail prefill, verify with wide GQA), else ``"split"`` (decode, verify
    at G=1)."""
    return "tile" if t * group >= TILE_MIN_ROWS else "split"


def _k3_splits(mp: int, p: int) -> int:
    """Key splits of the split regime: the table width ``MP * P`` in
    :data:`SPLIT_KEYS` pieces. It never reads ``start_position``, which
    lives on the device."""
    return -(-(mp * p) // SPLIT_KEYS)


def paged_attention_split_plain(q, k_pool, v_pool, page_table,
                                start_position, *, scale=None,
                                k_scales=None, v_scales=None):
    """Plain version of the split regime's decomposition: the keys
    ``[0, MP * P)`` in :func:`_k3_splits` pieces of :data:`SPLIT_KEYS`;
    per piece a partial ``(m, l, acc)`` with ``p = 0`` where the logit is
    ``<= fill / 2`` (a piece no key of the row reaches has ``l = 0``);
    the partials merged in piece order, skipping ``l = 0``, divided by
    ``max(l, 1e-30)``. A row that sees no key emits zeros (as the kernels
    do; :func:`paged_attention_plain`'s dense softmax averages instead).
    Returns ``[S, T, H, D]`` f32. No runtime path calls it: it is the
    tests' oracle for the split regime's arithmetic."""
    s_, t, h, d = q.shape
    hkv, p = k_pool.shape[1], k_pool.shape[2]
    mp = page_table.shape[1]
    group = h // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    fill = mask_fill_value()
    pk, pv = k_pool, v_pool
    if k_scales is not None:
        pk = pk.float() * k_scales[..., None]
        pv = pv.float() * v_scales[..., None]

    def gather(pool):
        g = pool[page_table.long()].transpose(1, 2)
        return g.reshape(s_, hkv, mp * p, d).float()

    k, v = gather(pk), gather(pv)
    qf = q.float().reshape(s_, t, hkv, group, d)
    logits = torch.einsum("sthgd,shkd->shgtk", qf, k) * sc
    dev = q.device
    qpos = (start_position.long()[:, None]
            + torch.arange(t, device=dev)[None, :])
    mask = torch.arange(mp * p, device=dev)[None, None, :] <= qpos[:, :, None]
    logits = torch.where(mask[:, None, None], logits, fill)
    m_all = torch.full(logits.shape[:-1], fill, device=dev)
    l_all = torch.zeros(logits.shape[:-1], device=dev)
    acc = torch.zeros((*logits.shape[:-1], d), device=dev)
    for i in range(_k3_splits(mp, p)):
        lo, hi = i * SPLIT_KEYS, min((i + 1) * SPLIT_KEYS, mp * p)
        x = logits[..., lo:hi]
        m_i = x.amax(-1)
        p_i = torch.where(x > fill * 0.5, torch.exp(x - m_i[..., None]), 0.0)
        l_i = p_i.sum(-1)
        a_i = torch.einsum("shgtk,shkd->shgtd", p_i, v[:, :, lo:hi])
        # merge in order; an l = 0 partial is skipped
        live = l_i > 0
        m_new = torch.where(live, torch.maximum(m_all, m_i), m_all)
        w_old = torch.exp(m_all - m_new)
        w_new = torch.where(live, torch.exp(m_i - m_new), 0.0)
        l_all = w_old * l_all + w_new * l_i
        acc = w_old[..., None] * acc + w_new[..., None] * a_i
        m_all = m_new
    out = acc / l_all.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(s_, t, h, d)


def _check(q, k_pool, v_pool, page_table, start_position, k_scales,
           v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"expected q [S, T, H, D] and pools [N, Hkv, P, D], got "
            f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    s, _, h, d = q.shape
    n, hkv, p, dk = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or dk != d:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)} do "
            f"not match head_dim {d}")
    if h % hkv:
        raise ValueError(f"num heads {h} not divisible by kv heads {hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != s:
        raise ValueError(f"page_table must be [S={s}, MP], got "
                         f"{tuple(page_table.shape)}")
    if tuple(start_position.shape) != (s,):
        raise ValueError(f"start_position must be [S={s}], got "
                         f"{tuple(start_position.shape)}")
    if k_scales is not None:
        for x in (k_scales, v_scales):
            if tuple(x.shape) != (n, hkv, p):
                raise ValueError(f"scales must be [N, Hkv, P] = "
                                 f"{(n, hkv, p)}, got {tuple(x.shape)}")


def _check_cuda(q, k_pool, v_pool, page_table, start_position, k_scales,
                v_scales):
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim in {_HEAD_DIMS}, got {d}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share one dtype of "
                        f"{tuple(_KV_DTYPES)}, got {k_pool.dtype} / "
                        f"{v_pool.dtype}")
    if (k_pool.dtype == torch.int8) != (k_scales is not None):
        raise ValueError("int8 pools need k_scales/v_scales, and only int8 "
                         "pools take them")
    if page_table.dtype != torch.int32 or start_position.dtype != torch.int32:
        raise TypeError("page_table and start_position must be int32")
    tensors = [q, k_pool, v_pool, page_table, start_position]
    if k_scales is not None:
        if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
            raise TypeError("scales must be float32")
        tensors += [k_scales, v_scales]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got a "
                             f"tensor on {x.device}")
        if not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for x in (k_pool, v_pool):
        if x.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")


def paged_attention(q, k_pool, v_pool, page_table, start_position, *,
                    scale=None, k_scales=None, v_scales=None):
    """Fused paged attention over a page-table-indirected KV pool.

    Args:
        q: ``[S, T, H, D]`` f32 queries.
        k_pool, v_pool: ``[N, Hkv, P, D]`` pools in their STORED dtype
            (f32, bf16, or int8 together with the scales).
        page_table: ``[S, MP]`` int32; entry j of slot s is the physical
            page of virtual keys ``j*P .. j*P+P-1`` (0 = trash page).
        start_position: ``[S]`` int32; query row t of slot s attends keys
            ``<= start_position[s] + t``.
        scale: logit scale, default ``1/sqrt(D)``.
        k_scales, v_scales: ``[N, Hkv, P]`` f32 absmax scales of int8
            pools (both or neither).

    Returns ``[S, T, H, D]`` f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (D in {64, 128}) in the regime
    :func:`_k3_regime` picks.
    """
    global launches, launches_tile, launches_split, launches_decode
    global launches_verify
    _check(q, k_pool, v_pool, page_table, start_position, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pool, v_pool, page_table, start_position, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    _check_cuda(q, k_pool, v_pool, page_table, start_position, k_scales,
                v_scales)
    from .cuda.build import library

    lib = library()
    s, t, h, d = q.shape
    _, hkv, p, _ = k_pool.shape
    mp = page_table.shape[1]
    regime = _k3_regime(t, h // hkv)
    if q.data_ptr() % 16:  # the kernel reads q rows with 16-byte copies
        q = q.clone()
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((s, t, h, d), dtype=torch.float32, device=q.device)
    nsplit, scratch = 0, None
    if regime == "split":
        nsplit = _k3_splits(mp, p)
        # per (slot, kv head, split, row): acc[D], then (m, l)
        scratch = torch.empty(s * hkv * nsplit * t * (h // hkv) * (d + 2),
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paddle_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            page_table.data_ptr(), start_position.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            s, t, h, hkv, p, d, mp, _KV_DTYPES[k_pool.dtype], nsplit, sc,
            mask_fill_value(), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({regime} regime) launch "
                           f"failed with CUDA error {err}")
    launches += 1
    if regime == "tile":
        launches_tile += 1
    else:
        launches_split += 1
        if t == 1:
            launches_decode += 1
        else:
            launches_verify += 1
    return out
