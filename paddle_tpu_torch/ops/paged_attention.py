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
launches or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

#: kernel launches made by :func:`paged_attention` (a plain count; callers
#: reset it to 0 around a run they want to attribute)
launches = 0

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
                         torch.tensor(mask_fill_value(), device=dev))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shgtk,shkd->sthgd", probs, v)
    return out.reshape(s_, t, h, d)


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
    tensors launch the kernel (D in {64, 128}).
    """
    global launches
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
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((s, t, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paddle_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            page_table.data_ptr(), start_position.data_ptr(), out.data_ptr(),
            s, t, h, hkv, p, d, page_table.shape[1],
            _KV_DTYPES[k_pool.dtype], sc, mask_fill_value(), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
