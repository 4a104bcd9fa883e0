"""Flash attention: CUDA kernels K1 (forward) and K2 (backward: K2a dQ,
K2b dK/dV) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``. Layout
``[B, T, H, D]`` at the public function; k / v may carry fewer heads
(``Hkv`` divides ``H``: GQA / MQA). Causal masking is bottom-right aligned
(key ``k`` is visible to query ``q`` when ``k <= q + Tk - Tq``). An additive
bias ``[B|1, H|1, Tq|1, Tk|1]`` broadcasts inside the kernels through its
singleton dims; a bool mask is folded into it with ``NEG_INF``.

The plain versions mirror the Pallas kernels as they compute, not the
dense oracle ``_sdpa_reference``: masked logits are ``NEG_INF = -1e30``,
``p = 0`` wherever the logit is ``<= NEG_INF / 2``, and a query row with
no visible key emits zeros and ``lse = NEG_INF`` (the dense softmax gives
NaN there). With bf16 inputs the forward rounds P to v's dtype before
P·V; the backward works in f32 throughout and casts dQ to q's dtype and
dK / dV (after the GQA group-sum) to k's / v's.

:func:`flash_attention` runs :class:`FlashAttentionFunction`: CPU tensors
take the plain versions, CUDA tensors launch the hand-written kernels
(``ops/cuda/flash_attention.cu``) or raise. ``launches_fwd``,
``launches_dq`` and ``launches_dkv`` count kernel launches, and
``launches_fwd_bf16`` / ``launches_dq_bf16`` / ``launches_dkv_bf16`` those
of them in bf16.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30

#: kernel launches of K1, K2a and K2b (plain counts; callers reset them to
#: 0 around a run they want to attribute), and those in bf16. Bumped under
#: ``_count_lock``: the MPMD pipeline's stage threads launch side by side
launches_fwd = 0
launches_dq = 0
launches_dkv = 0
launches_fwd_bf16 = 0
launches_dq_bf16 = 0
launches_dkv_bf16 = 0

_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


# ------------------------------------------------------------- plain versions

def _visible(tq, tk, causal, device):
    """``[Tq, Tk]`` bool: key visible to query (bottom-right causal)."""
    if not causal:
        return torch.ones((tq, tk), dtype=torch.bool, device=device)
    qi = torch.arange(tq, device=device)[:, None]
    ki = torch.arange(tk, device=device)[None, :]
    return ki <= qi + (tk - tq)


def _heads_first(x, hkv):
    """``[B, T, H, D]`` -> f32 ``[B, Hkv, G, T, D]``."""
    b, t, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b, hkv, h // hkv, t, d)


def _logits(q, k, bias, causal, scale):
    """Masked f32 logits ``[B, Hkv, G, Tq, Tk]`` of q ``[B, Tq, H, D]`` and
    k ``[B, Tk, Hkv, D]``: ``(q·k) * scale + bias``, ``NEG_INF`` where
    masked."""
    b, tq, h, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qf = _heads_first(q, hkv)
    kf = k.float().permute(0, 2, 1, 3)                      # [B, Hkv, Tk, D]
    s = torch.einsum("bngqd,bnkd->bngqk", qf, kf) * scale
    if bias is not None:
        bb = bias.float().expand(b, h, bias.shape[2], bias.shape[3])
        s = s + bb.reshape(b, hkv, h // hkv, *bb.shape[2:])
    vis = _visible(tq, tk, causal, q.device)
    return torch.where(vis, s, torch.tensor(NEG_INF, device=q.device))


def flash_attention_forward_plain(q, k, v, bias=None, *, causal=False,
                                  scale=None):
    """Plain version of K1 (``_fa_forward``). Returns ``o`` ``[B, Tq, H, D]``
    in q's dtype and ``lse`` ``[B, H, Tq]`` f32."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _logits(q, k, bias, causal, sc)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True)
    vf = v.permute(0, 2, 1, 3)                                # [B, Hkv, Tk, D]
    # P is rounded to v's dtype before P·V; the sum stays in f32
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), vf.float())
    safe = denom.clamp(min=1e-30)
    o = (acc / safe).reshape(b, h, tq, d).permute(0, 2, 1, 3)
    lse = torch.where(denom > 0, m + torch.log(safe),
                      torch.tensor(NEG_INF, device=q.device))
    return o.to(q.dtype).contiguous(), lse.reshape(b, h, tq)


def _reduce_bias_grad(ds, bias):
    """Sum the full ``[B, H, Tq, Tk]`` dS over the bias's broadcast dims."""
    dims = [i for i in range(4) if bias.shape[i] == 1 and ds.shape[i] != 1]
    return ds.sum(dims, keepdim=True) if dims else ds


def _delta(o, do):
    """``rowsum(dO · O)`` as ``[B, H, Tq]`` f32 (computed outside the
    kernels, as in the reference)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1)


def _p_ds(q, k, v, bias, do, lse, delta, causal, scale):
    """Recomputed P and dS, f32 ``[B, Hkv, G, Tq, Tk]``."""
    b, tq, h, _ = q.shape
    hkv = k.shape[2]
    g = h // hkv
    s = _logits(q, k, bias, causal, scale)
    p = torch.where(s > NEG_INF * 0.5,
                    torch.exp(s - lse.reshape(b, hkv, g, tq, 1)), 0.0)
    dp = torch.einsum("bngqd,bnkd->bngqk", _heads_first(do, hkv),
                      v.float().permute(0, 2, 1, 3))
    return p, p * (dp - delta.reshape(b, hkv, g, tq, 1))


def flash_attention_bwd_dq_plain(q, k, v, bias, do, lse, delta, *,
                                 causal=False, scale=None, want_ds=False):
    """Plain version of K2a (``_dq_kernel``): ``dq`` ``[B, Tq, H, D]`` in
    q's dtype and, when ``want_ds``, the full dS ``[B, H, Tq, Tk]`` f32
    (else None)."""
    b, tq, h, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    _, ds = _p_ds(q, k, v, bias, do, lse, delta, causal, sc)
    dq = torch.einsum("bngqk,bnkd->bngqd", ds,
                      k.float().permute(0, 2, 1, 3)) * sc
    dq = dq.reshape(b, h, tq, d).permute(0, 2, 1, 3).to(q.dtype)
    return dq.contiguous(), (ds.reshape(b, h, tq, -1) if want_ds else None)


def flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse, delta, *,
                                  causal=False, scale=None):
    """Plain version of K2b (``_dkv_kernel``): dk, dv per *query* head,
    f32 ``[B, Tk, H, D]`` (before the GQA group-sum)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    p, ds = _p_ds(q, k, v, bias, do, lse, delta, causal, sc)
    dv = torch.einsum("bngqk,bngqd->bngkd", p, _heads_first(do, hkv))
    dk = torch.einsum("bngqk,bngqd->bngkd", ds, _heads_first(q, hkv)) * sc

    def out(x):
        return x.reshape(b, h, tk, d).permute(0, 2, 1, 3).contiguous()
    return out(dk), out(dv)


def _backward_with(dq_fn, dkv_fn, q, k, v, bias, o, lse, do, causal, scale,
                   bias_grad):
    """The reference's ``_fa_backward`` around its two kernels: delta
    outside them, the GQA group-sum and the casts of dK / dV after K2b,
    the dbias reduction over the bias's broadcast dims after K2a."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    delta = _delta(o, do).contiguous()
    want_ds = bias is not None and bias_grad
    dq, ds = dq_fn(q, k, v, bias, do, lse, delta, causal=causal, scale=scale,
                   want_ds=want_ds)
    dk, dv = dkv_fn(q, k, v, bias, do, lse, delta, causal=causal,
                    scale=scale)
    if h != hkv:
        dk = dk.reshape(b, tk, hkv, h // hkv, d).sum(3)
        dv = dv.reshape(b, tk, hkv, h // hkv, d).sum(3)
    dbias = _reduce_bias_grad(ds, bias) if want_ds else None
    return dq, dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_attention_backward_plain(q, k, v, bias, o, lse, do, *,
                                   causal=False, scale=None, bias_grad=False):
    """Plain version of K2 (``_fa_backward``): recomputes P from ``lse``.
    Returns ``(dq, dk, dv, dbias)``; dq in q's dtype, dk / dv in k's / v's
    (group-summed over the query heads of each kv head), dbias f32 in the
    bias's shape or None unless ``bias_grad``."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _backward_with(flash_attention_bwd_dq_plain,
                          flash_attention_bwd_dkv_plain, q, k, v, bias, o,
                          lse, do, causal, sc, bias_grad)


# ------------------------------------------------------------------ checks

def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q [B, Tq, H, D] and k / v [B, Tk, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, tq, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if h % k.shape[2]:
        raise ValueError(f"num_heads {h} not divisible by num_kv_heads "
                         f"{k.shape[2]}")
    if bias is not None:
        if bias.dim() != 4:
            raise ValueError(f"bias must be rank-4, got {tuple(bias.shape)}")
        bb, bh, bq, bk = bias.shape
        if bb not in (1, b) or bh not in (1, h):
            raise ValueError(
                f"bias dims ({bb}, {bh}) must broadcast over batch={b} / "
                f"heads={h} (per-kv-head bias pages are unsupported)")
        if bq not in (1, tq) or bk not in (1, k.shape[1]):
            raise ValueError(f"bias seq dims {(bq, bk)} must broadcast over "
                             f"(Tq={tq}, Tk={k.shape[1]})")


def _check_cuda(q, k, v, bias):
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim in {_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q / k / v must share one dtype of "
                        f"{tuple(_DTYPES)}, got {q.dtype} / {k.dtype} / "
                        f"{v.dtype}")
    for x in (k, v) + (() if bias is None else (bias,)):
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got a "
                             f"tensor on {x.device}")
    if bias is not None and not bias.is_floating_point():
        raise TypeError(f"bias must be floating point, got {bias.dtype}")


# ------------------------------------------------------------ CUDA launches

def _kernel_view(x):
    """``x`` as the kernels read it: ``[B, T, H, D]`` with unit stride along
    D and 16-byte aligned rows. A strided view (q / k / v sliced out of the
    fused QKV projection) is read in place; anything else is copied."""
    vec = 16 // x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in x.stride()[:3])):
        return x
    return x.contiguous()


class _Launch:
    """The checked arguments the three entry points share."""

    def __init__(self, q, k, v, bias, causal, scale, do=None, rows=()):
        if q.device.type != "cuda":
            raise ValueError(f"the flash-attention kernels take cuda "
                             f"tensors, got {q.device}")
        _check(q, k, v, bias)
        _check_cuda(q, k, v, bias)
        if do is not None and (do.shape != q.shape or do.dtype != q.dtype
                               or do.device != q.device):
            raise ValueError("dout must match q in shape, dtype and device")
        b, tq, h, d = q.shape
        for x in rows:  # lse / delta
            if (tuple(x.shape) != (b, h, tq) or x.dtype != torch.float32
                    or x.device != q.device):
                raise ValueError(f"lse / delta must be [B, H, Tq] = "
                                 f"{(b, h, tq)} float32 on {q.device}")
        self.q, self.k, self.v = (_kernel_view(x) for x in (q, k, v))
        tk, hkv = k.shape[1], k.shape[2]
        if bias is None:
            self.bias, bdims = None, (0, 0, 1, 1)
        else:
            self.bias = bias.float().contiguous()
            bdims = tuple(self.bias.shape)
        self.ints = (b, h, hkv, tq, tk, d, *bdims, int(causal),
                     _DTYPES[q.dtype])
        self.scale = float(scale)
        self.device = q.device

    def strides(self, do=None):
        xs = (self.q, self.k, self.v, do if do is not None else self.q)
        return (ctypes.c_longlong * 12)(
            *(s for x in xs for s in x.stride()[:3]))

    def call(self, name, *ptrs, do=None):
        from .cuda.build import library

        fn = getattr(library(), name)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = fn(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                     None if self.bias is None else self.bias.data_ptr(),
                     *ptrs, self.strides(do), *self.ints, self.scale, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                               f"{err}")


def flash_attention_forward_cuda(q, k, v, bias=None, *, causal=False,
                                 scale=None):
    """Launch K1; same contract as :func:`flash_attention_forward_plain`."""
    global launches_fwd, launches_fwd_bf16
    b, tq, h, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lc = _Launch(q, k, v, bias, causal, sc)
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lc.call("paddle_flash_attention_fwd", o.data_ptr(), lse.data_ptr())
    with _count_lock:
        launches_fwd += 1
        launches_fwd_bf16 += q.dtype == torch.bfloat16
    return o, lse


def flash_attention_bwd_dq_cuda(q, k, v, bias, do, lse, delta, *,
                                causal=False, scale=None, want_ds=False):
    """Launch K2a; same contract as :func:`flash_attention_bwd_dq_plain`."""
    global launches_dq, launches_dq_bf16
    b, tq, h, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lc = _Launch(q, k, v, bias, causal, sc, do, (lse, delta))
    do = _kernel_view(do)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    # dS of the whole [Tq, Tk] plane; tiles the causal loop never visits
    # stay zero, as the reference's dead-tile writes leave them
    ds = (torch.zeros((b, h, tq, k.shape[1]), dtype=torch.float32,
                      device=q.device) if want_ds else None)
    lc.call("paddle_flash_attention_bwd_dq", do.data_ptr(),
            lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
            dq.data_ptr(), None if ds is None else ds.data_ptr(), do=do)
    with _count_lock:
        launches_dq += 1
        launches_dq_bf16 += q.dtype == torch.bfloat16
    return dq, ds


def flash_attention_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, *,
                                 causal=False, scale=None):
    """Launch K2b; same contract as :func:`flash_attention_bwd_dkv_plain`."""
    global launches_dkv, launches_dkv_bf16
    b, _, h, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    lc = _Launch(q, k, v, bias, causal, sc, do, (lse, delta))
    do = _kernel_view(do)
    dk = torch.empty((b, k.shape[1], h, d), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty_like(dk)
    lc.call("paddle_flash_attention_bwd_dkv", do.data_ptr(),
            lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
            dk.data_ptr(), dv.data_ptr(), do=do)
    with _count_lock:
        launches_dkv += 1
        launches_dkv_bf16 += q.dtype == torch.bfloat16
    return dk, dv


def _is_cuda(q):
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    plain versions); other devices raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return q.device.type == "cuda"


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its recompute-based backward (the reference's
    ``_fa`` custom VJP). ``bias`` is rank 4 or None; ``bias_grad`` False
    gives a present bias a zero cotangent and skips the dS pass."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, bias_grad):
        fwd = (flash_attention_forward_cuda if _is_cuda(q)
               else flash_attention_forward_plain)
        o, lse = fwd(q, k, v, bias, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale, ctx.bias_grad = causal, scale, bias_grad
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        cuda = _is_cuda(q)
        dq, dk, dv, dbias = _backward_with(
            flash_attention_bwd_dq_cuda if cuda
            else flash_attention_bwd_dq_plain,
            flash_attention_bwd_dkv_cuda if cuda
            else flash_attention_bwd_dkv_plain,
            q, k, v, bias, o, lse, do, ctx.causal, ctx.scale,
            ctx.bias_grad and ctx.needs_input_grad[3])
        if bias is None or not ctx.needs_input_grad[3]:
            dbias = None
        elif dbias is None:
            dbias = torch.zeros_like(bias)
        else:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None, bias=None,
                    mask=None, bias_needs_grad: bool = True):
    """Blockwise (flash) attention.

    Args:
      q: ``[B, Tq, H, D]``.
      k, v: ``[B, Tk, Hkv, D]``; Hkv may divide H (GQA / MQA).
      causal: bottom-right-aligned causal masking.
      scale: logits scale, default ``1/sqrt(D)``.
      bias: additive logits bias ``[B|1, H|1, Tq|1, Tk|1]``; singleton
        dims broadcast inside the kernels, never materialized.
      mask: bool keep-mask of the same broadcastable shape, folded into the
        bias with ``NEG_INF`` (never differentiated).
      bias_needs_grad: False for a bias that is not trained: the dS pass,
        an O(B·H·Tq·Tk) f32 buffer, is skipped and the bias gets a zero
        gradient.

    Query rows with no visible key return zeros. Returns ``[B, Tq, H, D]``
    in q's dtype. CUDA tensors need D in {64, 128} and f32 or bf16.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    bias_grad = bias_needs_grad and bias is not None
    if mask is not None:
        m = torch.where(mask, torch.tensor(0.0, device=q.device),
                        torch.tensor(NEG_INF, device=q.device))
        bias = m if bias is None else bias + m
    _check(q, k, v, bias)
    return FlashAttentionFunction.apply(q, k, v, bias, bool(causal),
                                        float(scale), bias_grad)


__all__ = ["FlashAttentionFunction", "NEG_INF", "flash_attention",
           "flash_attention_backward_plain", "flash_attention_bwd_dkv_cuda",
           "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_dq_plain", "flash_attention_forward_cuda",
           "flash_attention_forward_plain"]
