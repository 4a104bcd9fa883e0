#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final line):

1. environment: card name and power limit (nvidia-smi), torch / CUDA
   versions, compute capability 9.0 required, TF32 off;
2. build the hand-written kernels from the sources in the checkout;
3. kernel vs plain version: paged attention over f32 / bf16 / int8 pools,
   T in {1, 5, 256 (S=1)}, G in {1, 4}, D in {64, 128}, and two tail
   prefills (S=1: T=1024 from position 0, T=200 after a 256-token cached
   prefix), each call checked to have run the regime its shape picks
   (``tile`` or ``split``); then its time at the serving path's shapes
   (decode, verify, prefill) in turns with one PyTorch library call
   (scaled_dot_product_attention over pre-gathered K/V, its backend
   named), beside the plain version and the card's two bounds;
4. serving at full width: GPT-3 1.3B (24 layers, random weights from a
   seed) through ``DecodeEngine`` — 8 greedy requests, paged bf16 KV,
   prefix sharing, prompt-lookup speculation — with the kernel's launch
   count checked against the layers x programs run (prefills all in the
   tile regime, decode and verify steps all in the split regime), and the
   token streams checked against the same run on the plain attention;
5. kernel vs plain through the engine at depth 2, f32 and int8 KV, in
   lockstep: per-step logits compared, greedy streams equal;
6. flash attention, kernels K1 (forward), K2a (dQ) and K2b (dK/dV) vs
   their plain versions: causal on / off, Tq = Tk, Tq < Tk and Tq > Tk
   (rows with no visible key), a single query row, three keys,
   G in {1, 2, 4}, D in {64, 128}, bias / bool-mask / broadcast variants,
   strided q/k/v views, f32 and bf16;
   then their times at the training shapes (B=2, T=2048, H=16, D=128,
   causal; f32 and bf16) beside the plain versions, one PyTorch library
   call (scaled_dot_product_attention forward, its autograd backward) and
   the card's bound; K1 timed in turns with SDPA's forward, the pair
   K2a + K2b in turns with SDPA's backward;
7. training at full width: GPT-3 1.3B (24 layers, random weights from a
   seed) through ``TrainStep`` + ``AdamW`` (Brown et al. 2020 settings)
   for 4 steps on one 2 x 2048-token batch, the flash kernels' launch
   counts checked against 24 layers x 4 steps, the first loss checked
   against a no-grad forward on the plain attention;
8. a kernel trainer and a plain-attention trainer in lockstep at depth 2
   for 3 steps: per-step losses and final parameters compared;
9. grouped matmul, kernels K4a (forward, and dlhs on a transposed rhs
   view) and K4b (drhs) vs their plain versions: the reference tests'
   group layouts (aligned, ragged, empty groups, trailing empties, a
   padding tail, a group over several tiles), N = 192, odd K and N, the
   Mixtral 8x7B top-2 routing (8192 rows, 4096 -> 14336, 8 experts,
   Dirichlet sizes) and 128 groups over 4096 rows, f32 and bf16;
10. the five grouped matmuls of one MoE training step at the Mixtral
   widths, in f32 and in bf16, each beside its plain version, one dense
   ``torch.matmul`` of the same FLOPs, a grouped library call
   (``torch._grouped_mm`` where it takes the dtype, else a per-expert
   ``torch.mm`` loop, labelled) and the card's bound;
11. MoE training at full width: Mixtral 8x7B's MoE block (dim 4096,
   hidden 14336, 8 experts, top-2; random weights from a seed), dropless,
   under a ``Linear(4096, 1)`` head with MSE + the aux loss, through
   ``TrainStep`` + ``AdamW`` (phase 7's settings at lr 1e-5) for 4 steps
   on one 2 x 2048-token batch:
   the loss falls, K4a launches 3 and K4b 2 per step, the first loss
   equals a no-grad forward on the plain grouped matmul;
12. a kernel trainer and a plain trainer in lockstep at reduced width
   (dim 1024, hidden 3584): step-1 loss and gradients, then per-step
   losses and the share of token slots routed alike;
13. serving Llama-3-8B at full width and depth (32 layers, 32 query heads
   over 8 kv heads, random weights from a seed) as phase 4 serves GPT:
   K3 folds the 4 query heads of each kv head into its rows, so verify
   steps (20 folded rows) run the tile regime; each regime's launches
   are checked against ``_k3_regime``; the greedy streams are compared
   with the plain attention's on f32 caches (``phase_serving`` says why);
14. phase 5 on Llama-3-8B at depth 2;
15. K1, K2a + K2b (B=2, T=2048, H=32, Hkv=8, D=128, causal; f32 and bf16,
   timed in turns with SDPA over GQA inputs) and K3 (decode, verify,
   prefill over a bf16 pool at Hkv=8, G=4) at the Llama shapes;
16. training Llama-3-8B's widths at depth 4 as phase 7 trains GPT (AdamW
   with Touvron et al. 2023 settings): the loss falls, 4 x 4 launches of
   each flash kernel, the first loss equals the plain attention's;
17. phase 8 on Llama-3-8B's widths at depth 2;
18. mixed precision: GPT-3 1.3B at full width and depth under
   ``auto_cast(level="O1")``, phase 7's AdamW with a warmup + cosine
   learning rate from ``optimizer/lr.py``, 4 steps: the loss falls, K1 /
   K2a / K2b launch in bf16 24 x 4 times each, the first loss is within
   ``AMP_LOSS_RTOL`` of phase 7's f32 loss on the same weights and batch;
19. the same at O2 after ``amp.decorate``: every parameter stays bf16,
   every moment and every master copy f32;
20. O1 with ``use_recompute=True`` (granularity "full"): the step-1 loss
   and every gradient bit-equal to the run without, K1 launched twice a
   layer a step (its forward runs again in the backward) and K2a / K2b
   once, and the training step's peak memory below phase 18's;
21. Llama-3-8B's widths at depth 4 under O1 as phase 16 (GQA K1 / K2 in
   bf16, 4 x 4 launches each, the first loss within ``AMP_LOSS_RTOL`` of
   phase 16's);
22. a kernel trainer and a plain-attention trainer under O1 at depth 2
   (GPT-3 1.3B), step-1 gradients and 3 steps' losses compared;
23. an ``amp`` JSON line (phases 18-21), a ``kernels`` JSON line (the GPT
   and MoE shapes), then the result line.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

DEVICE = "cuda"
SEED = 1234
NEW_TOKENS = 32
KERNEL_ATOL = 1e-4    # f32 accumulation on identical stored inputs
# per-step logits (|logit| ~5) at depth 2, kernel vs plain engine: with
# f32 KV only the attention's summation order differs; with int8 KV the
# layer-2 K/V are quantized from layer-1 outputs that differ by ulps, so
# an element can land one int8 level (scale / 127) apart
ENGINE_LOGIT_ATOL = {"f32": 1e-4, "int8": 1e-3}
PROMPT_LENGTHS = (17, 40, 90, 150, 300, 350, 480, 600)
SHARED_PREFIX = 256
# published peaks (NVIDIA data sheets, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, TF32 and bf16 tensor-core FLOP/s
CARD_PEAKS = {
    "SXM": dict(bw=3.35e12, f32=67e12, tf32=495e12, bf16=989e12),
    "PCIe": dict(bw=2.0e12, f32=51e12, tf32=378e12, bf16=756e12),
    "NVL": dict(bw=3.9e12, f32=60e12, tf32=417.5e12, bf16=835e12),
}
# TF32 products per f32-accurate product on the tensor cores: both
# operands f32 (hi.hi + hi.lo + lo.hi), or one exact in TF32 (a bf16 or
# int8 value: hi.b + lo.b)
TF32_PASSES = {"f32": 3, "f32x": 2}
# flash kernels vs plain, as max|err| / max|ref|. f32: both accumulate in
# f32 in different orders. bf16 o and dq are stored in bf16 (one ulp =
# 2^-8 relative), and the kernel rounds P to bf16 against the running row
# max where the plain version uses the final one: two ulps. lse, dS and
# the f32 per-query-head dK / dV keep the f32 tolerance in both dtypes.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# GPT-3 (Brown et al. 2020): Table 2.1 lr for 1.3B, Appendix B AdamW
ADAMW = dict(learning_rate=2e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
             weight_decay=0.1)
# first full-width loss, kernel vs plain attention: f32 through 24 layers,
# only the attention's summation order differs; the loss (~ln 50304) is a
# mean over 4096 tokens
TRAIN_LOSS_RTOL = 2e-5
LOCKSTEP_STEPS = 3
# lockstep parameters: Adam moves an element by about lr * sign(g), so an
# element whose gradient is float noise on both sides (the key bias: its
# exact gradient is 0) can drift by up to 2 * lr per step; all elements
# must stay within that, and all but 1 % within LOCKSTEP_PARAM_ATOL
# (0.2 % of the 3-step move 3 * lr)
LOCKSTEP_PARAM_ATOL = 1e-6
# Mixtral 8x7B's MoE block (Jiang et al. 2024, arXiv:2401.04088, Table 1):
# dim, hidden_dim, experts, top-k. The expert is the repo's MoELayer FFN
# (GELU, with biases), not Mixtral's SwiGLU.
MOE_DIM, MOE_HIDDEN, MOE_EXPERTS, MOE_TOP_K = 4096, 14336, 8, 2
MOE_LOCKSTEP_DIMS = (1024, 3584)
# the MoE runs take phase 7's AdamW and clip with a smaller step: the
# reference's XavierNormal gives the stacked expert weights [8, 4096,
# 14336] conv-layout fans and a std of 1.8e-4, below one Adam step at lr
# 2e-4, and at that lr the loss fell once and then diverged on the card
# (1.05, 0.93, 8.38, 13.53); 1e-5 moves each weight ~5 % of its std a step
MOE_ADAMW = dict(ADAMW, learning_rate=1e-5)
# grouped matmul kernel vs plain, as max|err| / max|ref|: f32 sums of up
# to 14336 products in another order than cuBLAS (TF32 off); a bf16
# output is stored in bf16 (one ulp = 2^-8 relative); drhs leaves in f32
# in both dtypes and keeps the f32 tolerance
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# first MoE loss, kernel vs plain grouped matmul: only the expert
# products' summation order differs, and the MoE output is ~1e-4 of the
# ~1.0 MSE, so the loss agrees far inside f32 rounding of its value
MOE_LOSS_RTOL = 1e-6
# lockstep step-1 gradients, max|err| / max|grad| per parameter: f32 sums
# of up to 4096 products in other orders (the gate's gradient flows
# through the expert outputs)
MOE_GRAD_RTOL = 1e-4
# Llama-3-8B: the published config.json of meta-llama/Meta-Llama-3-8B
# (Dubey et al. 2024, arXiv:2407.21783, Table 3: the same layers, widths,
# heads and RoPE theta). G = 32 / 8 = 4 query heads per kv head.
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=8, max_position_embeddings=8192,
                 rms_norm_eps=1e-5, rope_theta=500000.0,
                 tie_word_embeddings=False)
# training keeps every width and cuts the depth: f32 weights, gradients
# and two Adam moments take 16 B a parameter, 128 GB at 32 layers; 4
# layers and the untied embeddings / head hold 1.92 B parameters (30.8 GB)
LLAMA_TRAIN_LAYERS = 4
# Touvron et al. 2023 (arXiv:2307.09288, section 2.2): AdamW beta1 0.9,
# beta2 0.95, eps 1e-5, weight decay 0.1, clip 1.0; lr 3e-4 (Dubey et al.
# 2024's peak for 8B), held constant
LLAMA_ADAMW = dict(learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-5,
                   weight_decay=0.1)
# AMP (phases 18-22). bf16 keeps 8 significant bits: unit roundoff 2^-8.
BF16_U = 2.0 ** -8
# first bf16 (O1) loss against the f32 run's on the same weights and batch:
# the reference's CE runs in bf16 (parallel_cross_entropy is on neither
# list), so four roundings happen at the loss's own scale, each within
# 2^-8 of it: the logits, the log-sum-exp, the log-probabilities and the
# mean; the body's bf16 roundings move single logits, which the mean over
# 4096 tokens averages
AMP_LOSS_RTOL = 4 * BF16_U
# GPT-3's schedule (Brown et al. 2020, Appendix B): linear warmup, then
# cosine decay to 10 % of the peak; here over a few steps: warmup 2 steps
# from 10 %, the cosine over 1000
WARMUP_STEPS, COSINE_STEPS = 2, 1000
# depth-2 lockstep under O1, kernel vs plain attention: the loss is stored
# in bf16 (one ulp is 2^-7 of it at most), and the kernels' outputs differ
# from the plain versions' by up to two bf16 ulps (FLASH_TOL), far below
# one ulp of the mean over 4096 tokens: the loss may differ in its last bit
AMP_LOCKSTEP_LOSS_RTOL = 2 * BF16_U
# step-1 gradients, max|err| / max|grad| per parameter: two ulps (4 u)
# from the kernels' bf16 outputs, and one ulp (2 u) for each bf16 rounding
# between them and a weight gradient at depth 2 (the dX product of the
# layer above, the dW product, its cast): 10 u, rounded up to 16 u
AMP_GRAD_RTOL = 16 * BF16_U


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def card_peaks(name: str):
    """The published peaks of the card named (``form`` = its form factor)."""
    for form in ("PCIe", "NVL"):
        if form in name:
            return dict(CARD_PEAKS[form], form=form)
    return dict(CARD_PEAKS["SXM"], form="SXM")


def bounds(nbytes, flops, kind, peaks):
    """The least time for a call that moves ``nbytes`` and does ``flops``
    (2 per multiply-add) of ``kind``: ``"f32"`` (f32 x f32), ``"f32x"``
    (f32 x a value exact in TF32) or ``"bf16"``. Two bounds: on f32 FMAs
    (67 TFLOP/s; bf16 at its tensor-core peak), and on tensor cores (the
    f32-accurate products as TF32_PASSES TF32 products at 495 TFLOP/s,
    bf16 at 989), each the larger of the bytes' and the operations' time.
    ``bound_ms`` is the tensor-core bound, the least time of the two: a
    kernel's share of it cannot pass 100 %."""
    t_bytes = nbytes / peaks["bw"] * 1e3
    if kind == "bf16":
        t_fma = t_tc = flops / peaks["bf16"] * 1e3
    else:
        t_fma = flops / peaks["f32"] * 1e3
        t_tc = flops * TF32_PASSES[kind] / peaks["tf32"] * 1e3
    return dict(bound_ms=max(t_bytes, t_tc),
                bound_by="bytes" if t_bytes >= t_tc else "operations",
                bound_fma_ms=max(t_bytes, t_fma),
                bound_fma_by="bytes" if t_bytes >= t_fma else "operations")


def bound_text(row, ms):
    """The two bounds of a row and the kernel's share of the least."""
    return (f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, tensor "
            f"cores), {row['bound_fma_ms']:.4f} ms ({row['bound_fma_by']}, "
            f"f32 FMA), {100 * row['bound_ms'] / ms:.1f} % of bound")


def cuda_ms(fn, iters=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20, reps=5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's cost of issuing them (a Python
    wrapper's checks and allocations) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (iters * reps)


# -- phase 3 helpers ---------------------------------------------------------


def make_case(rng, *, s, t, hkv, group, d, kv, ctx=None, p=16, mp=64,
              layers=1):
    """Random paged case on the card: ragged contexts (or the given ones),
    unused table entries on the trash page 0, ``layers`` independent pool
    copies (to time with a cold L2)."""
    dev = DEVICE
    h = hkv * group
    n = 1 + s * mp
    if ctx is None:
        ctx = rng.integers(t, mp * p + 1, size=s)
    ctx = np.asarray(ctx)
    table = np.zeros((s, mp), np.int32)
    perm = rng.permutation(np.arange(1, n))
    nxt = 0
    for i in range(s):
        used = -(-int(ctx[i]) // p)
        table[i, :used] = perm[nxt:nxt + used]
        nxt += used
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((s, t, h, d), generator=g, device=dev)
    shape = (layers, n, hkv, p, d)
    if kv == "int8":
        kp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ks = 0.005 + 0.025 * torch.rand(shape[:-1], generator=g, device=dev)
        vs = 0.005 + 0.025 * torch.rand(shape[:-1], generator=g, device=dev)
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        kp = torch.randn(shape, generator=g, device=dev).to(dt)
        vp = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs,
                table=torch.as_tensor(table, device=dev),
                start=torch.as_tensor((ctx - t).astype(np.int32),
                                      device=dev), ctx=ctx, p=p)


def case_args(c, layer=0):
    pick = lambda x: None if x is None else x[layer]  # noqa: E731
    return ((c["q"], c["kp"][layer], c["vp"][layer], c["table"],
             c["start"]), dict(k_scales=pick(c["ks"]), v_scales=pick(c["vs"])))


def gathered_for_library(c):
    """Dense K/V per query head [S, H, K, D] f32 and a bool mask
    [S, 1, T, K] for scaled_dot_product_attention (the yardstick)."""
    q, kp, vp, ks, vs, table, start = (c["q"], c["kp"][0], c["vp"][0],
                                       c["ks"], c["vs"], c["table"],
                                       c["start"])
    s, t, h, d = q.shape
    hkv, p = kp.shape[1], kp.shape[2]
    kf, vf = kp.float(), vp.float()
    if ks is not None:
        kf, vf = kf * ks[0][..., None], vf * vs[0][..., None]
    k_len = int(c["ctx"].max())

    def gather(pool):
        g = pool[table.long()].transpose(1, 2).reshape(
            s, hkv, -1, d)[:, :, :k_len]
        return g.repeat_interleave(h // hkv, dim=1).contiguous()

    qpos = start.long()[:, None] + torch.arange(t, device=DEVICE)[None]
    mask = (torch.arange(k_len, device=DEVICE)[None, None]
            <= qpos[:, :, None])[:, None]
    return (q.transpose(1, 2).contiguous(), gather(kf), gather(vf), mask)


def bound(c, peaks):
    """:func:`bounds` of this call: each input byte the call needs read
    once (the live keys of each slot, not whole page slots), the output
    written once; QK and PV f32-accurate, with one operand exact in TF32
    unless the pool is f32."""
    q, kp = c["q"], c["kp"]
    s, t, h, d = q.shape
    hkv, p = kp.shape[2], c["p"]
    group = h // hkv
    start = c["start"].cpu().numpy().astype(np.int64)
    keys = start + t  # keys visible to the slot's last row
    per_key = 2 * hkv * d * kp.element_size()
    if c["ks"] is not None:
        per_key += 2 * hkv * 4
    nbytes = (int(keys.sum()) * per_key + 2 * q.numel() * 4
              + int((-(-keys // p)).sum()) * 4 + s * 4)
    # row t of slot i sees start + t + 1 keys; QK and PV: 2 FLOPs each
    seen = (start[:, None] + np.arange(t)[None] + 1).sum()
    flops = 4 * int(seen) * group * hkv * d
    kind = "f32" if kp.dtype == torch.float32 else "f32x"
    return bounds(nbytes, flops, kind, peaks)


K3_COUNTERS = ("launches", "launches_tile", "launches_split",
               "launches_decode", "launches_verify")


def k3_counts(pa):
    return tuple(getattr(pa, n) for n in K3_COUNTERS)


def checked_call(pa, args, kw, expect, tag):
    """paged_attention(*args, **kw), raising unless exactly one launch of
    the ``expect`` regime (and, in the split regime, of the decode or the
    verify count by T) was counted."""
    before = k3_counts(pa)
    got = pa.paged_attention(*args, **kw)
    moved = tuple(a - b for a, b in zip(k3_counts(pa), before))
    t = args[0].shape[1]
    want = ((1, 1, 0, 0, 0) if expect == "tile" else
            (1, 0, 1, int(t == 1), int(t > 1)))
    if moved != want:
        raise AssertionError(f"{tag}: launches {K3_COUNTERS} moved by "
                             f"{moved}, expected {want}")
    return got


def phase_kernel_sweep(pa, atol=KERNEL_ATOL):
    """Every case against the plain version; raises past ``atol``.
    Returns the worst max|err| of each regime."""
    rng = np.random.default_rng(SEED)
    worst = {"tile": 0.0, "split": 0.0}
    log("# phase 3: kernel vs plain (P=16, MP=64, Hkv=4, atol "
        f"{atol})")
    cases = [dict(s=s, t=t, group=group, d=d)
             for s, t in ((8, 1), (8, 5), (1, 256))
             for group in (1, 4) for d in (64, 128)]
    # tail prefills: a whole 1024-token bucket from position 0, and 200
    # tokens (not a multiple of the 64-row tile) after a 256-token prefix
    cases += [dict(s=1, t=1024, group=1, d=128, ctx=[1024]),
              dict(s=1, t=200, group=1, d=128, ctx=[456])]
    for kv in ("f32", "bf16", "int8"):
        for case in cases:
            c = make_case(rng, hkv=4, kv=kv, **case)
            args, kw = case_args(c)
            expect = pa._k3_regime(case["t"], case["group"])
            tag = (f"kv={kv:4s} S={case['s']} T={case['t']:4d} "
                   f"start={int(c['start'].min().item()):4d} "
                   f"G={case['group']} D={case['d']:3d} {expect:5s}")
            got = checked_call(pa, args, kw, expect, tag)
            ref = pa.paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            worst[expect] = max(worst[expect], err)
            log(f"{tag} max_abs_err={err:.3e}")
            if not err <= atol:
                raise AssertionError(
                    f"kernel disagrees with plain: {err} > {atol}")
    return worst


def time_main_shapes(pa, peaks, contexts, hkv=16, group=1):
    """The kernel at a serving path's shapes (GPT-3 1.3B: H=Hkv=16;
    Llama-3-8B: Hkv=8, G=4; D=128, bf16 pool, P=16, MP=64): decode (S=8,
    T=1), verify (S=8, T=5) and the 600-token prompt's tail prefill (S=1,
    T=1024 bucket), each in the regime ``_k3_regime`` picks (verify: split
    at G=1, tile at G=4). Four pool copies are cycled so each
    launch finds a cold L2. The kernel and the library call are timed in
    turns (kernel, library, plain, library, kernel) and averaged, each as
    device time (:func:`graph_ms`: ``ms``, ``library_ms``, ``plain_ms``)
    and as a host loop of calls (:func:`cuda_ms`: ``loop_ms``,
    ``library_loop_ms``, ``plain_loop_ms``; what the engine, which runs
    without graphs, pays)."""
    from torch.nn.attention import sdpa_kernel

    rng = np.random.default_rng(SEED + 1)
    shapes = {
        "decode": dict(s=8, t=1, ctx=contexts),
        "verify": dict(s=8, t=5, ctx=np.asarray(contexts) + 4),
        "prefill": dict(s=1, t=1024, ctx=[1024]),
    }
    rows = {}
    for name, sh in shapes.items():
        c = make_case(rng, hkv=hkv, group=group, d=128, kv="bf16",
                      layers=4, **sh)
        calls = [case_args(c, layer) for layer in range(4)]
        state = {"i": 0}

        def run(fn):
            def go():
                args, kw = calls[state["i"] % 4]
                state["i"] += 1
                return fn(*args, **kw)
            return go

        expect = pa._k3_regime(sh["t"], group)
        got = checked_call(pa, *calls[0], expect, name)
        ref = pa.paged_attention_plain(*calls[0][0], **calls[0][1])
        err = (got - ref).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name}: kernel disagrees, {err}")
        qh, kh, vh, mask = gathered_for_library(c)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        be = sdpa_backend(qh, kh, vh, attn_mask=mask)
        with sdpa_kernel([be]):
            def lib():
                return sdpa(qh, kh, vh, attn_mask=mask)
            kern = run(pa.paged_attention)
            plain = run(pa.paged_attention_plain)
            turns = [graph_ms(kern), graph_ms(lib)]
            loops = [cuda_ms(kern), cuda_ms(lib)]
            plain_ms, plain_loop_ms = graph_ms(plain), cuda_ms(plain)
            loops += [cuda_ms(lib), cuda_ms(kern)]
            turns += [graph_ms(lib), graph_ms(kern)]
        ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, regime=expect,
                          loop_ms=(loops[0] + loops[3]) / 2,
                          library_loop_ms=(loops[1] + loops[2]) / 2,
                          plain_loop_ms=plain_loop_ms, **bound(c, peaks))
        log(f"{name:8s} S={sh['s']} T={sh['t']:4d} Hkv={hkv} G={group} "
            f"[{expect}]: kernel "
            f"{ms:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}), sdpa "
            f"[{be.name}] {library_ms:.4f} ms ({turns[1]:.4f}, "
            f"{turns[2]:.4f}), plain {plain_ms:.4f} ms; host loop: kernel "
            f"{rows[name]['loop_ms']:.4f} ms, sdpa "
            f"{rows[name]['library_loop_ms']:.4f} ms, plain "
            f"{plain_loop_ms:.4f} ms; {bound_text(rows[name], ms)}, "
            f"max_abs_err {err:.3e}")
    return rows


# -- phases 4 and 5 ----------------------------------------------------------


def make_prompts(vocab):
    """8 prompts of 17..600 tokens, periodic (period 8) so prompt-lookup
    drafts exist; prompts 4 and 5 share a 256-token prefix."""
    rng = np.random.default_rng(SEED)

    def periodic(n):
        return np.resize(rng.integers(1, vocab, 8), n)

    prompts = [periodic(n) for n in PROMPT_LENGTHS]
    shared = periodic(SHARED_PREFIX)
    for i in (4, 5):
        prompts[i] = np.concatenate(
            [shared, periodic(PROMPT_LENGTHS[i] - SHARED_PREFIX)])
    return prompts


def engine_config(**kw):
    return dict(num_slots=8, max_length=1024, page_size=16,
                speculate_k=4, spec_adaptive=False, prefix_cache=True,
                seed=SEED, device=DEVICE, **kw)


def build_model(layers, **kw):
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b(num_hidden_layers=layers,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **kw)
    return GPTForCausalLM(cfg, device=DEVICE, seed=SEED)


def build_llama(layers):
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)

    cfg = LlamaConfig(**dict(LLAMA3_8B, num_hidden_layers=layers))
    return LlamaForCausalLM(cfg, device=DEVICE, seed=SEED)


def serve(engine, prompts):
    rids = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    engine.run()
    return [engine.result(r) for r in rids]


def k3_expected(pa, layers, st, eng, group):
    """K3 launches the run should count, (tile, split, decode, verify):
    layers x programs, each program in the regime ``_k3_regime`` picks
    for its rows (prefill buckets, decode T = 1, verify T = k + 1), and
    of the split ones the decode (T = 1) and verify (T > 1) counts."""
    want = dict(tile=0, split=0, decode=0, verify=0)
    progs = ((min(eng.buckets), st["prefill_calls"]),
             (1, st["decode_steps"] - st["verify_steps"]),
             (eng.config.speculate_k + 1, st["verify_steps"]))
    for t, n in progs:
        regime = pa._k3_regime(t, group)
        want[regime] += layers * n
        if regime == "split":
            want["decode" if t == 1 else "verify"] += layers * n
    return tuple(want[k] for k in ("tile", "split", "decode", "verify"))


def report_divergence(fa, model, prompts, outs, ref):
    """Where the kernel and plain engines' streams first part: the request,
    the token, and the top-2 logits (and their margin) of a full forward
    over the common context, once with K1 and once on the plain
    attention."""
    for i, (a, b) in enumerate(zip(outs, ref)):
        if np.array_equal(a, b):
            continue
        j = int(np.flatnonzero(np.asarray(a) != np.asarray(b))[0])
        ctx = torch.as_tensor(np.asarray(a[:j])[None], device=DEVICE)
        tops = []
        for plain in (False, True):
            with (plain_attention(fa) if plain else contextlib.nullcontext()
                  ), torch.no_grad():
                v, ix = torch.topk(model(ctx)[0, -1].float(), 2)
            tops.append(f"{'plain' if plain else 'K1'} top-2 ids "
                        f"{ix.tolist()} logits {v.tolist()} margin "
                        f"{(v[0] - v[1]).item():.3e}")
        log(f"request {i}: first divergent token {j - len(prompts[i])} "
            f"(position {j}): kernel engine {a[j]}, plain engine {b[j]}; "
            f"full forward over the common context: " + "; ".join(tops))
        return


def phase_serving(pa, fa, smi, build, label, phase, gate_kv="bf16"):
    """Serve ``make_prompts`` through ``DecodeEngine`` on the model
    ``build()`` makes: bf16 KV, prefix sharing, speculation; gates on the
    tokens, the prefix hit, a verify step, K3's launches per regime, the
    device of parameters and pools and finite logits. Then greedy streams
    equal to the plain-attention engine's, both with ``gate_kv`` KV: the
    timed run itself for bf16 (GPT-3 1.3B). Llama-3-8B compares f32
    caches: at 32 layers the bf16 cache's rounding turns the kernel's
    ~2e-6 per-step logit differences from the plain attention (f32 KV)
    into ~2e-4 (``scripts/engine_kv_drift.py``), above the smallest top-2
    margins of its random 128256-way logits, so equal bf16 streams would
    test the cache's rounding, not the kernel."""
    from paddle_tpu_torch.inference.engine import DecodeEngine

    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    log(f"# phase {phase}: {label} built on the card in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    eng = DecodeEngine(model, kv_dtype="bf16", **engine_config())
    t0 = time.perf_counter()
    eng.warmup()
    log(f"engine warmup (every program once, trash page only) "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    prompts = make_prompts(model.config.vocab_size)

    for n in K3_COUNTERS:
        setattr(pa, n, 0)
    t0 = time.perf_counter()
    outs = serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tile, split, decode, verify = k3_counts(pa)

    st = eng.stats()
    ad = eng.adapter
    layers, group = ad.num_layers, ad.num_heads // ad.num_kv_heads
    programs = st["prefill_calls"] + st["decode_steps"]
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + NEW_TOKENS:
            raise AssertionError("a request did not emit 32 new tokens")
        if not ((o >= 0) & (o < model.config.vocab_size)).all():
            raise AssertionError("token id out of the vocabulary")
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError("no prefix hit")
    if st["verify_steps"] <= 0:
        raise AssertionError("no speculative verify step ran")
    if launches != layers * programs:
        raise AssertionError(
            f"kernel launches {launches} != {layers} layers x {programs} "
            "programs")
    want = k3_expected(pa, layers, st, eng, group)
    if (tile, split, decode, verify) != want:
        raise AssertionError(
            f"launches (tile, split, decode, verify) = "
            f"{(tile, split, decode, verify)}, expected {want} from "
            f"_k3_regime at G={group}: {layers} x ({st['prefill_calls']} "
            f"prefills, {st['decode_steps']} steps of which "
            f"{st['verify_steps']} verify)")
    tensors = [*model.parameters(), *model.buffers(), eng._kc, eng._vc]
    if not all(x.device.type == DEVICE for x in tensors):
        raise AssertionError("a parameter or pool is off the card")
    _, last = eng.last_step
    if not torch.isfinite(last).all():
        raise AssertionError("non-finite logits")
    tokens = st["total_tokens"]
    log(f"served {len(prompts)} requests: {tokens} tokens in {wall:.3f} s "
        f"= {tokens / wall:.1f} tok/s; prefill {st['prefill_calls']} calls "
        f"mean {1e3 * st['prefill_seconds'] / st['prefill_calls']:.2f} ms; "
        f"decode steps {st['decode_steps']} (verify {st['verify_steps']}) "
        f"mean {1e3 * st['step_seconds'] / st['decode_steps']:.2f} ms; "
        f"prefix_hit_tokens {st['prefix_hit_tokens']}; spec accepted "
        f"{st['spec_accepted']}/{st['spec_proposed']}; kernel launches "
        f"{launches} = {layers} x {programs} (G={group}: tile {tile}, "
        f"split {split}: decode {decode}, verify {verify})  [{smi}]")

    if gate_kv != "bf16":
        outs = serve(DecodeEngine(model, kv_dtype=gate_kv, **engine_config()),
                     prompts)
    plain = DecodeEngine(model, kv_dtype=gate_kv, attn_kernel="plain",
                         **engine_config())
    ref = serve(plain, prompts)
    same = sum(np.array_equal(a, b) for a, b in zip(outs, ref))
    log(f"full-width greedy streams ({gate_kv} KV) equal to the "
        f"plain-attention run: {same}/{len(prompts)}")
    if same != len(prompts):
        report_divergence(fa, model, prompts, outs, ref)
        raise AssertionError("full-width streams differ from plain")
    contexts = [len(p) + NEW_TOKENS // 2 for p in prompts]
    del eng, plain, model
    torch.cuda.empty_cache()
    return dict(contexts=contexts, tokens_per_s=tokens / wall,
                decode_ms=1e3 * st["step_seconds"] / st["decode_steps"],
                prefill_ms=1e3 * st["prefill_seconds"] / st["prefill_calls"],
                launches=dict(tile=tile, split=split, decode=decode,
                              verify=verify))


def lockstep(kernel_eng, plain_eng, prompts):
    """Step both engines together on the same requests. Each step's logits
    of the active slots are compared; the kernel engine's tokens are then
    overwritten with the plain engine's (teacher forcing along the plain
    run), counting every disagreement. Verify rows past a request's token
    budget are not compared: their positions lie beyond the request's
    pages, so their K/V land on the shared trash page (as in the
    reference) and they are never emitted."""
    ra = [kernel_eng._requests[kernel_eng.submit(p, max_new_tokens=NEW_TOKENS)]
          for p in prompts]
    rb = [plain_eng._requests[plain_eng.submit(p, max_new_tokens=NEW_TOKENS)]
          for p in prompts]
    worst, mismatches, steps = 0.0, 0, 0
    while True:
        before = {r.slot: len(r.tokens) for r in rb if r.status == "running"}
        if not plain_eng.step():
            break
        kernel_eng.step()
        steps += 1
        sa, la = kernel_eng.last_step
        sb, lb = plain_eng.last_step
        if sa != sb or la.shape != lb.shape:
            raise AssertionError("engines took different steps")
        for slot in sb:
            # a request admitted in this step holds its prefill token
            rows = NEW_TOKENS - before.get(slot, 1)
            d = (la[slot] - lb[slot]).abs()
            worst = max(worst, (d if d.dim() == 1 else d[:rows]).max().item())
        for a, b in zip(ra, rb):
            if a.tokens != b.tokens:
                mismatches += 1
                if len(a.tokens) != len(b.tokens):
                    raise AssertionError("token counts diverged")
                a.tokens[:] = b.tokens
    if kernel_eng.step():
        raise AssertionError("kernel engine outlived the plain one")
    return worst, mismatches, steps


def phase_engine_parity(build, label, phase):
    """The kernel and plain engines in :func:`lockstep` on the model
    ``build()`` makes, f32 and int8 KV."""
    from paddle_tpu_torch.inference.engine import DecodeEngine

    model = build()
    prompts = make_prompts(model.config.vocab_size)
    for kv in ("f32", "int8"):
        a = DecodeEngine(model, kv_dtype=kv, **engine_config())
        b = DecodeEngine(model, kv_dtype=kv, attn_kernel="plain",
                         **engine_config())
        worst, mismatches, steps = lockstep(a, b, prompts)
        log(f"# phase {phase}: {label}, kv {kv}: {steps} steps, max "
            f"|logit kernel - plain| {worst:.3e} (atol "
            f"{ENGINE_LOGIT_ATOL[kv]}), token mismatches {mismatches}")
        if not worst <= ENGINE_LOGIT_ATOL[kv]:
            raise AssertionError(f"logits differ by {worst}")
        if mismatches:
            raise AssertionError("greedy streams differ")
        del a, b
    del model
    torch.cuda.empty_cache()


# -- phase 6: flash attention kernels ----------------------------------------

FLASH_REPLACES = {
    "fwd": "paddle_tpu/ops/pallas/flash_attention.py:136",
    "dq": "paddle_tpu/ops/pallas/flash_attention.py:332",
    "dkv": "paddle_tpu/ops/pallas/flash_attention.py:379",
}

# (causal, Tq, Tk, H, Hkv, D, dtype, bias code, mask code, strided): bias /
# mask dims B, H, Q(Tq), K(Tk) or 1
FLASH_CASES = (
    (True, 300, 300, 4, 4, 128, torch.float32, None, None, False),
    (True, 200, 333, 4, 2, 64, torch.float32, "B11K", None, False),
    (True, 333, 200, 8, 2, 128, torch.float32, None, None, False),
    (False, 256, 256, 2, 2, 64, torch.float32, "1HQK", None, False),
    (False, 130, 270, 4, 1, 128, torch.float32, "1111", None, False),
    (False, 192, 192, 2, 2, 128, torch.float32, None, "B1QK", False),
    (True, 384, 384, 4, 4, 128, torch.float32, None, None, True),
    (True, 300, 300, 4, 2, 128, torch.bfloat16, None, None, False),
    (False, 200, 333, 2, 2, 64, torch.bfloat16, "B11K", None, False),
    (True, 256, 256, 4, 4, 64, torch.bfloat16, None, None, True),
    (True, 1, 77, 4, 2, 64, torch.float32, "1H1K", None, False),
    (False, 17, 3, 2, 2, 128, torch.float32, None, None, False),
    (True, 65, 65, 16, 16, 128, torch.bfloat16, "11QK", None, False),
)


def _dims(code, b, h, tq, tk):
    return tuple({"B": b, "H": h, "Q": tq, "K": tk, "1": 1}[c] for c in code)


def flash_inputs(gen, b, tq, tk, h, hkv, d, dtype, strided):
    """q, k, v, dO on the card; strided: q/k/v as the model slices them out
    of one fused [B, T, H, 3, D] projection."""
    dev = DEVICE
    if strided:
        qkv = torch.randn((b, tq, h, 3, d), generator=gen, device=dev)
        q, k, v = (qkv.to(dtype)[:, :, :, i] for i in range(3))
    else:
        q = torch.randn((b, tq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, tk, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, tk, hkv, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, tq, h, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _rel(got, ref):
    """(max|err|, max|err| / max|ref|) in f32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def compare_flash(fa, q, k, v, do, bias, causal, bias_grad, worst, tag):
    """Each kernel vs its plain version on the same inputs; the backward
    halves get the kernel forward's o and lse. Updates worst[kernel] with
    the largest max|err| and raises past the tolerance."""
    tol = FLASH_TOL[q.dtype]
    kw = dict(causal=causal)
    o, lse = fa.flash_attention_forward_cuda(q, k, v, bias, **kw)
    o_p, lse_p = fa.flash_attention_forward_plain(q, k, v, bias, **kw)
    delta = fa._delta(o, do).contiguous()
    dq, ds = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, do, lse, delta,
                                            want_ds=bias_grad, **kw)
    dq_p, ds_p = fa.flash_attention_bwd_dq_plain(q, k, v, bias, do, lse,
                                                 delta, want_ds=bias_grad,
                                                 **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, bias, do, lse, delta,
                                             **kw)
    dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse,
                                                  delta, **kw)
    torch.cuda.synchronize()
    live = lse_p > fa.NEG_INF * 0.5
    if not torch.equal(lse[~live], lse_p[~live]):
        raise AssertionError(f"{tag}: rows with no visible key differ")
    if not torch.equal(o.float()[~live.transpose(1, 2)],
                       torch.zeros_like(o.float()[~live.transpose(1, 2)])):
        raise AssertionError(f"{tag}: a row with no visible key is not 0")
    pairs = [("fwd", "o", o, o_p, tol), ("fwd", "lse", lse[live],
                                          lse_p[live], 1e-4),
             ("dq", "dq", dq, dq_p, tol), ("dkv", "dk", dk, dk_p, 1e-4),
             ("dkv", "dv", dv, dv_p, 1e-4)]
    if bias_grad:
        pairs.append(("dq", "ds", ds, ds_p, 1e-4))
    line = []
    for kern, name, got, ref, t in pairs:
        if not ref.abs().max().item() > 0:
            raise AssertionError(f"{tag}: {name} is all zero")
        err, rel = _rel(got, ref)
        worst[kern] = max(worst.get(kern, 0.0), err)
        line.append(f"{name} {rel:.1e}")
        if not rel <= t:
            raise AssertionError(f"{tag}: {name} differs from plain: "
                                 f"{rel} > {t} (max|err| {err})")
    log(f"{tag}: rel err " + ", ".join(line))


def flash_case(fa, gen, case):
    """The inputs of one FLASH_CASES entry (batch 2) on the card: q, k, v,
    dO, the bias (or bool mask as a NEG_INF bias, or None), causal, whether
    the bias takes a gradient, and a tag."""
    causal, tq, tk, h, hkv, d, dt, bcode, mcode, strided = case
    b = 2
    q, k, v, do = flash_inputs(gen, b, tq, tk, h, hkv, d, dt, strided)
    bias = None
    if bcode is not None:
        bias = torch.randn(_dims(bcode, b, h, tq, tk), generator=gen,
                           device=DEVICE)
    if mcode is not None:
        keep = torch.rand(_dims(mcode, b, h, tq, tk), generator=gen,
                          device=DEVICE) > 0.3
        keep[0, 0, 7] = False  # a row that sees no key
        bias = torch.where(keep, 0.0, fa.NEG_INF)
    tag = (f"{'causal' if causal else 'full  '} Tq={tq:3d} Tk={tk:3d} "
           f"H={h} G={h // hkv} D={d:3d} {str(dt)[6:]:8s} "
           f"bias={bcode or mcode or '-'}{' strided' if strided else ''}")
    return q, k, v, do, bias, causal, bcode is not None, tag


def phase_flash_sweep(fa):
    """Returns the worst max|err| per kernel over the f32 cases."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    worst, worst_bf16 = {}, {}
    log("# phase 6a: flash kernels vs plain (tolerance max|err|/max|ref|: "
        f"f32 1e-4, bf16 o/dq {FLASH_TOL[torch.bfloat16]:.2e})")
    for case in FLASH_CASES:
        q, k, v, do, bias, causal, bias_grad, tag = flash_case(fa, gen, case)
        compare_flash(fa, q, k, v, do, bias, causal, bias_grad,
                      worst if q.dtype == torch.float32 else worst_bf16, tag)
    log(f"worst max|err| f32 {worst}, bf16 {worst_bf16}")
    return worst


def flash_bound(kind, q, k, causal, peaks):
    """:func:`bounds`: each input read once, each output written once; QK,
    dP, P.V, dQ, dK, dV as 2 * D FLOPs per visible (query, key) pair, of
    the inputs' type."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qi = np.arange(tq)
    pairs = (int(np.clip(qi + tk - tq + 1, 0, tk).sum()) if causal
             else tq * tk)
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * d * products * pairs * b * h
    elt = q.element_size()
    qb, kvb, rows = b * tq * h * d * elt, b * tk * hkv * d * elt, b * h * tq * 4
    nbytes = {"fwd": 2 * qb + 2 * kvb + rows,
              "dq": 3 * qb + 2 * kvb + 2 * rows,
              "dkv": 2 * qb + 2 * kvb + 2 * rows + 2 * b * tk * h * d * 4}[kind]
    return bounds(nbytes, flops,
                  "f32" if q.dtype == torch.float32 else "bf16", peaks)


def sdpa_backend(qh, kh, vh, **kw):
    """The first SDPA backend, in PyTorch's order of preference, that runs
    these inputs (and keywords: ``is_causal`` or ``attn_mask``): pinned,
    so the yardstick names what it timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a refused backend warns why before it raises
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                sdpa(qh, kh, vh, **kw)
            return be
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend runs these inputs")


def sdpa_yardsticks(q, k, v):
    """SDPA's operands for q, k, v ``[B, T, H|Hkv, D]``: a list of (label,
    qh, kh, vh, keywords), each q / k / v ``[B, H, T, D]`` leaves that
    take a gradient. The first is the library's call on these inputs: k /
    v at Hkv heads with ``enable_gqa`` where this torch takes it, else
    repeated to every query head. Under GQA with ``enable_gqa``, a second
    repeats k / v to every query head (a copy outside the timed call, so
    that the backends without GQA run)."""
    group = q.shape[2] // k.shape[2]

    def leaves(kv_repeat):
        qh, kh, vh = (x.detach().transpose(1, 2) for x in (q, k, v))
        if kv_repeat > 1:
            kh, vh = (x.repeat_interleave(kv_repeat, 1) for x in (kh, vh))
        return tuple(x.requires_grad_() for x in (qh, kh, vh))

    if group == 1:
        return [(f"H={q.shape[2]}", *leaves(1), {})]
    repeated = ("GQA, K/V repeat_interleave'd", *leaves(group), {})
    qh, kh, vh = leaves(1)
    try:
        torch.nn.functional.scaled_dot_product_attention(
            qh[:, :, :1], kh[:, :, :1], vh[:, :, :1], enable_gqa=True)
    except TypeError:
        return [repeated]
    return [("GQA, enable_gqa", qh, kh, vh, {"enable_gqa": True}),
            repeated]


def time_in_turns(kern_fwd, kern_pair, yard, do):
    """K1 in turns with SDPA's forward (K1, SDPA, SDPA, K1) and the pair
    K2a + K2b in turns with SDPA's backward, on one yardstick of
    :func:`sdpa_yardsticks`: (label with the backend, forward turns,
    backward turns)."""
    from torch.nn.attention import sdpa_kernel

    label, qh, kh, vh, kw = yard
    sdpa = torch.nn.functional.scaled_dot_product_attention
    be = sdpa_backend(qh, kh, vh, is_causal=True, **kw)
    with sdpa_kernel([be]):
        def lib():
            return sdpa(qh, kh, vh, is_causal=True, **kw)
        turns = [cuda_ms(kern_fwd), cuda_ms(lib), cuda_ms(lib),
                 cuda_ms(kern_fwd)]
        out = sdpa(qh, kh, vh, is_causal=True, **kw)
        doh = do.transpose(1, 2)

        def lib_bwd():
            return torch.autograd.grad(out, (qh, kh, vh), doh,
                                       retain_graph=True)
        bturns = [cuda_ms(kern_pair), cuda_ms(lib_bwd), cuda_ms(lib_bwd),
                  cuda_ms(kern_pair)]
    return f"{be.name}, {label}", turns, bturns


def phase_flash_timing(fa, peaks, h=16, hkv=16, strided=True):
    """K1, K2a, K2b at a training path's shapes (GPT-3 1.3B: H=Hkv=16, q/k/v
    strided out of one fused projection as in the model; Llama-3-8B: H=32,
    Hkv=8, separate projections). K1 is timed in turns with SDPA's forward
    and the pair K2a + K2b in turns with SDPA's backward (dq + dk + dv),
    each averaged, on each of :func:`sdpa_yardsticks` (the first gives
    ``library_ms``; under GQA the repeated-K/V call gives
    ``library_repeat_ms``); K2a and K2b also alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    b, t, d = TRAIN_BATCH, TRAIN_SEQ, 128
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_inputs(gen, b, t, t, h, hkv, d, dt, strided)
        worst = {}
        compare_flash(fa, q, k, v, do, None, True, False, worst,
                      f"training shape H={h} Hkv={hkv} {str(dt)[6:]}")
        o, lse = fa.flash_attention_forward_cuda(q, k, v, causal=True)
        delta = fa._delta(o, do).contiguous()
        kw = dict(causal=True)
        calls = {
            "fwd": (lambda: fa.flash_attention_forward_cuda(q, k, v, **kw),
                    lambda: fa.flash_attention_forward_plain(q, k, v, **kw)),
            "dq": (lambda: fa.flash_attention_bwd_dq_cuda(
                       q, k, v, None, do, lse, delta, **kw),
                   lambda: fa.flash_attention_bwd_dq_plain(
                       q, k, v, None, do, lse, delta, **kw)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv_cuda(
                        q, k, v, None, do, lse, delta, **kw),
                    lambda: fa.flash_attention_bwd_dkv_plain(
                        q, k, v, None, do, lse, delta, **kw)),
        }

        def pair():
            calls["dq"][0]()
            calls["dkv"][0]()

        yards = [time_in_turns(calls["fwd"][0], pair, y, do)
                 for y in sdpa_yardsticks(q, k, v)]
        lib_label, turns, bturns = yards[0]
        lib_fwd = (turns[1] + turns[2]) / 2
        lib_bwd = (bturns[1] + bturns[2]) / 2
        pair_ms = (bturns[0] + bturns[3]) / 2
        for kind, (kern, plain) in calls.items():
            ms = ((turns[0] + turns[3]) / 2 if kind == "fwd"
                  else cuda_ms(kern))
            plain_ms = cuda_ms(plain, iters=5, warm=1)
            lib = lib_fwd if kind == "fwd" else lib_bwd
            rows[(kind, dt)] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib, max_abs_err=worst[kind],
                                    **flash_bound(kind, q, k, True, peaks))
            if kind != "fwd":
                rows[(kind, dt)]["pair_ms"] = pair_ms
            log(f"{kind:3s} {str(dt)[6:]:8s} B={b} T={t} H={h} Hkv={hkv} "
                f"D={d} causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                f" sdpa "
                f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
                f"[{lib_label}] {lib:.4f} ms"
                + (f" (turns K1 {turns[0]:.4f}, sdpa {turns[1]:.4f}, "
                   f"{turns[2]:.4f}, K1 {turns[3]:.4f})" if kind == "fwd"
                   else "")
                + f", {bound_text(rows[(kind, dt)], ms)}")
        pb = {k_: rows[("dq", dt)][k_] + rows[("dkv", dt)][k_]
              for k_ in ("bound_ms", "bound_fma_ms")}
        log(f"pair {str(dt)[6:]:8s} K2a + K2b {pair_ms:.4f} ms vs sdpa "
            f"backward [{lib_label}] {lib_bwd:.4f} ms = "
            f"{pair_ms / lib_bwd:.3f}x (turns pair {bturns[0]:.4f}, sdpa "
            f"{bturns[1]:.4f}, {bturns[2]:.4f}, pair {bturns[3]:.4f}); "
            f"bound {pb['bound_ms']:.4f} ms (tensor cores), "
            f"{pb['bound_fma_ms']:.4f} ms (f32 FMA), "
            f"{100 * pb['bound_ms'] / pair_ms:.1f} % of bound")
        for label, ft, bt in yards[1:]:
            rep_fwd, rep_bwd = (ft[1] + ft[2]) / 2, (bt[1] + bt[2]) / 2
            rows[("fwd", dt)]["library_repeat_ms"] = rep_fwd
            for kind in ("dq", "dkv"):
                rows[(kind, dt)]["library_repeat_ms"] = rep_bwd
            log(f"sdpa [{label}] {str(dt)[6:]}: forward {rep_fwd:.4f} ms "
                f"(turns K1 {ft[0]:.4f}, sdpa {ft[1]:.4f}, {ft[2]:.4f}, K1 "
                f"{ft[3]:.4f}), backward {rep_bwd:.4f} ms (turns pair "
                f"{bt[0]:.4f}, sdpa {bt[1]:.4f}, {bt[2]:.4f}, pair "
                f"{bt[3]:.4f})")
        del q, k, v, do, o, lse, delta, yards
        torch.cuda.empty_cache()
    return rows


# -- phases 7 and 8: training -------------------------------------------------


@contextlib.contextmanager
def plain_attention(fa):
    """The flash route with the kernels' plain versions standing in for the
    kernels: the reference run of phases 7 and 8."""
    names = ("forward", "bwd_dq", "bwd_dkv")
    saved = {n: getattr(fa, f"flash_attention_{n}_cuda") for n in names}
    try:
        for n in names:
            setattr(fa, f"flash_attention_{n}_cuda",
                    getattr(fa, f"flash_attention_{n}_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(fa, f"flash_attention_{n}_cuda", fn)


def train_batch(vocab):
    """Next-token batch [B, T] of ids and labels, made with numpy."""
    rng = np.random.default_rng(SEED + 4)
    tok = rng.integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))
    tok = torch.as_tensor(tok, device=DEVICE)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def trainer(model, adamw=ADAMW):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **adamw)
    return TrainStep(model, lambda m, ids, lab: m(ids, labels=lab), opt), opt


def phase_training(fa, smi, build, adamw, label, phase):
    """TRAIN_STEPS steps of ``TrainStep`` + ``AdamW`` on the model
    ``build()`` makes: the loss falls, each flash kernel launches once a
    layer a step, the first loss equals a no-grad forward on the plain
    attention."""
    t0 = time.perf_counter()
    model = build()
    step, opt = trainer(model, adamw)
    ids, labels = train_batch(model.config.vocab_size)
    with plain_attention(fa), torch.no_grad():
        plain_loss = float(model(ids, labels=labels))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"# phase {phase}: {label} ({n_params / 1e9:.3f} B parameters) "
        f"built and a no-grad plain-attention loss taken in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    layers = model.config.num_hidden_layers
    tokens = ids.numel()
    for i, (l, ms) in enumerate(zip(losses, step_ms)):
        log(f"step {i}: loss {l:.6f}, {ms:.1f} ms, "
            f"{tokens / ms * 1e3:.1f} tokens/s")
    log(f"steps 1-{TRAIN_STEPS - 1} mean {np.mean(step_ms[1:]):.1f} ms = "
        f"{tokens / np.mean(step_ms[1:]) * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} = {layers} layers x "
        f"{TRAIN_STEPS} steps  [{smi}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if any(n != layers * TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {layers} x "
                             f"{TRAIN_STEPS}")
    states = [t for st in opt._accumulators for t in st.values()]
    if not all(x.device.type == DEVICE
               for x in [*model.parameters(), *states]):
        raise AssertionError("a parameter or optimizer state is off the card")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"first loss kernel {losses[0]:.7f} vs plain attention "
        f"{plain_loss:.7f}: rel {rel:.2e} (rtol {TRAIN_LOSS_RTOL})")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("first loss differs from the plain attention")
    del step, opt, model
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, losses=losses,
                peak_bytes=peak, tokens=tokens)


def phase_train_lockstep(fa, build, adamw, label, phase):
    """A kernel trainer and a plain-attention trainer from the same
    weights, LOCKSTEP_STEPS steps each: per-step losses and final
    parameters compared."""
    a = build()
    b = build()
    b.load_state_dict(a.state_dict())
    step_a, _ = trainer(a, adamw)
    step_b, _ = trainer(b, adamw)
    ids, labels = train_batch(a.config.vocab_size)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        la = float(step_a(ids, labels))
        with plain_attention(fa):
            lb = float(step_b(ids, labels))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"# phase {phase}: {label} step {i}: loss kernel {la:.7f} "
            f"plain {lb:.7f} rel {rel:.2e}")
    bound = 2 * adamw["learning_rate"] * LOCKSTEP_STEPS
    far = total = 0
    dmax = 0.0
    pb = dict(b.named_parameters())
    for n, p in a.named_parameters():
        d = (p.detach() - pb[n].detach()).abs()
        dmax = max(dmax, d.max().item())
        far += int((d > LOCKSTEP_PARAM_ATOL).sum())
        total += d.numel()
    log(f"final params: max |kernel - plain| {dmax:.2e} (bound {bound:.1e}),"
        f" {far}/{total} beyond {LOCKSTEP_PARAM_ATOL}")
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"lockstep losses differ: rel {worst}")
    if not (dmax <= bound and far <= 0.01 * total):
        raise AssertionError("lockstep parameters differ")
    del step_a, step_b, a, b
    torch.cuda.empty_cache()


# -- phases 9-12: grouped matmul and MoE training -----------------------------

GMM_REPLACES = {
    "fwd": "paddle_tpu/ops/pallas/grouped_matmul.py:116",
    "drhs": "paddle_tpu/ops/pallas/grouped_matmul.py:164",
}

# (label, group sizes or a group count for a Dirichlet draw, M, K, N)
GMM_CASES = (
    ("aligned", [64, 64], 128, 32, 64),
    ("ragged", [50, 30, 48], 128, 32, 64),
    ("empty groups", [0, 100, 0, 28], 128, 32, 64),
    ("trailing empties", [128, 0, 0], 128, 32, 64),
    ("padding tail", [30, 40], 128, 32, 64),
    ("multi-tile group", [100, 156], 256, 32, 64),
    ("N=192", [40, 60, 28], 128, 32, 192),
    ("odd K", [50, 30, 48], 128, 33, 40),
    ("odd K and N", [300, 0, 211], 600, 45, 37),
    ("Mixtral top-2", MOE_EXPERTS, MOE_TOP_K * TRAIN_BATCH * TRAIN_SEQ,
     MOE_DIM, MOE_HIDDEN),
    # ~32 rows a group: most row tiles span several groups; G * K * N
    # passes 2^31, so the last groups' element offsets need 64 bits
    ("128 groups", 128, 4096, 2048, 8448),
)


def dirichlet_sizes(rng, m, g):
    """Imbalanced group sizes summing to m: the draw of
    scripts/bench_gmm_tpu.py (Dirichlet(2) proportions)."""
    props = rng.dirichlet(np.ones(g) * 2.0)
    sizes = np.floor(props * m).astype(np.int64)
    sizes[-1] += m - sizes.sum()
    return sizes


def gmm_inputs(gen, m, k, n, g, dtype):
    """lhs [m, k], rhs [g, k, n] (scaled by 1/sqrt(k)) and dout [m, n] on
    the card."""
    dev = DEVICE
    lhs = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    rhs = (torch.randn((g, k, n), generator=gen, device=dev)
           / np.sqrt(k)).to(dtype)
    dout = torch.randn((m, n), generator=gen, device=dev).to(dtype)
    return lhs, rhs, dout


def compare_gmm(gm, lhs, rhs, dout, sizes, worst, tag):
    """K4a on (lhs, rhs) and on (dout, rhs^T view), K4b on (lhs, dout),
    each vs its plain version. Padding rows and empty groups' drhs must be
    exactly zero. Updates worst[name] with (max|err|, relative) and raises
    past the tolerance."""
    tol = GMM_TOL[lhs.dtype]
    host = sizes.cpu().numpy()
    total = int(host.sum())
    empty = torch.as_tensor(np.flatnonzero(host == 0), device=DEVICE)
    rhs_t = rhs.transpose(1, 2)
    calls = (("out", gm.grouped_matmul_cuda, gm.grouped_matmul_plain,
              (lhs, rhs), tol),
             ("dlhs", gm.grouped_matmul_cuda, gm.grouped_matmul_plain,
              (dout, rhs_t), tol),
             ("drhs", gm.grouped_matmul_drhs_cuda,
              gm.grouped_matmul_drhs_plain, (lhs, dout),
              GMM_TOL[torch.float32]))
    line = []
    for name, kern, plain, args, t in calls:
        got = kern(*args, sizes)
        ref = plain(*args, sizes)
        torch.cuda.synchronize()
        if name == "drhs":
            if got[empty].any():
                raise AssertionError(f"{tag}: an empty group's drhs is not 0")
        elif got[total:].any():
            raise AssertionError(f"{tag}: a padding row of {name} is not 0")
        if not ref.abs().max().item() > 0:
            raise AssertionError(f"{tag}: {name} is all zero")
        err, rel = _rel(got, ref)
        prev = worst.get(name, (0.0, 0.0))
        worst[name] = (max(prev[0], err), max(prev[1], rel))
        line.append(f"{name} {rel:.1e}")
        if not rel <= t:
            raise AssertionError(f"{tag}: {name} differs from plain: {rel} "
                                 f"> {t} (max|err| {err})")
        del got, ref
    log(f"{tag}: rel err " + ", ".join(line))


def phase_gmm_sweep(gm):
    """Returns the worst (max|err|, relative) per output over the f32
    cases."""
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    worst, worst_bf16 = {}, {}
    log("# phase 9: grouped matmul K4a / K4b vs plain (tolerance "
        f"max|err|/max|ref|: f32 {GMM_TOL[torch.float32]}, bf16 out / dlhs "
        f"{GMM_TOL[torch.bfloat16]:.2e}, drhs f32 in both)")
    for label, sizes, m, k, n in GMM_CASES:
        if isinstance(sizes, int):
            sizes = dirichlet_sizes(rng, m, sizes)
        st = torch.as_tensor(np.asarray(sizes), dtype=torch.int32,
                             device=DEVICE)
        for dt in (torch.float32, torch.bfloat16):
            lhs, rhs, dout = gmm_inputs(gen, m, k, n, len(sizes), dt)
            compare_gmm(gm, lhs, rhs, dout, st,
                        worst if dt == torch.float32 else worst_bf16,
                        f"{label:16s} M={m:4d} K={k:4d} N={n:5d} "
                        f"G={len(sizes):3d} {str(dt)[6:]:8s}")
            del lhs, rhs, dout
            torch.cuda.empty_cache()
    log(f"worst (max|err|, rel) f32 {worst}, bf16 {worst_bf16}")
    return worst


def gmm_bound(kind, lhs, other, host_sizes, peaks):
    """:func:`bounds` of one call: the routed rows of lhs (and of dout)
    read once, the weights of non-empty groups read (fwd) or written in
    f32 (drhs) once, the output written once; 2 FLOPs per routed row x K
    x N of the inputs' type."""
    rows = int(host_sizes.sum())
    live = int((host_sizes > 0).sum())
    m, k = lhs.shape
    elt = lhs.element_size()
    if kind == "fwd":
        n = other.shape[2]
        nbytes = rows * k * elt + live * k * n * elt + m * n * elt
    else:
        n = other.shape[1]
        nbytes = rows * (k + n) * elt + live * k * n * 4
    nbytes += 4 * len(host_sizes)
    return bounds(nbytes, 2 * rows * k * n,
                  "f32" if lhs.dtype == torch.float32 else "bf16", peaks)


def grouped_library(kind, lhs, other, host_sizes, ends):
    """(call, label): ``torch._grouped_mm`` on these inputs where this
    torch has it and takes them, else a per-expert ``torch.mm`` loop."""
    spans = np.concatenate([[0], np.cumsum(host_sizes)])
    if kind == "fwd":
        def grouped():
            return torch._grouped_mm(lhs, other, offs=ends)
        out = torch.empty((lhs.shape[0], other.shape[2]), dtype=lhs.dtype,
                          device=DEVICE)

        def loop():
            for g in range(len(host_sizes)):
                s, e = int(spans[g]), int(spans[g + 1])
                torch.mm(lhs[s:e], other[g], out=out[s:e])
            return out
    else:
        def grouped():
            return torch._grouped_mm(lhs.T, other, offs=ends)
        out = torch.empty((len(host_sizes), lhs.shape[1], other.shape[1]),
                          dtype=lhs.dtype, device=DEVICE)

        def loop():
            for g in range(len(host_sizes)):
                s, e = int(spans[g]), int(spans[g + 1])
                torch.mm(lhs[s:e].T, other[s:e], out=out[g])
            return out
    try:
        grouped()
        torch.cuda.synchronize()
        return grouped, "torch._grouped_mm"
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        log(f"torch._grouped_mm refused {kind} {str(lhs.dtype)[6:]}: "
            f"{str(exc).splitlines()[0][:120]}")
        return loop, "per-expert torch.mm loop"


def moe_gmm_inputs():
    """The group sizes (device tensor, host array), their inclusive ends
    and the f32 operands of one MoE training step's grouped matmuls at the
    Mixtral widths, made from the seed."""
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    m, d, f, e = (MOE_TOP_K * TRAIN_BATCH * TRAIN_SEQ, MOE_DIM, MOE_HIDDEN,
                  MOE_EXPERTS)
    host = dirichlet_sizes(rng, m, e)
    sizes = torch.as_tensor(host, dtype=torch.int32, device=DEVICE)
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    ops = dict(x=rand(m, d), a=rand(m, f), w_in=rand(e, d, f, scale=d ** -0.5),
               w_out=rand(e, f, d, scale=f ** -0.5), dh=rand(m, f),
               dy=rand(m, d))
    return sizes, host, ends, ops


def moe_gmm_calls(t):
    """(name, kind, lhs, other) of the step's five grouped matmuls on the
    operands t: both forward products, the down projection's dlhs on the
    rhs^T view, both weight gradients."""
    return (("up fwd", "fwd", t["x"], t["w_in"]),
            ("down fwd", "fwd", t["a"], t["w_out"]),
            ("down dlhs", "fwd", t["dy"], t["w_out"].transpose(1, 2)),
            ("up drhs", "drhs", t["x"], t["dh"]),
            ("down drhs", "drhs", t["a"], t["dy"]))


def phase_gmm_timing(gm, peaks):
    """The five grouped matmuls of one MoE training step at the Mixtral
    widths, in f32 (the training path's dtype) and in bf16 (names with a
    ``bf16`` suffix)."""
    sizes, host, ends, ops = moe_gmm_inputs()
    log(f"# phase 10: grouped matmuls of one MoE step, M={len(ops['x'])} "
        f"routed rows, dim {MOE_DIM}, hidden {MOE_HIDDEN}, {MOE_EXPERTS} "
        f"experts, sizes {host.tolist()}")
    rows = {}
    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        t = {k: v.to(dt) for k, v in ops.items()}
        for name, kind, lhs, other in moe_gmm_calls(t):
            rows[name + suffix] = time_gmm_call(
                gm, peaks, name + suffix, kind, lhs, other, sizes, host,
                ends)
        del t, lhs, other
        torch.cuda.empty_cache()
    del ops
    torch.cuda.empty_cache()
    return rows


def time_gmm_call(gm, peaks, name, kind, lhs, other, sizes, host, ends):
    """One call checked against its plain version, then timed beside it,
    a dense ``torch.matmul`` of the same FLOPs and the grouped library
    call; returns its row (the ``kernels`` line's fields)."""
    kern = (gm.grouped_matmul_cuda if kind == "fwd"
            else gm.grouped_matmul_drhs_cuda)
    plain = (gm.grouped_matmul_plain if kind == "fwd"
             else gm.grouped_matmul_drhs_plain)
    got, ref = kern(lhs, other, sizes), plain(lhs, other, sizes)
    torch.cuda.synchronize()
    err, rel = _rel(got, ref)
    del got, ref
    tol = GMM_TOL[lhs.dtype if kind == "fwd" else torch.float32]
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel disagrees, rel {rel}")
    ms = cuda_ms(lambda: kern(lhs, other, sizes), iters=10, warm=2)
    plain_ms = cuda_ms(lambda: plain(lhs, other, sizes), iters=3, warm=1)
    if kind == "fwd":
        dense_ms = cuda_ms(lambda: torch.matmul(lhs, other[0]), iters=10,
                           warm=2)
    else:
        dense_ms = cuda_ms(lambda: torch.matmul(lhs.T, other), iters=10,
                           warm=2)
    lib, lib_label = grouped_library(kind, lhs, other, host, ends)
    lib_ms = cuda_ms(lib, iters=5, warm=1)
    row = dict(
        ms=ms, plain_ms=plain_ms, dense_ms=dense_ms, max_abs_err=err,
        library_ms=lib_ms if lib_label == "torch._grouped_mm" else None,
        **gmm_bound(kind, lhs, other, host, peaks))
    log(f"{name:16s} [{lhs.shape[0]}x{lhs.shape[1]}] {kind:4s}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, dense torch.matmul "
        f"{dense_ms:.4f} ms, {lib_label} {lib_ms:.4f} ms, "
        f"{bound_text(row, ms)}, rel err {rel:.1e}")
    return row


@contextlib.contextmanager
def plain_grouped_matmul(gm):
    """The grouped matmul's plain versions standing in for K4a / K4b: the
    reference run of phases 11 and 12."""
    saved = (gm.grouped_matmul_cuda, gm.grouped_matmul_drhs_cuda)
    try:
        gm.grouped_matmul_cuda = gm.grouped_matmul_plain
        gm.grouped_matmul_drhs_cuda = gm.grouped_matmul_drhs_plain
        yield
    finally:
        gm.grouped_matmul_cuda, gm.grouped_matmul_drhs_cuda = saved


def build_moe(dim, hidden):
    """MoE -> Linear(dim, 1): the composition the JAX package trains its
    dropless MoE in (tests/test_grouped_matmul.py::test_dropless_moe_trains),
    weights from a seeded generator on the card."""
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.initializer import XavierNormal

    class MoERegressor(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            self.moe = MoELayer(dim, hidden, MOE_EXPERTS, top_k=MOE_TOP_K,
                                drop_tokens=False, device=DEVICE,
                                generator=gen)
            self.head = Linear(dim, 1, device=DEVICE, generator=gen,
                               weight_init=XavierNormal())

        def forward(self, x):
            return self.head(self.moe(x))

    return MoERegressor()


def moe_loss(model, x, y):
    from paddle_tpu_torch.nn.functional import mse_loss

    return mse_loss(model(x), y) + model.moe.last_aux_loss


def moe_batch(dim):
    """x [B, T, dim] and regression targets y [B, T, 1], made with numpy."""
    rng = np.random.default_rng(SEED + 7)
    x = rng.standard_normal((TRAIN_BATCH, TRAIN_SEQ, dim), np.float32)
    y = rng.standard_normal((TRAIN_BATCH, TRAIN_SEQ, 1), np.float32)
    return torch.as_tensor(x, device=DEVICE), torch.as_tensor(y, device=DEVICE)


def moe_trainer(model):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **MOE_ADAMW)
    return TrainStep(model, moe_loss, opt), opt


def phase_moe_training(gm, smi):
    t0 = time.perf_counter()
    model = build_moe(MOE_DIM, MOE_HIDDEN)
    step, opt = moe_trainer(model)
    x, y = moe_batch(MOE_DIM)
    with plain_grouped_matmul(gm), torch.no_grad():
        plain_loss = float(moe_loss(model, x, y))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"# phase 11: MoE (Mixtral 8x7B block: dim {MOE_DIM}, hidden "
        f"{MOE_HIDDEN}, {MOE_EXPERTS} experts, top-{MOE_TOP_K}; "
        f"{n_params / 1e9:.3f} B parameters) built and a no-grad plain loss "
        f"taken in {time.perf_counter() - t0:.2f} s (set-up)")
    torch.cuda.reset_peak_memory_stats()
    gm.launches_fwd = gm.launches_drhs = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = {"fwd": gm.launches_fwd, "drhs": gm.launches_drhs}
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (l, ms) in enumerate(zip(losses, step_ms)):
        log(f"step {i}: loss {l:.7f}, {ms:.1f} ms, "
            f"{tokens / ms * 1e3:.1f} tokens/s")
    log(f"steps 1-{TRAIN_STEPS - 1} mean {np.mean(step_ms[1:]):.1f} ms = "
        f"{tokens / np.mean(step_ms[1:]) * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} = (3, 2) x "
        f"{TRAIN_STEPS} steps  [{smi}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # per step: K4a for both forward products and the down projection's
    # dlhs (the input x needs no gradient, so the up projection's dlhs is
    # skipped); K4b for both weight gradients
    if launches != {"fwd": 3 * TRAIN_STEPS, "drhs": 2 * TRAIN_STEPS}:
        raise AssertionError(f"grouped matmul launches {launches} != "
                             f"(3, 2) x {TRAIN_STEPS}")
    states = [t for st in opt._accumulators for t in st.values()]
    if not all(t.device.type == DEVICE
               for t in [*model.parameters(), *states]):
        raise AssertionError("a parameter or optimizer state is off the card")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"first loss kernel {losses[0]:.7f} vs plain grouped matmul "
        f"{plain_loss:.7f}: rel {rel:.2e} (rtol {MOE_LOSS_RTOL})")
    if not rel <= MOE_LOSS_RTOL:
        raise AssertionError("first loss differs from the plain grouped "
                             "matmul")
    del step, opt, model, x, y
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, losses=losses,
                peak_bytes=peak, tokens=tokens)


def routed(model, x):
    """[tokens, k] experts the model's gate picks for x."""
    with torch.no_grad():
        logits = model.moe.gate(x.reshape(-1, x.shape[-1]))
        return torch.topk(torch.softmax(logits.float(), -1), MOE_TOP_K).indices


def phase_moe_lockstep(gm):
    dim, hidden = MOE_LOCKSTEP_DIMS
    a, b = build_moe(dim, hidden), build_moe(dim, hidden)
    b.load_state_dict(a.state_dict())
    x, y = moe_batch(dim)
    params_a, params_b = list(a.parameters()), list(b.parameters())
    ga = torch.autograd.grad(moe_loss(a, x, y), params_a)
    with plain_grouped_matmul(gm):
        gb = torch.autograd.grad(moe_loss(b, x, y), params_b)
    worst_grad = 0.0
    for (n, _), u, v in zip(a.named_parameters(), ga, gb):
        _, rel = _rel(u, v)
        worst_grad = max(worst_grad, rel)
        if not rel <= MOE_GRAD_RTOL:
            raise AssertionError(f"step-1 gradient of {n} differs: rel {rel}")
    log(f"# phase 12: MoE dim {dim} hidden {hidden}: step-1 gradients of "
        f"all {len(ga)} parameters within rel {worst_grad:.2e} (rtol "
        f"{MOE_GRAD_RTOL})")
    del ga, gb
    step_a, _ = moe_trainer(a)
    step_b, _ = moe_trainer(b)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        alike = (routed(a, x) == routed(b, x)).float().mean().item()
        la = float(step_a(x, y))
        with plain_grouped_matmul(gm):
            lb = float(step_b(x, y))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"step {i}: loss kernel {la:.7f} plain {lb:.7f} rel {rel:.2e}; "
            f"token slots routed alike {100 * alike:.3f} %")
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"lockstep losses differ: rel {worst}")


# -- phases 18-22: mixed precision ---------------------------------------------


def reset_flash(fa):
    """Zero the flash kernels' launch counts, all and bf16."""
    for kind in ("fwd", "dq", "dkv"):
        setattr(fa, f"launches_{kind}", 0)
        setattr(fa, f"launches_{kind}_bf16", 0)


def flash_counts(fa):
    return {f"{kind}{tag}": getattr(fa, f"launches_{kind}{tag}")
            for tag in ("", "_bf16") for kind in ("fwd", "dq", "dkv")}


def amp_loss(level):
    """``TrainStep``'s loss under ``auto_cast(level)``."""
    from paddle_tpu_torch.amp import auto_cast

    def loss_fn(model, ids, labels):
        with auto_cast(level=level):
            return model(ids, labels=labels)

    return loss_fn


def lr_schedule(peak):
    """Linear warmup from 10 % of ``peak``, then cosine decay to 10 %."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(
        lr.CosineAnnealingDecay(peak, T_max=COSINE_STEPS,
                                eta_min=peak / 10),
        warmup_steps=WARMUP_STEPS, start_lr=peak / 10, end_lr=peak)


def amp_trainer(model, adamw, level, schedule, decorate=False):
    """``TrainStep`` + ``AdamW`` (+ clip) under ``auto_cast(level)``, the
    learning rate from :func:`lr_schedule` when ``schedule``; O2 first
    ``decorate``s the model and the optimizer. Returns (step, optimizer,
    scheduler or None)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    sched = lr_schedule(adamw["learning_rate"]) if schedule else None
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                **dict(adamw, learning_rate=sched or adamw["learning_rate"]))
    if decorate:
        amp.decorate(model, opt, level="O2")
    return TrainStep(model, amp_loss(level), opt), opt, sched


def check_bf16_launches(launches, fwd_per_step, bwd_per_step, what):
    """Every flash launch of the run was bf16, and as many as the layers
    and steps give."""
    want = {"fwd": fwd_per_step, "dq": bwd_per_step, "dkv": bwd_per_step}
    for kind, n in want.items():
        if not launches[kind] == launches[f"{kind}_bf16"] == n:
            raise AssertionError(f"{what}: flash launches {launches}, want "
                                 f"{n} bf16 {kind}")


def run_steps(step, sched, ids, labels, fa):
    """TRAIN_STEPS steps from a reset peak and zeroed counts: losses, step
    ms, peak bytes and flash launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        if sched is not None:
            sched.step()
    return dict(losses=losses, step_ms=step_ms,
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=flash_counts(fa), tokens=ids.numel())


def report_steps(r, smi, f32=None):
    """Log a run's steps, beside the f32 run's where given."""
    for i, (l, ms) in enumerate(zip(r["losses"], r["step_ms"])):
        log(f"step {i}: loss {l:.6f}, {ms:.1f} ms, "
            f"{r['tokens'] / ms * 1e3:.1f} tokens/s")
    ms = float(np.mean(r["step_ms"][1:]))
    r["mean_ms"] = ms
    r["tokens_per_s"] = r["tokens"] / ms * 1e3
    r["peak_gib"] = r["peak_bytes"] / 2 ** 30
    line = (f"steps 1-{TRAIN_STEPS - 1} mean {ms:.1f} ms = "
            f"{r['tokens_per_s']:.1f} tokens/s; peak memory "
            f"{r['peak_gib']:.2f} GiB; launches {r['launches']}")
    if f32 is not None:
        f32_ms = float(np.mean(f32["step_ms"][1:]))
        line += (f"; f32 (same weights) {f32_ms:.1f} ms = "
                 f"{f32['tokens'] / f32_ms * 1e3:.1f} tokens/s, "
                 f"{f32['peak_bytes'] / 2 ** 30:.2f} GiB: "
                 f"{f32_ms / ms:.2f}x")
    log(f"{line}  [{smi}]")
    if not all(np.isfinite(r["losses"])):
        raise AssertionError(f"non-finite loss {r['losses']}")
    if not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"loss did not fall: {r['losses']}")


def check_first_loss(r, f32, what):
    rel = abs(r["losses"][0] - f32["losses"][0]) / abs(f32["losses"][0])
    log(f"first loss bf16 {r['losses'][0]:.7f} vs f32 "
        f"{f32['losses'][0]:.7f}: rel {rel:.2e} (rtol {AMP_LOSS_RTOL:.2e})")
    if not rel <= AMP_LOSS_RTOL:
        raise AssertionError(f"{what}: first bf16 loss differs from f32")
    r["first_loss_rel"] = rel


def phase_amp_training(fa, smi, build, adamw, label, phase, level, f32,
                       schedule, decorate=False):
    """TRAIN_STEPS steps under ``auto_cast(level)``: the loss falls, K1 /
    K2a / K2b launch in bf16 once a layer a step; at O1 the first loss is
    within AMP_LOSS_RTOL of the f32 run's (``f32``, same weights and
    batch); at O2 every parameter is bf16 and every moment f32."""
    t0 = time.perf_counter()
    model = build()
    step, opt, sched = amp_trainer(model, adamw, level, schedule, decorate)
    ids, labels = train_batch(model.config.vocab_size)
    log(f"# phase {phase}: {label}, {level}"
        f"{' decorated' if decorate else ''}, lr "
        f"{'warmup + cosine' if schedule else 'held'}: built in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    r = run_steps(step, sched, ids, labels, fa)
    report_steps(r, smi, f32)
    layers = model.config.num_hidden_layers
    check_bf16_launches(r["launches"], layers * TRAIN_STEPS,
                        layers * TRAIN_STEPS, label)
    if level == "O1":
        check_first_loss(r, f32, label)
    if decorate:
        params = {p.dtype for p in model.parameters()}
        moments = {v.dtype for st in opt._accumulators
                   for k, v in st.items() if k.startswith("moment")}
        masters = {m.dtype for m in opt._master.values()}
        log(f"parameters {params}, moments {moments}, {len(opt._master)} "
            f"masters {masters}")
        if params != {torch.bfloat16} or moments != {torch.float32}:
            raise AssertionError("O2: parameters must stay bf16 and "
                                 "moments f32")
        if masters != {torch.float32} or \
                len(opt._master) != len(opt._parameter_list):
            raise AssertionError("O2: every bf16 parameter needs its f32 "
                                 "master")
    if sched is not None:
        log(f"lr now {opt.get_lr():.4e} after {TRAIN_STEPS} steps")
    del step, opt, model
    torch.cuda.empty_cache()
    return r


def o1_grads(model, ids, labels):
    """Loss and gradients (on the host) of one O1 forward and backward,
    and the peak memory they took on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = amp_loss("O1")(model, ids, labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return loss.detach().cpu(), [g.cpu() for g in grads], peak


def phase_recompute(fa, smi, o1, phase):
    """GPT-3 1.3B at O1 with ``use_recompute`` (granularity "full"): the
    step-1 loss and every gradient bit-equal to the run without, K1 twice
    a layer a step and K2a / K2b once, and the training step's peak memory
    below phase 18's (``o1``: the same model, batch and optimizer without
    recompute). The forward + backward's peaks on fresh models, with and
    without, are reported beside it."""
    build = lambda rc: build_model(24, use_recompute=rc)  # noqa: E731
    model = build(False)
    ids, labels = train_batch(model.config.vocab_size)
    want_loss, want, peak_without = o1_grads(model, ids, labels)
    del model
    torch.cuda.empty_cache()
    model = build(True)
    reset_flash(fa)
    loss, got, peak_with = o1_grads(model, ids, labels)
    one = flash_counts(fa)
    layers = model.config.num_hidden_layers
    check_bf16_launches(one, 2 * layers, layers, "recompute, one step")
    unequal = [n for (n, _), u, v in zip(model.named_parameters(), got, want)
               if not torch.equal(u, v)]
    log(f"# phase {phase}: GPT-3 1.3B O1, use_recompute (full): step-1 "
        f"loss {float(loss):.7f} vs {float(want_loss):.7f} without; "
        f"{len(got) - len(unequal)}/{len(got)} gradients bit-equal; "
        f"launches {one}; forward + backward peak memory "
        f"{peak_with / 2 ** 30:.2f} GiB with recompute, "
        f"{peak_without / 2 ** 30:.2f} GiB without  [{smi}]")
    if not torch.equal(loss, want_loss) or unequal:
        raise AssertionError(f"recompute changed the loss or gradients: "
                             f"{unequal[:5]}")
    del got, want
    step, opt, sched = amp_trainer(model, ADAMW, "O1", schedule=True)
    r = run_steps(step, sched, ids, labels, fa)
    report_steps(r, smi, None)
    check_bf16_launches(r["launches"], 2 * layers * TRAIN_STEPS,
                        layers * TRAIN_STEPS, "recompute")
    log(f"training step peak memory with recompute {r['peak_gib']:.2f} GiB,"
        f" without {o1['peak_gib']:.2f} GiB (phase 18)")
    if not r["peak_bytes"] < o1["peak_bytes"]:
        raise AssertionError("recompute did not lower the training step's "
                             "peak memory")
    r["fwd_bwd_peak_gib"] = peak_with / 2 ** 30
    r["fwd_bwd_peak_gib_without"] = peak_without / 2 ** 30
    del step, opt, model
    torch.cuda.empty_cache()
    return r


def phase_amp_lockstep(fa, build, adamw, label, phase):
    """A kernel trainer and a plain-attention trainer under O1 from the
    same weights: step-1 gradients, then LOCKSTEP_STEPS losses."""
    a, b = build(), build()
    b.load_state_dict(a.state_dict())
    ids, labels = train_batch(a.config.vocab_size)
    loss_fn = amp_loss("O1")
    ga = torch.autograd.grad(loss_fn(a, ids, labels), list(a.parameters()))
    with plain_attention(fa):
        gb = torch.autograd.grad(loss_fn(b, ids, labels),
                                 list(b.parameters()))
    worst_grad, worst_name = 0.0, None
    for (n, _), u, v in zip(a.named_parameters(), ga, gb):
        _, rel = _rel(u, v)
        if rel > worst_grad:
            worst_grad, worst_name = rel, n
    log(f"# phase {phase}: {label}, O1: step-1 gradients of all {len(ga)} "
        f"parameters within rel {worst_grad:.2e} ({worst_name}; rtol "
        f"{AMP_GRAD_RTOL:.2e})")
    if not worst_grad <= AMP_GRAD_RTOL:
        raise AssertionError(f"O1 lockstep gradient of {worst_name} "
                             f"differs: rel {worst_grad}")
    del ga, gb
    step_a, _, _ = amp_trainer(a, adamw, "O1", schedule=False)
    step_b, _, _ = amp_trainer(b, adamw, "O1", schedule=False)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        la = float(step_a(ids, labels))
        with plain_attention(fa):
            lb = float(step_b(ids, labels))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"step {i}: loss kernel {la:.7f} plain {lb:.7f} rel {rel:.2e}")
    if not worst <= AMP_LOCKSTEP_LOSS_RTOL:
        raise AssertionError(f"O1 lockstep losses differ: rel {worst}")
    del step_a, step_b, a, b
    torch.cuda.empty_cache()


def phases_amp(fa, smi, gpt_f32, llama_f32):
    """Phases 18-22; returns their numbers for the ``amp`` JSON line."""
    o1 = phase_amp_training(fa, smi, lambda: build_model(24), ADAMW,
                            "GPT-3 1.3B", 18, "O1", gpt_f32, schedule=True)
    o2 = phase_amp_training(fa, smi, lambda: build_model(24), ADAMW,
                            "GPT-3 1.3B", 19, "O2", gpt_f32, schedule=True,
                            decorate=True)
    rc = phase_recompute(fa, smi, o1, 20)
    llama = phase_amp_training(
        fa, smi, lambda: build_llama(LLAMA_TRAIN_LAYERS), LLAMA_ADAMW,
        f"Llama-3-8B widths at depth {LLAMA_TRAIN_LAYERS}", 21, "O1",
        llama_f32, schedule=False)
    phase_amp_lockstep(fa, lambda: build_model(2), ADAMW,
                       "GPT-3 1.3B depth 2", 22)
    keys = ("mean_ms", "tokens_per_s", "peak_gib", "launches", "losses")
    out = {name: {k: r[k] for k in keys}
           for name, r in (("gpt_o1", o1), ("gpt_o2", o2),
                           ("gpt_o1_recompute", rc), ("llama_o1", llama))}
    for name, r in (("gpt_o1", o1), ("llama_o1", llama)):
        out[name]["first_loss_rel_f32"] = r["first_loss_rel"]
    for k in ("fwd_bwd_peak_gib", "fwd_bwd_peak_gib_without"):
        out["gpt_o1_recompute"][k] = rc[k]
    out["card"] = smi
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"capability {cap} count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability 9.0, got {cap}")
    peaks = card_peaks(name)
    log(f"bounds use the H100 {peaks['form']} peaks: {peaks['bw'] / 1e12} "
        f"TB/s HBM, {peaks['f32'] / 1e12} TFLOP/s f32 FMA, "
        f"{peaks['tf32'] / 1e12} TF32 and {peaks['bf16'] / 1e12} bf16 "
        "TFLOP/s on tensor cores")

    t0 = time.perf_counter()
    build.library()
    log(f"# phase 2: kernels built in {time.perf_counter() - t0:.2f} s "
        "(set-up)")

    sweep_err = phase_kernel_sweep(pa)
    flash_err = phase_flash_sweep(fa)
    served = phase_serving(pa, fa, smi, lambda: build_model(24),
                           "GPT-3 1.3B", 4)
    timed = time_main_shapes(pa, peaks, served["contexts"])
    phase_engine_parity(lambda: build_model(2), "GPT-3 1.3B depth 2", 5)
    flash_timed = phase_flash_timing(fa, peaks)
    trained = phase_training(fa, smi, lambda: build_model(24), ADAMW,
                             "GPT-3 1.3B", 7)
    phase_train_lockstep(fa, lambda: build_model(2), ADAMW,
                         "GPT-3 1.3B depth 2", 8)
    gmm_err = phase_gmm_sweep(gm)
    gmm_timed = phase_gmm_timing(gm, peaks)
    moe_trained = phase_moe_training(gm, smi)
    phase_moe_lockstep(gm)

    torch.cuda.empty_cache()
    g = LLAMA3_8B["num_attention_heads"] // LLAMA3_8B["num_key_value_heads"]
    llama_served = phase_serving(
        pa, fa, smi, lambda: build_llama(LLAMA3_8B["num_hidden_layers"]),
        f"Llama-3-8B ({LLAMA3_8B['num_hidden_layers']} layers, G={g})", 13,
        gate_kv="f32")
    phase_engine_parity(lambda: build_llama(2), "Llama-3-8B depth 2", 14)
    log("# phase 15: K1 / K2 and K3 at the Llama-3-8B shapes")
    llama_flash = phase_flash_timing(
        fa, peaks, h=LLAMA3_8B["num_attention_heads"],
        hkv=LLAMA3_8B["num_key_value_heads"], strided=False)
    llama_k3 = time_main_shapes(pa, peaks, llama_served["contexts"],
                                hkv=LLAMA3_8B["num_key_value_heads"],
                                group=g)
    llama_trained = phase_training(
        fa, smi, lambda: build_llama(LLAMA_TRAIN_LAYERS), LLAMA_ADAMW,
        f"Llama-3-8B widths at depth {LLAMA_TRAIN_LAYERS}", 16)
    phase_train_lockstep(fa, lambda: build_llama(2), LLAMA_ADAMW,
                         "Llama-3-8B widths at depth 2", 17)
    step_ms = np.mean(llama_trained["step_ms"][1:])
    amp_runs = phases_amp(fa, smi, trained, llama_trained)
    log(json.dumps({"llama3_8b": {
        "card": smi,
        "serving": {k: llama_served[k] for k in ("tokens_per_s", "decode_ms",
                                                 "prefill_ms", "launches")},
        "training": {"layers": LLAMA_TRAIN_LAYERS, "step_ms": step_ms,
                     "tokens_per_s": llama_trained["tokens"] / step_ms * 1e3,
                     "peak_gib": llama_trained["peak_bytes"] / 2 ** 30,
                     "launches": llama_trained["launches"]},
        "flash": {f"{kind} {str(dt)[6:]}": {
            k: r[k] for k in ("ms", "plain_ms", "library_ms",
                              "library_repeat_ms", "pair_ms", "bound_ms",
                              "bound_fma_ms") if k in r}
            for (kind, dt), r in llama_flash.items()},
        "paged": {shape: {k: r[k] for k in (
            "regime", "ms", "plain_ms", "library_ms", "loop_ms", "bound_ms",
            "bound_fma_ms")} for shape, r in llama_k3.items()},
    }}))

    def row(name, source, replaces, launches, err, r, timed_as="host loop"):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "bound_fma_ms": r["bound_fma_ms"],
               "library_ms": r["library_ms"], "timed_as": timed_as}
        if timed_as == "cuda graph":
            out.update({k: r[k] for k in ("loop_ms", "library_loop_ms",
                                          "plain_loop_ms")})
        if "pair_ms" in r:  # K2a + K2b, timed in turns with SDPA backward
            out["pair_ms"] = r["pair_ms"]
        return out

    kernels = [
        row(f"paged_attention_{shape}",
            "paddle_tpu_torch/ops/cuda/paged_attention.cu",
            "paddle_tpu/ops/pallas/paged_attention.py:81",
            served["launches"][{"decode": "decode", "verify": "verify",
                                "prefill": "tile"}[shape]],
            max(sweep_err[timed[shape]["regime"]],
                timed[shape]["max_abs_err"]), timed[shape], "cuda graph")
        for shape in ("decode", "verify", "prefill")]
    for kind, kernel in (("fwd", "flash_attention_fwd"),
                         ("dq", "flash_attention_bwd_dq"),
                         ("dkv", "flash_attention_bwd_dkv")):
        r = flash_timed[(kind, torch.float32)]
        kernels.append(row(
            kernel, "paddle_tpu_torch/ops/cuda/flash_attention.cu",
            FLASH_REPLACES[kind], trained["launches"][kind],
            max(flash_err[kind], r["max_abs_err"]), r))
    for kind, kernel, call, outs in (
            ("fwd", "grouped_matmul_fwd", "up fwd", ("out", "dlhs")),
            ("drhs", "grouped_matmul_drhs", "up drhs", ("drhs",))):
        r = gmm_timed[call]
        kernels.append(row(
            kernel, "paddle_tpu_torch/ops/cuda/grouped_matmul.cu",
            GMM_REPLACES[kind], moe_trained["launches"][kind],
            max(r["max_abs_err"], *(gmm_err[o][0] for o in outs)), r))
    log(json.dumps({"amp": amp_runs}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
