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
23. ERNIE-3.0-base (12 layers, hidden 768, vocab 40000, dropouts 0.1;
   random weights from a seed) fine-tuned as a sentence-pair classifier
   through ``paddle.Model``: ``fit`` over an ``io.DataLoader`` (batch 32,
   max_seq_length 128, real lengths 16-128, shuffled, 2 worker processes)
   with AdamW under a warmup + linear decay schedule for 32 steps, then
   ``evaluate`` and ``predict`` over 8 batches: the loss falls (mean of the
   last 4 steps below the first 4), fit launches no flash kernel
   (attention dropout 0.1 takes the dense route, as in the reference),
   evaluate launches K1 12 x 8 times, each non-causal with the [32, 1, 1,
   128] padding bias, accuracy in [0, 1], and evaluate's logits match the
   plain attention's on the same weights;
24. ERNIE at depth 2 with dropouts 0, a kernel model and a plain-attention
   model in lockstep through ``Model.train_batch`` for 3 steps: the losses
   agree, K1 / K2a / K2b run 2 x 3 times each, non-causal, with the
   padding bias and no dS;
25. BERT-base masked-LM pretraining (Devlin et al. 2019 widths, attention
   dropout 0, hidden dropout 0.1) at 8 x 512 (real lengths 128-512, 15 %
   of the real tokens labelled) through ``TrainStep`` + AdamW for 4 steps
   in f32 and 4 under ``auto_cast`` O1: the loss falls, 12 x 4 launches of
   each kernel with the padding bias (bf16 under O1), the first O1 loss
   within ``AMP_LOSS_RTOL`` of the f32 one;
26. K1, K2a + K2b at the encoders' shapes (ERNIE B=32 T=128, BERT B=8
   T=512; H=12, D=64, non-causal, padding bias; f32 and bf16), each
   checked against its plain version and timed beside it, SDPA under the
   same additive mask and the bound;
27. ResNet-50 (He et al. 2016, Table 1: 1000 classes; 224 x 224, batch
   256, random weights from the seed) trained in f32 through
   ``TrainStep`` + ``Momentum(0.1, 0.9, weight decay 1e-4)`` (the repo's
   benchmark recipe, its rate ramped linearly from 0.01 over the 12
   steps) on one fixed batch: step ms (steps 3
   on), images/s against the f32 bound, peak memory, the device's idle
   share (kernel time over two profiled steps against the step); the loss
   falls, every BN buffer is finite and has moved;
28. the same under ``auto_cast`` O1 and after ``decorate(level="O2")``
   with ``multi_precision``: a spy on ``torch.nn.functional.conv2d`` /
   ``batch_norm`` sees 53 convs in bf16 and 53 batch norms in f32 a step,
   the first O1 loss is within ``AMP_LOSS_RTOL`` of phase 27's, the
   losses fall; images/s against the bf16 bound;
29. ResNet-50 through ``paddle.Model``: ``fit`` 8 steps over ``FakeData``
   (256 x 256 images) through ``RandomResizedCrop(224)``,
   ``RandomHorizontalFlip``, ``ToTensor``, ``Normalize`` and a
   ``DataLoader`` of worker processes, with ``Momentum`` under a
   ``PiecewiseDecay`` and top-1 / top-5 ``Accuracy``; the rate batches
   arrive at beside phase 27's step rate; ``evaluate`` and ``predict``
   over 4 batches through ``Resize(256)``, ``CenterCrop(224)``;
   ``summary`` counts 25,557,032 parameters; ``save`` then ``load`` into a
   fresh model gives the same eval logits and BN buffers;
30. card against CPU from the same weights: ResNet-50 (10 classes, 64 x
   64, batch 8) eval and train logits, the BN buffers, one Momentum
   step's parameters; a sweep of ``conv2d`` / ``conv2d_transpose`` /
   ``max_pool2d`` / ``avg_pool2d`` through the explicit-padding routes,
   forward and gradient;
31. an ``amp`` JSON line (phases 18-21), an ``encoders`` JSON line (phases
   23-26), a ``vision`` JSON line (phases 27-30), a ``kernels`` JSON line
   (the GPT, encoder and MoE shapes; no TPU kernel lies on the vision
   path), then the result line.
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
# mask dims B, H, Q(Tq), K(Tk) or 1; mask "pad" is the encoders' additive
# padding mask, [B, 1, 1, Tk] of 0 on each row's kept keys and -1e9 past
# them, taking no gradient
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
    (False, 128, 128, 12, 12, 64, torch.float32, None, "pad", True),
    (False, 200, 200, 12, 12, 64, torch.bfloat16, None, "pad", True),
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


def padding_bias(gen, b, tk):
    """The encoders' additive mask ``[b, 1, 1, tk]`` f32: row 0 keeps every
    key, the others a length drawn from ``gen``; -1e9 past the length."""
    lengths = torch.randint(1, tk + 1, (b,), generator=gen, device=DEVICE)
    lengths[0] = tk
    kept = torch.arange(tk, device=DEVICE)[None, :] < lengths[:, None]
    return torch.where(kept, 0.0, -1e9)[:, None, None, :]


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
    if mcode == "pad":
        bias = padding_bias(gen, b, tk)
    elif mcode is not None:
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


def flash_bound(kind, q, k, causal, peaks, bias=None):
    """:func:`bounds`: each input read once, each output written once; QK,
    dP, P.V, dQ, dK, dV as 2 * D FLOPs per visible (query, key) pair, of
    the inputs' type. A bias (f32, as the kernels read it) adds its bytes;
    a padding bias ``[B|1, 1, 1, Tk]`` hides its -1e9 keys, and the pairs
    counted are the kept ones, the work these inputs need."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qi = np.arange(tq)
    pairs = (int(np.clip(qi + tk - tq + 1, 0, tk).sum()) if causal
             else tq * tk) * b
    if bias is not None and not causal and bias.shape[1:3] == (1, 1):
        kept = int((bias[:, 0, 0, :] > -1e8).sum()) * (b // bias.shape[0])
        pairs = tq * kept
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * d * products * pairs * h
    elt = q.element_size()
    qb, kvb, rows = b * tq * h * d * elt, b * tk * hkv * d * elt, b * h * tq * 4
    nbytes = {"fwd": 2 * qb + 2 * kvb + rows,
              "dq": 3 * qb + 2 * kvb + 2 * rows,
              "dkv": 2 * qb + 2 * kvb + 2 * rows + 2 * b * tk * h * d * 4}[kind]
    if bias is not None:
        nbytes += bias.numel() * 4
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


def time_in_turns(kern_fwd, kern_pair, yard, do, call_kw=None):
    """K1 in turns with SDPA's forward (K1, SDPA, SDPA, K1) and the pair
    K2a + K2b in turns with SDPA's backward, on one yardstick of
    :func:`sdpa_yardsticks`: (label with the backend, forward turns,
    backward turns). ``call_kw`` is SDPA's masking (default causal)."""
    from torch.nn.attention import sdpa_kernel

    label, qh, kh, vh, kw = yard
    kw = dict(kw, **(call_kw or {"is_causal": True}))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    be = sdpa_backend(qh, kh, vh, **kw)
    with sdpa_kernel([be]):
        def lib():
            return sdpa(qh, kh, vh, **kw)
        turns = [cuda_ms(kern_fwd), cuda_ms(lib), cuda_ms(lib),
                 cuda_ms(kern_fwd)]
        out = sdpa(qh, kh, vh, **kw)
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


# -- phases 23-26: the encoders, through paddle.Model and TrainStep ----------

# ERNIE-3.0-base (the reference's ErnieConfig.ernie3_base, PaddleNLP's
# ernie-3.0-base-zh: hidden 768, 12 layers, 12 heads, FFN 3072, vocab
# 40000, dropouts 0.1) fine-tuned as a 2-class sentence-pair classifier:
# batch 32 at max_seq_length 128, real lengths 16-128; AdamW at PaddleNLP's
# fine-tune settings (lr 3e-5, weight decay 0.01) under a linear warmup
# into a linear decay to 0
ERNIE_BATCH, ERNIE_SEQ, ERNIE_MIN_LEN = 32, 128, 16
ERNIE_STEPS, ERNIE_EVAL_BATCHES = 32, 8
ERNIE_LR, ERNIE_WD, ERNIE_WARMUP = 3e-5, 0.01, 3
CLS_ID, SEP_ID, MASK_ID = 1, 2, 103
# evaluate's logits, kernel vs plain attention on the same weights: each of
# the 12 layers' attention may differ by FLASH_TOL (relative, f32), and the
# post-LN blocks renormalise between layers, so the differences add: 12 x
# FLASH_TOL of the largest logit
ENCODER_LOGIT_RTOL = 12 * FLASH_TOL[torch.float32]
# BERT-base masked-LM pretraining (Devlin et al. 2019: L=12, H=768, A=12,
# vocab 30522; the reference's BertConfig defaults) at sequence 512, batch
# 8: AdamW with the paper's settings (lr 1e-4, beta2 0.999, eps 1e-6,
# weight decay 0.01) and a clip at 1.0; 15 % of the real tokens labelled
BERT_BATCH, BERT_SEQ, BERT_STEPS, MLM_SHARE = 8, 512, 4, 0.15
BERT_ADAMW = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-6,
                  weight_decay=0.01)
ERNIE_BLOCKS = 12


class PairData:
    """Synthetic sentence pairs as a tokenizer pads them: ``[CLS] a [SEP] b
    [SEP]`` then 0s up to ``seq``, token types 0 on ``a`` and 1 on ``b``,
    keep-mask 1 on the real tokens, real lengths drawn from the seed. A
    sample's class (1 for three samples in four, as in an imbalanced
    sentiment set) shows in its tokens: a quarter of them come from that
    class's 16 cue ids, so the label is a function of the tokens. Samples
    are numpy (the DataLoader's worker processes stack them)."""

    CUE_IDS = (1000, 2000)  # class c's cues: CUE_IDS[c] + 0..15

    def __init__(self, n, vocab, seq, seed):
        rng = np.random.default_rng(seed)
        self.lengths = rng.integers(ERNIE_MIN_LEN, seq + 1, n)
        self.labels = (rng.random(n) < 0.75).astype(np.int64)
        self.ids = np.zeros((n, seq), np.int64)
        self.types = np.zeros((n, seq), np.int64)
        self.mask = np.zeros((n, seq), np.int64)
        for i, real in enumerate(self.lengths):
            body = rng.integers(SEP_ID + 1, vocab, real)
            cue = rng.random(real) < 0.25
            body[cue] = self.CUE_IDS[self.labels[i]] + rng.integers(
                0, 16, int(cue.sum()))
            half = real // 2
            body[0], body[half - 1], body[real - 1] = CLS_ID, SEP_ID, SEP_ID
            self.ids[i, :real] = body
            self.types[i, half:real] = 1
            self.mask[i, :real] = 1

    def __getitem__(self, i):
        return self.ids[i], self.types[i], self.mask[i], self.labels[i]

    def __len__(self):
        return len(self.labels)


def build_ernie(layers=ERNIE_BLOCKS, dropout=0.1):
    from paddle_tpu_torch.text.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification)

    kw = dict(hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    # ernie3_base fixes the depth; a cut depth keeps its widths
    cfg = (ErnieConfig.ernie3_base(**kw) if layers == ERNIE_BLOCKS else
           ErnieConfig(hidden_size=768, num_hidden_layers=layers,
                       num_attention_heads=12, **kw))
    return ErnieForSequenceClassification(cfg, num_classes=2, device=DEVICE,
                                          seed=SEED)


def ernie_model(net, steps=None):
    """``paddle.Model`` of ``net`` prepared as the fine-tune: AdamW with a
    linear warmup into a linear decay over ``steps`` (without ``steps``,
    ERNIE_LR held), cross entropy, accuracy."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW, lr

    sched = ERNIE_LR if steps is None else lr.LinearWarmup(
        lr.PolynomialDecay(ERNIE_LR, decay_steps=steps - ERNIE_WARMUP,
                           end_lr=0.0),
        warmup_steps=ERNIE_WARMUP, start_lr=0.0, end_lr=ERNIE_LR)
    opt = AdamW(learning_rate=sched, parameters=net.parameters(),
                weight_decay=ERNIE_WD)
    return Model(net).prepare(opt, CrossEntropyLoss(), Accuracy())


@contextlib.contextmanager
def flash_calls(fa):
    """Record how each K1 / K2a / K2b launch was called: ``{kind: [(causal,
    bias shape or None, want_ds), ...]}`` (launches through the kernels
    only: a ``plain_attention`` block inside records nothing)."""
    calls = {"fwd": [], "dq": [], "dkv": []}
    names = {"fwd": "forward", "dq": "bwd_dq", "dkv": "bwd_dkv"}
    saved = {k: getattr(fa, f"flash_attention_{n}_cuda")
             for k, n in names.items()}

    def spy(kind):
        real = saved[kind]

        def call(q, k, v, bias=None, *a, causal=False, **kw):
            calls[kind].append((causal, None if bias is None
                                else tuple(bias.shape),
                                kw.get("want_ds", False)))
            return real(q, k, v, bias, *a, causal=causal, **kw)
        return call

    try:
        for k, n in names.items():
            setattr(fa, f"flash_attention_{n}_cuda", spy(k))
        yield calls
    finally:
        for k, n in names.items():
            setattr(fa, f"flash_attention_{n}_cuda", saved[k])


def check_padded_calls(calls, kinds, n, bias_shape, what):
    """Each kind launched ``n`` times, all non-causal with the padding bias
    of ``bias_shape`` and no dS."""
    want = [(False, bias_shape, False)] * n
    for kind in kinds:
        if calls[kind] != want:
            got = sorted(set(calls[kind]))
            raise AssertionError(f"{what}: {kind} launched "
                                 f"{len(calls[kind])} times as {got}, want "
                                 f"{n} x non-causal, bias {bias_shape}, "
                                 "no dS")


def _clock():
    """A callback timing each training step (the batch is on the card at
    ``on_train_batch_begin``; ``train_batch`` syncs on the loss)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.ms, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append(1e3 * (time.perf_counter() - self._t0))
            self.losses.append(logs["loss"])

    return StepClock()


def phase_ernie_finetune(fa, smi):
    """Phase 23: ERNIE-3.0-base at full width and depth fine-tuned through
    ``Model.fit`` over a ``DataLoader`` (shuffled, 2 worker processes),
    then ``evaluate`` and ``predict``."""
    from paddle_tpu_torch.io import DataLoader

    t0 = time.perf_counter()
    net = build_ernie()
    cfg = net.config
    train = PairData(ERNIE_STEPS * ERNIE_BATCH, cfg.vocab_size, ERNIE_SEQ,
                     SEED + 20)
    evals = PairData(ERNIE_EVAL_BATCHES * ERNIE_BATCH, cfg.vocab_size,
                     ERNIE_SEQ, SEED + 21)
    model = ernie_model(net, ERNIE_STEPS)
    np.random.seed(SEED)
    loader = DataLoader(train, batch_size=ERNIE_BATCH, shuffle=True,
                        num_workers=2, device=DEVICE)
    eval_loader = DataLoader(evals, batch_size=ERNIE_BATCH, num_workers=2,
                             device=DEVICE)
    real = []
    hook = net.register_forward_pre_hook(
        lambda m, args: real.append(args[2].sum()) if len(args) > 2
        else None)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"# phase 23: ERNIE-3.0-base fine-tune ({n_params / 1e6:.1f} M "
        f"parameters, dropouts {cfg.hidden_dropout_prob}) built in "
        f"{time.perf_counter() - t0:.2f} s (set-up); {ERNIE_STEPS} steps of "
        f"{ERNIE_BATCH} x {ERNIE_SEQ} (real lengths "
        f"{ERNIE_MIN_LEN}-{ERNIE_SEQ}), 2 worker processes")
    clock = _clock()
    torch.cuda.synchronize()
    reset_flash(fa)
    with flash_calls(fa) as fit_calls:
        model.fit(loader, epochs=1, verbose=0, callbacks=[clock])
    fit_launches = flash_counts(fa)
    train_real = [int(r) for r in real]
    del real[:]
    # steps 2 on (the first pays the cuBLAS handles and the allocator)
    ms = float(np.mean(clock.ms[1:]))
    padded = ERNIE_BATCH * ERNIE_SEQ
    real_mean = float(np.mean(train_real[1:]))
    losses = clock.losses
    log(f"losses {[round(x, 4) for x in losses]}")
    log(f"steps 2-{ERNIE_STEPS} mean {ms:.2f} ms = "
        f"{ERNIE_BATCH / ms * 1e3:.1f} samples/s, "
        f"{padded / ms * 1e3:.0f} padded tokens/s, "
        f"{real_mean / ms * 1e3:.0f} real tokens/s ({real_mean:.0f} of "
        f"{padded} a step); flash launches in fit {fit_launches} "
        f"(attention dropout {cfg.attention_probs_dropout_prob}: the dense "
        f"route, as the reference)  [{smi}]")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"fine-tune loss did not fall: first 4 mean "
                             f"{first}, last 4 mean {last}")
    if any(fit_launches.values()) or any(fit_calls.values()):
        raise AssertionError(f"fit launched flash kernels {fit_launches}: "
                             "training attention with dropout takes the "
                             "dense route")

    bias_shape = (ERNIE_BATCH, 1, 1, ERNIE_SEQ)
    n_eval = ERNIE_BLOCKS * ERNIE_EVAL_BATCHES
    outs = []
    capture = net.register_forward_hook(
        lambda m, args, out: outs.append(out.detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    with flash_calls(fa) as calls:
        t1 = time.perf_counter()
        result = model.evaluate(eval_loader, verbose=0)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t1
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_launches = fa.launches_fwd
    check_padded_calls(calls, ("fwd",), n_eval, bias_shape, "evaluate")
    if calls["dq"] or calls["dkv"]:
        raise AssertionError("evaluate launched a backward kernel")
    logits = torch.cat(outs).float().cpu().numpy()
    outs.clear()
    with plain_attention(fa):
        plain_result = model.evaluate(eval_loader, verbose=0)
    plain = torch.cat(outs).float().cpu().numpy()
    capture.remove()
    hook.remove()
    eval_real = sum(int(r) for r in real[:ERNIE_EVAL_BATCHES])
    n_eval_samples = ERNIE_EVAL_BATCHES * ERNIE_BATCH
    # the same evaluate over an in-process loader: what the worker
    # processes' start-up costs an 8-batch evaluate
    t1 = time.perf_counter()
    model.evaluate(DataLoader(evals, batch_size=ERNIE_BATCH, device=DEVICE),
                   verbose=0)
    torch.cuda.synchronize()
    eval_s0 = time.perf_counter() - t1
    log(f"evaluate {result}: {n_eval_samples / eval_s:.1f} samples/s "
        f"({eval_s * 1e3:.1f} ms for {ERNIE_EVAL_BATCHES} batches, "
        f"{eval_real} real tokens; {n_eval_samples / eval_s0:.1f} "
        f"samples/s over an in-process loader), peak {eval_peak:.2f} GiB, "
        f"K1 {eval_launches} launches = {ERNIE_BLOCKS} layers x "
        f"{ERNIE_EVAL_BATCHES} batches, non-causal, bias {bias_shape}  "
        f"[{smi}]")
    if not 0.0 <= result["acc"] <= 1.0 or not np.isfinite(result["loss"]):
        raise AssertionError(f"evaluate gave {result}")
    err = float(np.abs(logits - plain).max())
    scale = float(np.abs(plain).max())
    log(f"evaluate's logits {logits.shape}, kernel vs plain attention "
        f"(plain: {plain_result}): max|err| {err:.3e} = {err / scale:.2e} "
        f"of max|logit| {scale:.3f} (rtol {ENCODER_LOGIT_RTOL:.1e})")
    if logits.shape != (n_eval_samples, 2) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"evaluate gave {logits.shape} logits")
    if not err <= ENCODER_LOGIT_RTOL * scale:
        raise AssertionError("evaluate's logits differ from the plain "
                             "attention's")

    # predict feeds a batch's first field only (the reference's
    # Model.predict): the ids, with no attention mask, so K1 runs
    # non-causal without a bias
    reset_flash(fa)
    with flash_calls(fa) as calls:
        predicted = model.predict(eval_loader, stack_outputs=True)[0]
    predict_launches = fa.launches_fwd
    check_padded_calls(calls, ("fwd",), n_eval, None, "predict")
    log(f"predict (ids only, as the reference): outputs "
        f"{predicted.shape}, K1 {predict_launches} launches, non-causal, "
        f"no bias")
    if predicted.shape != (n_eval_samples, 2) or \
            not np.isfinite(predicted).all():
        raise AssertionError(f"predict gave {predicted.shape} outputs")
    out = dict(step_ms=ms, samples_per_s=ERNIE_BATCH / ms * 1e3,
               padded_tokens_per_s=padded / ms * 1e3,
               real_tokens_per_s=real_mean / ms * 1e3, losses=losses,
               fit_launches=fit_launches, eval=result,
               eval_samples_per_s=n_eval_samples / eval_s,
               eval_samples_per_s_in_process=n_eval_samples / eval_s0,
               eval_peak_gib=eval_peak, eval_launches_fwd=eval_launches,
               predict_launches_fwd=predict_launches,
               logit_err_vs_plain=err, card=smi)
    del model, net, loader, eval_loader
    torch.cuda.empty_cache()
    return out


def phase_ernie_lockstep(fa):
    """Phase 24: ERNIE at depth 2 with dropouts 0, a kernel model and a
    plain-attention model from the same weights through
    ``Model.train_batch`` for LOCKSTEP_STEPS steps on one batch: the
    losses agree, K1 / K2a / K2b run once a layer a step, non-causal with
    the padding bias and no dS."""
    from paddle_tpu_torch.io import DataLoader

    a, b = build_ernie(2, 0.0), build_ernie(2, 0.0)
    b.load_state_dict(a.state_dict())
    ma, mb = ernie_model(a), ernie_model(b)
    data = PairData(ERNIE_BATCH, a.config.vocab_size, ERNIE_SEQ, SEED + 22)
    *xs, ys = next(iter(DataLoader(data, batch_size=ERNIE_BATCH,
                                   device=DEVICE)))
    worst = 0.0
    reset_flash(fa)
    with flash_calls(fa) as calls:
        for i in range(LOCKSTEP_STEPS):
            la = ma.train_batch(xs, ys)[0]
            with plain_attention(fa):
                lb = mb.train_batch(xs, ys)[0]
            rel = abs(la - lb) / abs(lb)
            worst = max(worst, rel)
            log(f"# phase 24: ERNIE depth 2 step {i}: loss kernel {la:.7f} "
                f"plain {lb:.7f} rel {rel:.2e}")
    launches = flash_counts(fa)
    n = 2 * LOCKSTEP_STEPS
    check_padded_calls(calls, ("fwd", "dq", "dkv"), n,
                       (ERNIE_BATCH, 1, 1, ERNIE_SEQ), "lockstep")
    log(f"launches {launches} = 2 layers x {LOCKSTEP_STEPS} steps, "
        f"non-causal, padding bias, no dS; worst loss rel {worst:.2e} "
        f"(rtol {TRAIN_LOSS_RTOL})")
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"ERNIE lockstep losses differ: rel {worst}")
    del ma, mb, a, b
    torch.cuda.empty_cache()
    return launches


def mlm_batch(vocab):
    """BERT_BATCH sequences padded to BERT_SEQ (real lengths 128-512 drawn
    from the seed) of Zipf-distributed ids, as natural text is; 15 % of
    the real tokens between [CLS] and [SEP] replaced by [MASK] and
    labelled with the original id, the rest -100; token types 0 then 1
    from the middle."""
    rng = np.random.default_rng(SEED + 23)
    b, t = BERT_BATCH, BERT_SEQ
    lengths = rng.integers(128, t + 1, b)
    lengths[0] = t
    ids = np.zeros((b, t), np.int64)
    types = np.zeros((b, t), np.int64)
    mask = np.zeros((b, t), np.int64)
    labels = np.full((b, t), -100, np.int64)
    for i, real in enumerate(lengths):
        body = np.minimum(rng.zipf(1.3, real) + MASK_ID, vocab - 1)
        body[0], body[real - 1] = CLS_ID, SEP_ID
        picked = np.flatnonzero(rng.random(real - 2) < MLM_SHARE) + 1
        labels[i, picked] = body[picked]
        body[picked] = MASK_ID
        ids[i, :real] = body
        types[i, real // 2:real] = 1
        mask[i, :real] = 1
    return [torch.as_tensor(x, device=DEVICE)
            for x in (ids, types, mask, labels)], int(lengths.sum())


def build_bert():
    """BERT-base for masked-LM pretraining, attention dropout 0 (the
    kernels carry no dropout, as the reference's Pallas route)."""
    from paddle_tpu_torch.text.models.bert import BertConfig, BertForMaskedLM

    return BertForMaskedLM(BertConfig(attention_probs_dropout_prob=0.0),
                           device=DEVICE, seed=SEED)


def bert_trainer(level):
    """``TrainStep`` + AdamW (+ clip) on BERT-base from the seed, in f32
    (``level`` None) or under ``auto_cast(level)``, and its batch."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    model = build_bert()
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **BERT_ADAMW)

    def loss_fn(m, ids, types, mask, labels):
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            return m(ids, types, attention_mask=mask, labels=labels)

    batch, real = mlm_batch(model.config.vocab_size)
    return TrainStep(model, loss_fn, opt), batch, real


def bert_run(fa, level):
    """BERT_STEPS steps of :func:`bert_trainer` from a reset peak and
    zeroed counts."""
    step, batch, real = bert_trainer(level)
    torch.manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    losses, step_ms = [], []
    with flash_calls(fa) as calls:
        for _ in range(BERT_STEPS):
            t0 = time.perf_counter()
            loss = step(*batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
    r = dict(losses=losses, step_ms=step_ms, launches=flash_counts(fa),
             peak_bytes=torch.cuda.max_memory_allocated(),
             tokens=batch[0].numel(), real_tokens=real, calls=calls)
    del step
    torch.cuda.empty_cache()
    return r


def phase_bert_mlm(fa, smi):
    """Phase 25: BERT-base masked-LM pretraining at T = 512 in f32 and
    under O1: the loss falls, K1 / K2a / K2b launch 12 x BERT_STEPS times
    (bf16 under O1), non-causal with the padding bias; the first O1 loss
    lies within AMP_LOSS_RTOL of the f32 one."""
    out = {}
    n = ERNIE_BLOCKS * BERT_STEPS
    bias_shape = (BERT_BATCH, 1, 1, BERT_SEQ)
    for level in (None, "O1"):
        label = "f32" if level is None else level
        r = bert_run(fa, level)
        ms = float(np.mean(r["step_ms"][1:]))
        log(f"# phase 25: BERT-base MLM {label}, {BERT_BATCH} x {BERT_SEQ} "
            f"({r['real_tokens']} real tokens): losses "
            f"{[round(x, 5) for x in r['losses']]}, steps 2-{BERT_STEPS} "
            f"{ms:.2f} ms = {r['tokens'] / ms * 1e3:.0f} tokens/s "
            f"({r['real_tokens'] / ms * 1e3:.0f} real), peak "
            f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, launches {r['launches']}"
            f"  [{smi}]")
        if not all(np.isfinite(r["losses"])) or \
                not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"BERT {label}: loss did not fall: "
                                 f"{r['losses']}")
        check_padded_calls(r["calls"], ("fwd", "dq", "dkv"), n, bias_shape,
                           f"BERT {label}")
        want_bf16 = n if level else 0
        if any(r["launches"][f"{k}_bf16"] != want_bf16
               for k in ("fwd", "dq", "dkv")):
            raise AssertionError(f"BERT {label}: launches {r['launches']}, "
                                 f"want {want_bf16} in bf16")
        out[label] = dict(step_ms=ms, tokens_per_s=r["tokens"] / ms * 1e3,
                          real_tokens_per_s=r["real_tokens"] / ms * 1e3,
                          peak_gib=r["peak_bytes"] / 2 ** 30,
                          launches=r["launches"], losses=r["losses"])
    f32, o1 = out["f32"]["losses"][0], out["O1"]["losses"][0]
    rel = abs(o1 - f32) / abs(f32)
    log(f"first loss O1 {o1:.6f} vs f32 {f32:.6f}: rel {rel:.2e} (rtol "
        f"{AMP_LOSS_RTOL:.2e})")
    if not rel <= AMP_LOSS_RTOL:
        raise AssertionError("BERT: first O1 loss differs from f32")
    out["first_loss_rel_f32"] = rel
    out["card"] = smi
    return out


def phase_encoder_flash_timing(fa, peaks, label, b, t, h=12, d=64):
    """K1, K2a, K2b at an encoder's shapes: non-causal, q / k / v strided
    out of the fused projection, the padding bias [b, 1, 1, t]; each
    checked against its plain version, K1 timed in turns with SDPA's
    forward and K2a + K2b with SDPA's backward under the same additive
    mask, beside the plain versions and the bound; f32 and bf16."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_inputs(gen, b, t, t, h, h, d, dt, True)
        bias = padding_bias(gen, b, t)
        worst = {}
        tag = f"{label} B={b} T={t} H={h} D={d} {str(dt)[6:]}"
        compare_flash(fa, q, k, v, do, bias, False, False, worst, tag)
        o, lse = fa.flash_attention_forward_cuda(q, k, v, bias)
        delta = fa._delta(o, do).contiguous()
        calls = {
            "fwd": (lambda: fa.flash_attention_forward_cuda(q, k, v, bias),
                    lambda: fa.flash_attention_forward_plain(q, k, v, bias)),
            "dq": (lambda: fa.flash_attention_bwd_dq_cuda(
                       q, k, v, bias, do, lse, delta),
                   lambda: fa.flash_attention_bwd_dq_plain(
                       q, k, v, bias, do, lse, delta)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv_cuda(
                        q, k, v, bias, do, lse, delta),
                    lambda: fa.flash_attention_bwd_dkv_plain(
                        q, k, v, bias, do, lse, delta)),
        }

        def pair():
            calls["dq"][0]()
            calls["dkv"][0]()

        yard = sdpa_yardsticks(q, k, v)[0]
        mask = bias.to(dt)
        lib_label, turns, bturns = time_in_turns(
            calls["fwd"][0], pair, yard, do, {"attn_mask": mask})
        lib_fwd = (turns[1] + turns[2]) / 2
        lib_bwd = (bturns[1] + bturns[2]) / 2
        pair_ms = (bturns[0] + bturns[3]) / 2
        for kind, (kern, plain) in calls.items():
            ms = ((turns[0] + turns[3]) / 2 if kind == "fwd"
                  else cuda_ms(kern))
            plain_ms = cuda_ms(plain, iters=5, warm=1)
            lib = lib_fwd if kind == "fwd" else lib_bwd
            r = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                     max_abs_err=worst[kind],
                     **flash_bound(kind, q, k, False, peaks, bias))
            if kind != "fwd":
                r["pair_ms"] = pair_ms
            rows[(kind, dt)] = r
            log(f"{kind:3s} {tag} padded: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa "
                f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
                f"[{lib_label}, attn_mask] {lib:.4f} ms, "
                f"{bound_text(r, ms)}")
        log(f"pair {tag}: K2a + K2b {pair_ms:.4f} ms vs sdpa backward "
            f"{lib_bwd:.4f} ms = {pair_ms / lib_bwd:.3f}x")
        del q, k, v, do, o, lse, delta, yard
        torch.cuda.empty_cache()
    return rows


def phases_encoders(fa, smi, peaks):
    """Phases 23-26; returns the ``encoders`` JSON line's numbers and the
    timed rows per shape."""
    finetune = phase_ernie_finetune(fa, smi)
    lockstep = phase_ernie_lockstep(fa)
    bert = phase_bert_mlm(fa, smi)
    log("# phase 26: K1 / K2 at the encoders' shapes, padding bias")
    timed = {
        "ernie": phase_encoder_flash_timing(fa, peaks, "ERNIE",
                                            ERNIE_BATCH, ERNIE_SEQ),
        "bert": phase_encoder_flash_timing(fa, peaks, "BERT", BERT_BATCH,
                                           BERT_SEQ),
    }
    line = {"ernie_finetune": finetune, "ernie_lockstep_launches": lockstep,
            "bert_mlm": bert,
            "flash": {f"{shape} {kind} {str(dt)[6:]}": {
                k: r[k] for k in ("ms", "plain_ms", "library_ms", "pair_ms",
                                  "bound_ms", "bound_fma_ms") if k in r}
                for shape, rows in timed.items()
                for (kind, dt), r in rows.items()}, "card": smi}
    return line, timed, lockstep


# -- phases 27-30: ResNet-50 --------------------------------------------------

# ResNet-50 (He et al. 2016, Table 1; the reference's resnet50(num_classes=
# 1000)) at 224 x 224, batch 256, trained with the repo's own benchmark
# recipe (bench_configs.py::run_resnet50): Momentum(0.1, 0.9, weight decay
# 1e-4), cross entropy, one fixed batch of standard-normal images and
# uniform labels
RESNET_BATCH, RESNET_HW, RESNET_CLASSES, RESNET_STEPS = 256, 224, 1000, 12
RESNET_LR = 0.1
RESNET_MOMENTUM = dict(momentum=0.9, weight_decay=1e-4)
# the learning rate ramps linearly from lr / 10 to lr over the 12 steps
# (Goyal et al. 2017, section 2.2's gradual warmup). At a constant 0.1
# from random weights the fixed batch's loss climbs back over steps 5-9,
# and the gate's margin (the mean of the first 4 steps' losses less the
# last 4's) was 0.17 and 0.27 in two runs, -0.84 over 16 steps; a 4- or
# 8-step warmup moves the bump later (0.94, 0.60); the 12-step ramp gave
# 1.53 with the loss falling almost throughout (scripts/
# resnet_warmup_sweep.py on an H100; cuDNN's algorithms sum in a
# run-dependent order, and the trajectory amplifies it)
RESNET_WARMUP_STEPS, RESNET_WARMUP_START = 12, 0.01
# a training image costs 3 forwards: ResNet-50's 4.1 GMAC (8.2 GFLOP)
# forward, and a backward of twice that
RESNET_TRAIN_FLOP = 3 * 8.2e9
RESNET_PARAMS = 25_557_032
# phase 29: paddle.Model over FakeData through the ImageNet transforms
FIT_STEPS, EVAL_BATCHES, FAKE_HW = 8, 4, 256
IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
# phase 30, card against CPU, as max|err| / max|CPU|: f32 sums in other
# orders (cuDNN's algorithms, TF32 off) through 50 layers
CARD_CPU_RTOL = 1e-4
# the op sweep: one conv / pool, f32 sums of at most a few hundred terms
OP_SWEEP_RTOL = 1e-5


def build_resnet(**kw):
    from paddle_tpu_torch.vision.models import resnet50

    return resnet50(device=kw.pop("device", DEVICE), seed=SEED, **kw)


def resnet_batch():
    """The fixed batch, made with numpy from the seed as the reference's
    benchmark makes it, then put on the card once."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((RESNET_BATCH, 3, RESNET_HW, RESNET_HW),
                            dtype=np.float32)
    y = rng.integers(0, RESNET_CLASSES, (RESNET_BATCH,))
    return torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)


def resnet_trainer(model, level):
    """``TrainStep`` + ``Momentum`` (under the warmup; the caller steps
    the schedule) in f32 (``level`` None), under ``auto_cast(level=
    "O1")``, or after ``decorate(level="O2")`` with ``multi_precision``
    under ``auto_cast(level="O2")`` (the reference benchmark's setting)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F

    sched = topt.lr.LinearWarmup(RESNET_LR, RESNET_WARMUP_STEPS,
                                 RESNET_WARMUP_START, RESNET_LR)
    opt = topt.Momentum(sched, parameters=model.parameters(),
                        multi_precision=level == "O2", **RESNET_MOMENTUM)
    if level == "O2":
        amp.decorate(model, opt, level="O2")

    def loss_fn(m, x, y):
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            return F.cross_entropy(m(x), y)

    return TrainStep(model, loss_fn, opt)


def device_busy_ms(run):
    """Device time of ``run()`` under ``torch.profiler``: the sum of its
    kernels' self time, and the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = launches = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and \
                evt.self_device_time_total > 0:
            busy += evt.self_device_time_total / 1e3
            launches += evt.count
    return busy, launches


def bn_buffers(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("_mean", "_variance"))}


@contextlib.contextmanager
def conv_bn_spy():
    """The dtypes each ``torch.nn.functional.conv2d`` / ``batch_norm``
    call of the port receives, as ``{"conv": [...], "bn": [...]}``."""
    import torch.nn.functional as tF

    seen = {"conv": [], "bn": []}
    conv, bn = tF.conv2d, tF.batch_norm

    def conv_spy(x, w, *a, **kw):
        seen["conv"].append((x.dtype, w.dtype))
        return conv(x, w, *a, **kw)

    def bn_spy(x, mean, var, weight=None, bias=None, *a, **kw):
        seen["bn"].append((x.dtype, mean.dtype,
                           None if weight is None else weight.dtype))
        return bn(x, mean, var, weight, bias, *a, **kw)

    tF.conv2d, tF.batch_norm = conv_spy, bn_spy
    try:
        yield seen
    finally:
        tF.conv2d, tF.batch_norm = conv, bn


def run_resnet(smi, peaks, level, batch, phase, f32=None):
    """``RESNET_STEPS`` steps of ResNet-50 at ``level`` on ``batch``; the
    step times (steps 3 on), the peak, the device's busy share over two
    more profiled steps, and the gates of the phase."""
    t0 = time.perf_counter()
    model = build_resnet()
    step = resnet_trainer(model, level)
    tag = level or "f32"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    spy_calls = None
    for i in range(RESNET_STEPS):
        t1 = time.perf_counter()
        if i == 0 and level is not None:
            with conv_bn_spy() as spy_calls:
                loss = step(*batch)
        else:
            loss = step(*batch)
        losses.append(float(loss))  # syncs
        ms.append(1e3 * (time.perf_counter() - t1))
        step._opt._learning_rate.step()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy, launches = device_busy_ms(lambda: [step(*batch) for _ in range(2)])
    step_ms = float(np.mean(ms[2:]))
    busy_step = busy / 2
    images = RESNET_BATCH / step_ms * 1e3
    peak_kind = "f32" if level is None else "bf16"
    bound_images = peaks[peak_kind] / RESNET_TRAIN_FLOP
    out = dict(level=tag, step_ms=step_ms, step_ms_all=ms,
               images_per_s=images, bound_images_per_s=bound_images,
               share_of_bound=images / bound_images, peak_gib=peak,
               device_busy_ms=busy_step,
               device_idle_share=max(0.0, 1.0 - busy_step / step_ms),
               launches_per_step=launches // 2, losses=losses, card=smi)
    log(f"# phase {phase}: ResNet-50 {tag}, {RESNET_BATCH} x {RESNET_HW}^2, "
        f"Momentum lr {RESNET_LR} (warmup {RESNET_WARMUP_STEPS} steps from "
        f"{RESNET_WARMUP_START}), {RESNET_MOMENTUM}: steps "
        f"3-{RESNET_STEPS} {step_ms:.2f} ms "
        f"= {images:.1f} images/s ({100 * images / bound_images:.1f} % of the "
        f"{peak_kind} bound {bound_images:.0f} images/s at "
        f"{peaks[peak_kind] / 1e12:.0f} TFLOP/s), peak {peak:.2f} GiB, "
        f"device busy {busy_step:.2f} ms a step (idle "
        f"{100 * out['device_idle_share']:.1f} %), {launches // 2} launches "
        f"a step; {time.perf_counter() - t0:.1f} s  [{smi}]")
    log(f"losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in ms]}")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"ResNet-50 {tag}: loss did not fall on the "
                             f"fixed batch: first 4 mean {first}, last 4 "
                             f"mean {last}")
    bufs = bn_buffers(model)
    stuck = [k for k, v in bufs.items() if not torch.isfinite(v).all()
             or torch.all(v == (0.0 if k.endswith("_mean") else 1.0))]
    if len(bufs) != 106 or stuck:
        raise AssertionError(f"ResNet-50 {tag}: {len(bufs)} BN buffers, "
                             f"not finite or unmoved: {stuck[:4]}")
    if spy_calls is not None:
        convs, bns = spy_calls["conv"], spy_calls["bn"]
        bad_conv = [c for c in convs if c != (torch.bfloat16,) * 2]
        bad_bn = [c for c in bns if c[0] != torch.float32 or c[1]
                  != torch.float32 or c[2] != torch.float32]
        log(f"spy, step 1: {len(convs)} conv2d launches, all (x, w) "
            f"{sorted(set(convs))}; {len(bns)} batch_norm launches, "
            f"(x, running, weight) {sorted(set(bns))}")
        if len(convs) != 53 or len(bns) != 53 or bad_conv or bad_bn:
            raise AssertionError(f"ResNet-50 {tag}: conv / batch norm cast "
                                 f"points wrong: {len(convs)} convs "
                                 f"({bad_conv[:2]}), {len(bns)} batch norms "
                                 f"({bad_bn[:2]})")
        out["spy"] = dict(convs=len(convs), batch_norms=len(bns))
    if f32 is not None:
        rel = abs(losses[0] - f32["losses"][0]) / abs(f32["losses"][0])
        log(f"first {tag} loss {losses[0]:.6f} vs f32 "
            f"{f32['losses'][0]:.6f}: {rel:.2e} (rtol "
            f"{AMP_LOSS_RTOL:.2e} gates O1)")
        out["first_loss_rel_vs_f32"] = rel
        if level == "O1" and not rel <= AMP_LOSS_RTOL:
            raise AssertionError("first O1 loss off the f32 one")
    del model, step
    torch.cuda.empty_cache()
    return out


def imagenet_transforms(train):
    from paddle_tpu_torch.vision import transforms as T

    first = ([T.RandomResizedCrop(RESNET_HW), T.RandomHorizontalFlip()]
             if train else [T.Resize(FAKE_HW), T.CenterCrop(RESNET_HW)])
    return T.Compose(first + [T.ToTensor(),
                              T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def resnet_model(net):
    from paddle_tpu_torch import Model, metric
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt

    sched = topt.lr.PiecewiseDecay([FIT_STEPS // 2], [0.1, 0.01])
    return Model(net).prepare(
        topt.Momentum(sched, 0.9, parameters=net.parameters(),
                      weight_decay=1e-4),
        tnn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 5)))


def phase_resnet_hapi(smi, step_images):
    """Phase 29: ``Model.fit`` / ``evaluate`` / ``predict`` / ``save`` /
    ``load`` on ResNet-50 over ``FakeData`` through the reference's
    ImageNet transforms and a ``DataLoader`` of worker processes."""
    import os
    import tempfile

    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData

    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    train = FakeData(FIT_STEPS * RESNET_BATCH, (FAKE_HW, FAKE_HW, 3),
                     RESNET_CLASSES, imagenet_transforms(True))
    evals = FakeData(EVAL_BATCHES * RESNET_BATCH, (FAKE_HW, FAKE_HW, 3),
                     RESNET_CLASSES, imagenet_transforms(False))
    np.random.seed(SEED)
    loader = DataLoader(train, batch_size=RESNET_BATCH, shuffle=True,
                        num_workers=workers, device=DEVICE)
    eval_loader = DataLoader(evals, batch_size=RESNET_BATCH,
                             num_workers=workers, device=DEVICE)
    net = build_resnet()
    model = resnet_model(net)

    class Beats(Callback):
        """The time each batch arrives (the loader's wait included) and
        each step's loss."""

        def __init__(self):
            super().__init__()
            self.t, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            self.t.append(time.perf_counter())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    beats = Beats()
    t1 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, callbacks=[beats])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    gaps = np.diff(beats.t)
    fit_images = RESNET_BATCH / float(np.mean(gaps[1:])) if len(gaps) > 1 \
        else float("nan")
    log(f"# phase 29: ResNet-50 through paddle.Model: fit {FIT_STEPS} steps "
        f"of {RESNET_BATCH} FakeData images ({FAKE_HW}^2 -> "
        f"RandomResizedCrop({RESNET_HW}), flip, ToTensor, Normalize), "
        f"{workers} worker processes: {fit_s:.2f} s; steps 3-{FIT_STEPS} "
        f"arrive every {1e3 * float(np.mean(gaps[1:])):.1f} ms = "
        f"{fit_images:.1f} images/s against phase 27's "
        f"{step_images:.1f} images/s a step (ratio "
        f"{fit_images / step_images:.2f}); losses "
        f"{[round(x, 4) for x in beats.losses]}  [{smi}]")
    if len(beats.losses) != FIT_STEPS or \
            not all(np.isfinite(beats.losses)):
        raise AssertionError(f"fit gave losses {beats.losses}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    result = model.evaluate(eval_loader, verbose=0)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_eval = EVAL_BATCHES * RESNET_BATCH
    predicted = model.predict(eval_loader)[0]
    summary = model.summary()
    log(f"evaluate {result}: {n_eval / eval_s:.1f} images/s ({eval_s:.2f} s "
        f"for {EVAL_BATCHES} batches, Resize({FAKE_HW}), CenterCrop("
        f"{RESNET_HW}), worker start included), peak {eval_peak:.2f} GiB; "
        f"predict {[p.shape for p in predicted]}; summary {summary}")
    for k in ("acc_top1", "acc_top5"):
        if not 0.0 <= result[k] <= 1.0:
            raise AssertionError(f"evaluate gave {result}")
    if len(predicted) != EVAL_BATCHES or any(
            p.shape != (RESNET_BATCH, RESNET_CLASSES)
            or not np.isfinite(p).all() for p in predicted):
        raise AssertionError("predict gave wrong outputs")
    if summary["total_params"] != RESNET_PARAMS:
        raise AssertionError(f"summary counts {summary}")

    # save, then load into a fresh model built from another seed: the
    # same eval logits on one batch, running statistics included
    x = next(iter(eval_loader))[0]
    net.eval()
    with torch.no_grad():
        want = net(x).float()
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "resnet50"))
        from paddle_tpu_torch.vision.models import resnet50

        fresh_net = resnet50(device=DEVICE, seed=SEED + 1)
        fresh = resnet_model(fresh_net)
        fresh.load(os.path.join(tmp, "resnet50"))
    fresh_net.eval()
    with torch.no_grad():
        got = fresh_net(x).float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same_bn = all(torch.equal(a, b) for a, b in zip(
        bn_buffers(net).values(), bn_buffers(fresh_net).values()))
    log(f"save / load into a fresh model: eval logits max|err| {err:.3e} "
        f"of {scale:.3f}, BN buffers equal {same_bn}, velocities "
        f"{len(fresh._optimizer.state_dict()) - 1}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not same_bn or not err <= 1e-6 * scale:
        raise AssertionError("save / load changed the model")
    out = dict(fit_images_per_s=fit_images, step_images_per_s=step_images,
               fit_over_step=fit_images / step_images, fit_s=fit_s,
               fit_losses=beats.losses, workers=workers, eval=result,
               eval_images_per_s=n_eval / eval_s, eval_peak_gib=eval_peak,
               card=smi)
    del model, net, fresh, fresh_net, loader, eval_loader
    torch.cuda.empty_cache()
    return out


def rel_to_cpu(got, want):
    """max|got - want| / max|want|, ``got`` on any device, ``want`` on
    the CPU."""
    return float((got.cpu().double() - want.double()).abs().max()
                 / max(float(want.abs().max()), 1e-30))


# name -> (op, input shape, weight shape or None, keyword arguments)
OP_CASES = {
    "conv-same-s2": ("conv2d", (2, 3, 10, 11), (5, 3, 3, 3),
                     dict(stride=2, padding="SAME")),
    "conv-per-side": ("conv2d", (2, 3, 8, 9), (4, 3, 3, 3),
                      dict(padding=[1, 0, 2, 1], stride=2)),
    "conv-groups-dilation": ("conv2d", (2, 4, 11, 10), (6, 2, 3, 3),
                             dict(padding=2, dilation=2, groups=2)),
    "conv-nhwc": ("conv2d", (2, 9, 10, 3), (4, 3, 3, 3),
                  dict(stride=2, padding="SAME", data_format="NHWC")),
    "convT-opad": ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3),
                   dict(stride=2, padding=1, output_padding=1)),
    "convT-same-groups": ("conv2d_transpose", (2, 4, 5, 6), (4, 2, 3, 3),
                          dict(stride=2, padding="SAME", groups=2)),
    "max-ceil": ("max_pool2d", (2, 3, 9, 10), None,
                 dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "max-wide-pad": ("max_pool2d", (2, 3, 9, 10), None,
                     dict(kernel_size=3, stride=1, padding=2)),
    "max-nhwc": ("max_pool2d", (2, 9, 10, 3), None,
                 dict(kernel_size=3, stride=2, padding=1,
                      data_format="NHWC")),
    "avg-ceil-excl": ("avg_pool2d", (2, 3, 9, 10), None,
                      dict(kernel_size=3, stride=2, ceil_mode=True)),
    "avg-ceil-incl": ("avg_pool2d", (2, 3, 9, 10), None,
                      dict(kernel_size=3, stride=2, padding=1,
                           ceil_mode=True, exclusive=False)),
    "avg-wide-pad": ("avg_pool2d", (2, 3, 9, 10), None,
                     dict(kernel_size=3, stride=1, padding=[2, 1])),
}


def phase_card_vs_cpu(smi):
    """Phase 30: ResNet-50 (10 classes) on the card and on the CPU from the
    same weights, and a sweep of convs and pools through the explicit
    padding route, forward and gradient."""
    from paddle_tpu_torch.framework import load_numpy_state
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch import optimizer as topt

    t0 = time.perf_counter()
    errs = {}
    cpu = build_resnet(num_classes=10, device="cpu")
    card = build_resnet(num_classes=10)
    load_numpy_state(card, {k: v.numpy() for k, v in
                            cpu.state_dict().items()})
    rng = np.random.default_rng(SEED + 30)
    x = torch.from_numpy(rng.standard_normal((8, 3, 64, 64),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (8,)))
    for m in (cpu, card):
        m.eval()
    with torch.no_grad():
        errs["eval logits"] = rel_to_cpu(card(x.to(DEVICE)), cpu(x))
    for m in (cpu, card):
        m.train()
    with torch.no_grad():
        errs["train logits"] = rel_to_cpu(card(x.to(DEVICE)), cpu(x))
    cb, pb = bn_buffers(card), bn_buffers(cpu)
    errs["BN buffers after a train forward"] = max(
        rel_to_cpu(cb[k], pb[k]) for k in pb)
    # one Momentum step through TrainStep at 32 x 32, batch 2, with the
    # batch norms in inference mode: there the gradient is continuous in
    # the inputs' rounding (with batch statistics, a ReLU input rounded to
    # the other side of 0 moves a whole channel's gradient:
    # tests/test_torch_resnet.py)
    xs, ys = x[:2, :, :32, :32].contiguous(), y[:2]
    for m in (cpu, card):
        m.eval()
        step = TrainStep(m, lambda mm, a, b: F.cross_entropy(mm(a), b),
                         topt.Momentum(RESNET_LR,
                                       parameters=m.parameters(),
                                       use_nesterov=True,
                                       **RESNET_MOMENTUM))
        dev = next(m.parameters()).device
        step(xs.to(dev), ys.to(dev))
    cs, ps = card.state_dict(), cpu.state_dict()
    errs["one Momentum step, parameters"] = max(
        rel_to_cpu(cs[k], ps[k]) for k in ps)
    for k, v in errs.items():
        log(f"card vs CPU, ResNet-50 (10 classes, 64 x 64, batch 8): {k} "
            f"{v:.2e} (rtol {CARD_CPU_RTOL:.0e})")
    bad = {k: v for k, v in errs.items() if not v <= CARD_CPU_RTOL}

    gen = torch.Generator().manual_seed(SEED + 31)
    sweep = 0.0
    for name, (op, xs_, ws, kw) in OP_CASES.items():
        args = [torch.randn(xs_, generator=gen)]
        if ws is not None:
            args.append(0.3 * torch.randn(ws, generator=gen))
        fn = getattr(F, op)
        outs = {}
        for dev in ("cpu", DEVICE):
            ts = [a.to(dev).requires_grad_(True) for a in args]
            out = fn(*ts, **kw)
            cot = torch.ones_like(out) + 0.1 * torch.arange(
                out.numel(), device=dev, dtype=out.dtype).reshape(
                out.shape).sin()
            outs[dev] = [out.detach()] + list(torch.autograd.grad(out, ts,
                                                                  cot))
        worst = max(rel_to_cpu(c, p)
                    for c, p in zip(outs[DEVICE], outs["cpu"]))
        sweep = max(sweep, worst)
        if not worst <= OP_SWEEP_RTOL:
            bad[f"op {name}"] = worst
    log(f"op sweep card vs CPU ({len(OP_CASES)} conv / transpose / max / "
        f"avg cases, forward and gradients): worst {sweep:.2e} (rtol "
        f"{OP_SWEEP_RTOL:.0e}); phase {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"card and CPU differ: {bad}")
    errs["op sweep"] = sweep
    del cpu, card
    torch.cuda.empty_cache()
    return errs


def phases_vision(smi, peaks):
    """Phases 27-30; returns the ``vision`` JSON line's numbers."""
    t0 = time.perf_counter()
    batch = resnet_batch()
    # cuDNN picks its algorithms by timing them once per shape (the first
    # step pays it); TF32 stays off
    torch.backends.cudnn.benchmark = True
    try:
        f32 = run_resnet(smi, peaks, None, batch, 27)
        t1 = time.perf_counter()
        o1 = run_resnet(smi, peaks, "O1", batch, "28 (O1)", f32)
        o2 = run_resnet(smi, peaks, "O2", batch, "28 (O2)", f32)
        log(f"phase 28: {time.perf_counter() - t1:.1f} s")
        del batch
        torch.cuda.empty_cache()
        hapi = phase_resnet_hapi(smi, f32["images_per_s"])
    finally:
        torch.backends.cudnn.benchmark = False
    card_cpu = phase_card_vs_cpu(smi)
    log(f"phases 27-30: {time.perf_counter() - t0:.1f} s")
    slim = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k not in ("step_ms_all", "card")}
    return {"resnet50": {"f32": slim(f32), "O1": slim(o1), "O2": slim(o2),
                         "hapi": {k: v for k, v in hapi.items()
                                  if k != "card"},
                         "card_vs_cpu_rel_err": card_cpu,
                         "card": smi}}


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
    encoders, enc_timed, enc_lockstep = phases_encoders(fa, smi, peaks)
    vision = phases_vision(smi, peaks)
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
    # the same three kernels at the encoders' shapes (phase 26), with the
    # launches of the phases that ran them there: K1 in phase 23's evaluate
    # and predict, K2a / K2b in phase 24 (fit's attention is dense at
    # dropout 0.1); BERT's in phase 25's f32 run
    ernie_fwd = (encoders["ernie_finetune"]["eval_launches_fwd"]
                 + encoders["ernie_finetune"]["predict_launches_fwd"])
    bert_f32 = encoders["bert_mlm"]["f32"]["launches"]
    for shape, launches in (
            (f"ERNIE B={ERNIE_BATCH} T={ERNIE_SEQ} H=12 D=64 padded",
             {"fwd": ernie_fwd, "dq": enc_lockstep["dq"],
              "dkv": enc_lockstep["dkv"]}),
            (f"BERT B={BERT_BATCH} T={BERT_SEQ} H=12 D=64 padded",
             bert_f32)):
        rows_by = enc_timed["ernie" if shape.startswith("ERNIE") else "bert"]
        for kind, kernel in (("fwd", "flash_attention_fwd"),
                             ("dq", "flash_attention_bwd_dq"),
                             ("dkv", "flash_attention_bwd_dkv")):
            r = rows_by[(kind, torch.float32)]
            kernels.append(dict(
                row(kernel, "paddle_tpu_torch/ops/cuda/flash_attention.cu",
                    FLASH_REPLACES[kind], launches[kind],
                    max(flash_err[kind], r["max_abs_err"]), r),
                shape=shape, bf16_ms=rows_by[(kind, torch.bfloat16)]["ms"]))
    for kind, kernel, call, outs in (
            ("fwd", "grouped_matmul_fwd", "up fwd", ("out", "dlhs")),
            ("drhs", "grouped_matmul_drhs", "up drhs", ("drhs",))):
        r = gmm_timed[call]
        kernels.append(row(
            kernel, "paddle_tpu_torch/ops/cuda/grouped_matmul.cu",
            GMM_REPLACES[kind], moe_trained["launches"][kind],
            max(r["max_abs_err"], *(gmm_err[o][0] for o in outs)), r))
    log(json.dumps({"amp": amp_runs}))
    log(json.dumps({"encoders": encoders}))
    log(json.dumps({"vision": vision}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
