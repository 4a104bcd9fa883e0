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
   widths, each beside its plain version, one dense ``torch.matmul`` of
   the same FLOPs, a grouped library call (``torch._grouped_mm`` where it
   takes the dtype, else a per-expert ``torch.mm`` loop, labelled) and
   the card's bound;
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
13. a ``kernels`` JSON line, then the result line.
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


def time_main_shapes(pa, peaks, contexts):
    """The kernel at the serving path's shapes (GPT-3 1.3B: H=Hkv=16,
    D=128, bf16 pool, P=16, MP=64): decode (S=8, T=1) and verify (S=8,
    T=5) in the split regime, the 600-token prompt's tail prefill (S=1,
    T=1024 bucket) in the tile regime. Four pool copies are cycled so each
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
        c = make_case(rng, hkv=16, group=1, d=128, kv="bf16", layers=4,
                      **sh)
        calls = [case_args(c, layer) for layer in range(4)]
        state = {"i": 0}

        def run(fn):
            def go():
                args, kw = calls[state["i"] % 4]
                state["i"] += 1
                return fn(*args, **kw)
            return go

        expect = pa._k3_regime(sh["t"], 1)
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
        log(f"{name:8s} S={sh['s']} T={sh['t']:4d} [{expect}]: kernel "
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


def build_model(layers):
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b(num_hidden_layers=layers,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    return GPTForCausalLM(cfg, device=DEVICE, seed=SEED)


def serve(engine, prompts):
    rids = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    engine.run()
    return [engine.result(r) for r in rids]


def phase_serving(pa, smi):
    from paddle_tpu_torch.inference.engine import DecodeEngine

    t0 = time.perf_counter()
    model = build_model(24)
    torch.cuda.synchronize()
    log(f"# phase 4: GPT-3 1.3B built on the card in "
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
    layers = model.config.num_hidden_layers
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
    # every prefill in the tile regime, every decode (T = 1) and verify
    # (T = k + 1) step in the split regime
    want = (layers * st["prefill_calls"],
            layers * (st["decode_steps"] - st["verify_steps"]),
            layers * st["verify_steps"])
    if (tile, decode, verify) != want:
        raise AssertionError(
            f"launches (tile, decode, verify) = {(tile, decode, verify)}, "
            f"expected {want}: {layers} x ({st['prefill_calls']} prefills, "
            f"{st['decode_steps']} steps of which {st['verify_steps']} "
            "verify)")
    tensors = [*model.parameters(), eng._kc, eng._vc]
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
        f"{launches} = {layers} x {programs} (tile {tile}, split {split}: "
        f"decode {decode}, verify {verify})  [{smi}]")

    plain = DecodeEngine(model, kv_dtype="bf16", attn_kernel="plain",
                         **engine_config())
    ref = serve(plain, prompts)
    same = sum(np.array_equal(a, b) for a, b in zip(outs, ref))
    log(f"full-width greedy streams equal to the plain-attention run: "
        f"{same}/{len(prompts)}")
    if same != len(prompts):
        raise AssertionError("full-width streams differ from plain")
    contexts = [len(p) + NEW_TOKENS // 2 for p in prompts]
    del eng, plain, model
    torch.cuda.empty_cache()
    return dict(contexts=contexts,
                by_shape={"prefill": tile, "decode": decode,
                          "verify": verify})


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


def phase_engine_parity():
    from paddle_tpu_torch.inference.engine import DecodeEngine

    model = build_model(2)
    prompts = make_prompts(model.config.vocab_size)
    for kv in ("f32", "int8"):
        a = DecodeEngine(model, kv_dtype=kv, **engine_config())
        b = DecodeEngine(model, kv_dtype=kv, attn_kernel="plain",
                         **engine_config())
        worst, mismatches, steps = lockstep(a, b, prompts)
        log(f"# phase 5: depth 2, kv {kv}: {steps} steps, max |logit "
            f"kernel - plain| {worst:.3e} (atol {ENGINE_LOGIT_ATOL[kv]}), "
            f"token mismatches {mismatches}")
        if not worst <= ENGINE_LOGIT_ATOL[kv]:
            raise AssertionError(f"logits differ by {worst}")
        if mismatches:
            raise AssertionError("greedy streams differ")


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


def phase_flash_timing(fa, peaks):
    """K1, K2a, K2b at the training shapes, q/k/v strided out of one fused
    projection as in the model. K1 is timed in turns with SDPA's forward
    (K1, SDPA, SDPA, K1) and the pair K2a + K2b in turns with SDPA's
    backward (dq + dk + dv), each averaged; K2a and K2b also alone."""
    from torch.nn.attention import sdpa_kernel

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    b, t, h, d = TRAIN_BATCH, TRAIN_SEQ, 16, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_inputs(gen, b, t, t, h, h, d, dt, True)
        worst = {}
        compare_flash(fa, q, k, v, do, None, True, False, worst,
                      f"training shape {str(dt)[6:]}")
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

        qh, kh, vh = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        be = sdpa_backend(qh, kh, vh, is_causal=True)
        with sdpa_kernel([be]):
            def lib():
                return sdpa(qh, kh, vh, is_causal=True)
            turns = [cuda_ms(calls["fwd"][0]), cuda_ms(lib), cuda_ms(lib),
                     cuda_ms(calls["fwd"][0])]
            lib_fwd = (turns[1] + turns[2]) / 2
            out = sdpa(qh, kh, vh, is_causal=True)
            doh = do.transpose(1, 2)

            def lib_bwd_call():
                return torch.autograd.grad(out, (qh, kh, vh), doh,
                                           retain_graph=True)
            bturns = [cuda_ms(pair), cuda_ms(lib_bwd_call),
                      cuda_ms(lib_bwd_call), cuda_ms(pair)]
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
            log(f"{kind:3s} {str(dt)[6:]:8s} B={b} T={t} H={h} D={d} causal:"
                f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
                f"[{be.name}] {lib:.4f} ms"
                + (f" (turns K1 {turns[0]:.4f}, sdpa {turns[1]:.4f}, "
                   f"{turns[2]:.4f}, K1 {turns[3]:.4f})" if kind == "fwd"
                   else "")
                + f", {bound_text(rows[(kind, dt)], ms)}")
        pb = {k_: rows[("dq", dt)][k_] + rows[("dkv", dt)][k_]
              for k_ in ("bound_ms", "bound_fma_ms")}
        log(f"pair {str(dt)[6:]:8s} K2a + K2b {pair_ms:.4f} ms vs sdpa "
            f"backward [{be.name}] {lib_bwd:.4f} ms = "
            f"{pair_ms / lib_bwd:.3f}x (turns pair {bturns[0]:.4f}, sdpa "
            f"{bturns[1]:.4f}, {bturns[2]:.4f}, pair {bturns[3]:.4f}); "
            f"bound {pb['bound_ms']:.4f} ms (tensor cores), "
            f"{pb['bound_fma_ms']:.4f} ms (f32 FMA), "
            f"{100 * pb['bound_ms'] / pair_ms:.1f} % of bound")
        del q, k, v, do, o, lse, delta, qh, kh, vh, out
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


def trainer(model):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **ADAMW)
    return TrainStep(model, lambda m, ids, lab: m(ids, labels=lab), opt), opt


def phase_training(fa, smi):
    t0 = time.perf_counter()
    model = build_model(24)
    step, opt = trainer(model)
    ids, labels = train_batch(model.config.vocab_size)
    with plain_attention(fa), torch.no_grad():
        plain_loss = float(model(ids, labels=labels))
    torch.cuda.synchronize()
    log(f"# phase 7: GPT-3 1.3B built and a no-grad plain-attention loss "
        f"taken in {time.perf_counter() - t0:.2f} s (set-up)")
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


def phase_train_lockstep(fa):
    a = build_model(2)
    b = build_model(2).load_numpy_state(
        {n: x.detach().cpu().numpy() for n, x in a.state_dict().items()})
    step_a, _ = trainer(a)
    step_b, _ = trainer(b)
    ids, labels = train_batch(a.config.vocab_size)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        la = float(step_a(ids, labels))
        with plain_attention(fa):
            lb = float(step_b(ids, labels))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"# phase 8: depth 2 step {i}: loss kernel {la:.7f} plain "
            f"{lb:.7f} rel {rel:.2e}")
    bound = 2 * ADAMW["learning_rate"] * LOCKSTEP_STEPS
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


def phase_gmm_timing(gm, peaks):
    """The five grouped matmuls of one MoE training step at the Mixtral
    widths (f32, the training path's dtype), and the up projection in
    bf16."""
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    m, d, f, e = (MOE_TOP_K * TRAIN_BATCH * TRAIN_SEQ, MOE_DIM, MOE_HIDDEN,
                  MOE_EXPERTS)
    host = dirichlet_sizes(rng, m, e)
    sizes = torch.as_tensor(host, dtype=torch.int32, device=DEVICE)
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    log(f"# phase 10: grouped matmuls of one MoE step, M={m} routed rows, "
        f"dim {d}, hidden {f}, {e} experts, sizes {host.tolist()}")

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                * scale).to(dtype)

    x, a = rand(m, d), rand(m, f)
    w_in, w_out = rand(e, d, f, scale=d ** -0.5), rand(e, f, d,
                                                       scale=f ** -0.5)
    dh, dy = rand(m, f), rand(m, d)
    calls = (("up fwd", "fwd", x, w_in), ("down fwd", "fwd", a, w_out),
             ("down dlhs", "fwd", dy, w_out.transpose(1, 2)),
             ("up drhs", "drhs", x, dh), ("down drhs", "drhs", a, dy))
    xb, wb = x.bfloat16(), w_in.bfloat16()
    calls += (("up fwd bf16", "fwd", xb, wb),)
    rows = {}
    for name, kind, lhs, other in calls:
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
        plain_ms = cuda_ms(lambda: plain(lhs, other, sizes), iters=3,
                           warm=1)
        if kind == "fwd":
            dense_ms = cuda_ms(lambda: torch.matmul(lhs, other[0]), iters=10,
                               warm=2)
        else:
            dense_ms = cuda_ms(lambda: torch.matmul(lhs.T, other), iters=10,
                               warm=2)
        lib, lib_label = grouped_library(kind, lhs, other, host, ends)
        lib_ms = cuda_ms(lib, iters=5, warm=1)
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, dense_ms=dense_ms, max_abs_err=err,
            library_ms=lib_ms if lib_label == "torch._grouped_mm" else None,
            **gmm_bound(kind, lhs, other, host, peaks))
        log(f"{name:11s} [{lhs.shape[0]}x{lhs.shape[1]}] {kind:4s}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, dense torch.matmul "
            f"{dense_ms:.4f} ms, {lib_label} {lib_ms:.4f} ms, "
            f"{bound_text(rows[name], ms)}, rel err {rel:.1e}")
    del x, a, w_in, w_out, dh, dy, xb, wb, calls
    torch.cuda.empty_cache()
    return rows


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
    served = phase_serving(pa, smi)
    timed = time_main_shapes(pa, peaks, served["contexts"])
    phase_engine_parity()
    flash_timed = phase_flash_timing(fa, peaks)
    trained = phase_training(fa, smi)
    phase_train_lockstep(fa)
    gmm_err = phase_gmm_sweep(gm)
    gmm_timed = phase_gmm_timing(gm, peaks)
    moe_trained = phase_moe_training(gm, smi)
    phase_moe_lockstep(gm)

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
            served["by_shape"][shape],
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
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
