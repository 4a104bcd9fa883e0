#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final line):

1. environment: card name and power limit (nvidia-smi), torch / CUDA
   versions, compute capability 9.0 required, TF32 off;
2. build the hand-written kernels from the sources in the checkout;
3. kernel vs plain version: paged attention over f32 / bf16 / int8 pools,
   T in {1, 5, 256 (S=1)}, G in {1, 4}, D in {64, 128}; then its time at
   the serving path's shapes beside the plain version, one PyTorch library
   call (scaled_dot_product_attention over pre-gathered K/V) and the
   card's bound;
4. serving at full width: GPT-3 1.3B (24 layers, random weights from a
   seed) through ``DecodeEngine`` — 8 greedy requests, paged bf16 KV,
   prefix sharing, prompt-lookup speculation — with the kernel's launch
   count checked against the layers x programs run, and the token streams
   checked against the same run on the plain attention;
5. kernel vs plain through the engine at depth 2, f32 and int8 KV, in
   lockstep: per-step logits compared, greedy streams equal;
6. a ``kernels`` JSON line, then the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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
# published peaks (NVIDIA data sheets): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
CARD_PEAKS = {"SXM": (3.35e12, 67e12), "PCIe": (2.0e12, 51e12),
              "NVL": (3.9e12, 60e12)}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def card_peaks(name: str):
    """(form factor, HBM bytes/s, f32 FLOP/s) of the card named."""
    for form in ("PCIe", "NVL"):
        if form in name:
            return (form, *CARD_PEAKS[form])
    return ("SXM", *CARD_PEAKS["SXM"])


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
    """(ms, 'bytes'|'operations') the card needs at least for this call:
    each input byte the call needs read once (the live keys of each slot,
    not whole page slots), the output written once; QK and PV as f32
    FLOPs over the peak outside the tensor cores."""
    _, bw, f32_peak = peaks
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
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_sweep(pa):
    rng = np.random.default_rng(SEED)
    worst = 0.0
    log("# phase 3: kernel vs plain (P=16, MP=64, Hkv=4, atol "
        f"{KERNEL_ATOL})")
    for kv in ("f32", "bf16", "int8"):
        for s, t in ((8, 1), (8, 5), (1, 256)):
            for group in (1, 4):
                for d in (64, 128):
                    c = make_case(rng, s=s, t=t, hkv=4, group=group, d=d,
                                  kv=kv)
                    args, kw = case_args(c)
                    got = pa.paged_attention(*args, **kw)
                    ref = pa.paged_attention_plain(*args, **kw)
                    torch.cuda.synchronize()
                    err = (got - ref).abs().max().item()
                    worst = max(worst, err)
                    log(f"kv={kv:4s} S={s} T={t:3d} G={group} D={d:3d} "
                        f"max_abs_err={err:.3e}")
                    if not err <= KERNEL_ATOL:
                        raise AssertionError(
                            f"kernel disagrees with plain: {err} > "
                            f"{KERNEL_ATOL}")
    return worst


def time_main_shapes(pa, peaks, contexts):
    """The kernel at the serving path's shapes (GPT-3 1.3B: H=Hkv=16,
    D=128, bf16 pool, P=16, MP=64): decode (S=8, T=1), verify (S=8, T=5)
    and the 600-token prompt's tail prefill (S=1, T=1024 bucket). Four
    pool copies are cycled so each launch finds a cold L2."""
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

        got = pa.paged_attention(*calls[0][0], **calls[0][1])
        ref = pa.paged_attention_plain(*calls[0][0], **calls[0][1])
        err = (got - ref).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name}: kernel disagrees, {err}")
        qh, kh, vh, mask = gathered_for_library(c)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = cuda_ms(run(pa.paged_attention))
        plain_ms = cuda_ms(run(pa.paged_attention_plain))
        library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask))
        bound_ms, bound_by = bound(c, peaks)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        log(f"{name:8s} S={sh['s']} T={sh['t']:4d}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), max_abs_err {err:.3e}")
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

    pa.launches = 0
    t0 = time.perf_counter()
    outs = serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches

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
        f"{launches} = {layers} x {programs}  [{smi}]")

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
    return dict(launches=launches, contexts=contexts)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
    log(f"bounds use the H100 {peaks[0]} peaks: {peaks[1] / 1e12} TB/s HBM, "
        f"{peaks[2] / 1e12} TFLOP/s f32")

    t0 = time.perf_counter()
    build.library()
    log(f"# phase 2: kernels built in {time.perf_counter() - t0:.2f} s "
        "(set-up)")

    sweep_err = phase_kernel_sweep(pa)
    served = phase_serving(pa, smi)
    timed = time_main_shapes(pa, peaks, served["contexts"])
    phase_engine_parity()

    dec = timed["decode"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:81",
        "launches": served["launches"],
        "max_abs_err": max(sweep_err, *(r["max_abs_err"]
                                        for r in timed.values())),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
