#!/usr/bin/env python3
"""Where the device time goes: the PyTorch port on one CUDA card, under
``torch.profiler``.

    python3 scripts/profile_torch.py serving  [--out profile_out]
    python3 scripts/profile_torch.py training [--out profile_out] [--steps 2]
    python3 scripts/profile_torch.py moe      [--out profile_out] [--steps 2]
    python3 scripts/profile_torch.py llama_serving  [--out profile_out]
    python3 scripts/profile_torch.py llama_training [--out profile_out]
    python3 scripts/profile_torch.py training_amp [--out profile_out]
    python3 scripts/profile_torch.py llama_training_amp [--out profile_out]

``serving`` drives the configuration and traffic of ``chip_smoke.py``
phase 4 (GPT-3 1.3B, 8 greedy requests, bf16 paged KV, prefix sharing,
speculation k=4): one warm run, then a fresh engine serves the same
requests under the profiler. ``training`` drives phase 7 (GPT-3 1.3B,
``TrainStep`` + ``AdamW``, one 2 x 2048-token batch): one warm step, then
``--steps`` steps under the profiler. ``moe`` drives phase 11 (Mixtral
8x7B's MoE block, dropless, under a ``Linear(4096, 1)`` head, ``TrainStep``
+ ``AdamW``, one 2 x 2048-token batch) the same way. ``llama_serving``
and ``llama_training`` do the same for phases 13 and 16: Llama-3-8B at
full width, 32 layers served, 4 layers trained (Touvron et al. AdamW).
``training_amp`` and ``llama_training_amp`` drive phases 18 and 21: the
same trainers under ``auto_cast(level="O1")`` (GPT with phase 18's warmup
+ cosine learning rate).

Prints one JSON object: wall time of the profiled run, device busy time
(sum of kernel time; the rest of the wall is the device's idle share),
and kernel time grouped by family (the port's own kernels by name,
matmuls, elementwise / normalisation / reductions, indexing / copies,
other), with the top kernels by name. Writes the chrome trace under
``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

#: kernel-name fragment -> family of the port's hand-written kernels
OWN_KERNELS = {"paged_tile_kernel": "paged_attention_k3_tile",
               "paged_split_kernel": "paged_attention_k3_split",
               "paged_merge_kernel": "paged_attention_k3_split",
               "flash_fwd_kernel": "flash_fwd_k1",
               "flash_bwd_dq_kernel": "flash_bwd_dq_k2a",
               "flash_bwd_dkv_kernel": "flash_bwd_dkv_k2b",
               "gmm_fwd_kernel": "grouped_matmul_fwd_k4a",
               "gmm_drhs_kernel": "grouped_matmul_drhs_k4b"}


def family(name: str) -> str:
    n = name.lower()
    for frag, fam in OWN_KERNELS.items():
        if frag in n:
            return fam
    # cuBLAS's Hopper kernels are named nvjet_* or *xmma*, CUTLASS's
    # cutlass_*
    if any(f in n for f in ("gemm", "gemv", "cutlass", "nvjet", "xmma")):
        return "matmul"
    if "index" in n or "gather" in n or "scatter" in n or "copy" in n:
        return "index_copy"
    if ("elementwise" in n or "norm" in n or "reduce" in n
            or "softmax" in n or "gelu" in n or "silu" in n):
        return "elementwise_norm_reduce"
    return "other"


def profiled(run):
    """(profiler, wall seconds) of ``run()`` ended by a device sync."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def serving(build):
    from paddle_tpu_torch.inference.engine import DecodeEngine

    model = build()
    prompts = chip_smoke.make_prompts(model.config.vocab_size)
    warm = DecodeEngine(model, kv_dtype="bf16", **chip_smoke.engine_config())
    warm.warmup()
    chip_smoke.serve(warm, prompts)
    del warm
    eng = DecodeEngine(model, kv_dtype="bf16", **chip_smoke.engine_config())
    prof, wall = profiled(lambda: chip_smoke.serve(eng, prompts))
    st = eng.stats()
    extra = {k: st[k] for k in ("prefill_calls", "decode_steps",
                                "verify_steps")}
    extra["tokens"] = st["total_tokens"]
    return prof, wall, 1, extra


def profiled_steps(step, batch, steps, tokens):
    step(*batch)  # warm: cuBLAS handles, allocator, kernel build

    def run():
        for _ in range(steps):
            step(*batch)

    prof, wall = profiled(run)
    return prof, wall, steps, {"tokens_per_step": tokens}


def training(steps, build, adamw):
    model = build()
    step, _ = chip_smoke.trainer(model, adamw)
    ids, labels = chip_smoke.train_batch(model.config.vocab_size)
    return profiled_steps(step, (ids, labels), steps, ids.numel())


def training_amp(steps, build, adamw, schedule):
    model = build()
    step, _, _ = chip_smoke.amp_trainer(model, adamw, "O1", schedule)
    ids, labels = chip_smoke.train_batch(model.config.vocab_size)
    return profiled_steps(step, (ids, labels), steps, ids.numel())


def moe(steps):
    model = chip_smoke.build_moe(chip_smoke.MOE_DIM, chip_smoke.MOE_HIDDEN)
    step, _ = chip_smoke.moe_trainer(model)
    x, y = chip_smoke.moe_batch(chip_smoke.MOE_DIM)
    return profiled_steps(step, (x, y), steps, x.shape[0] * x.shape[1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", choices=("serving", "training", "moe",
                                     "llama_serving", "llama_training",
                                     "training_amp", "llama_training_amp"))
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--steps", type=int, default=2,
                    help="profiled training steps (the training paths "
                         "and moe)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    gpt = lambda: chip_smoke.build_model(24)  # noqa: E731
    llama = chip_smoke.build_llama
    layers = chip_smoke.LLAMA3_8B["num_hidden_layers"]
    if args.path == "serving":
        prof, wall, n, extra = serving(gpt)
    elif args.path == "llama_serving":
        prof, wall, n, extra = serving(lambda: llama(layers))
    elif args.path == "training":
        prof, wall, n, extra = training(args.steps, gpt, chip_smoke.ADAMW)
    elif args.path == "llama_training":
        prof, wall, n, extra = training(
            args.steps, lambda: llama(chip_smoke.LLAMA_TRAIN_LAYERS),
            chip_smoke.LLAMA_ADAMW)
    elif args.path == "training_amp":
        prof, wall, n, extra = training_amp(args.steps, gpt,
                                            chip_smoke.ADAMW, True)
    elif args.path == "llama_training_amp":
        prof, wall, n, extra = training_amp(
            args.steps, lambda: llama(chip_smoke.LLAMA_TRAIN_LAYERS),
            chip_smoke.LLAMA_ADAMW, False)
    else:
        prof, wall, n, extra = moe(args.steps)

    groups: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        dev_us = evt.self_device_time_total
        if dev_us <= 0:
            continue
        g = groups.setdefault(family(evt.key), {"ms": 0.0, "calls": 0})
        g["ms"] += dev_us / 1e3
        g["calls"] += evt.count
        kernels.append((dev_us / 1e3, evt.count, evt.key))
    busy = sum(g["ms"] for g in groups.values())
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"{args.path}_trace.json"))
    kernels.sort(reverse=True)
    # per run (serving) or per step (training, moe: n steps profiled)
    print(json.dumps({
        "card": smi,
        "path": args.path,
        "runs": n,
        "wall_ms": wall * 1e3 / n,
        "device_busy_ms": busy / n,
        "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
        **extra,
        "by_family_ms": {k: round(v["ms"] / n, 3) for k, v in groups.items()},
        "by_family_calls": {k: v["calls"] // n for k, v in groups.items()},
        "top_kernels": [{"ms": round(ms / n, 3), "calls": c // n,
                         "name": name[:90]} for ms, c, name in kernels[:14]],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
