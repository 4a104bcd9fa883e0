#!/usr/bin/env python3
"""Where the decode time goes: the PyTorch port serving GPT-3 1.3B on one
CUDA card, under ``torch.profiler``.

    python3 scripts/profile_torch_serving.py [--out profile_out]

Drives the same configuration and traffic as ``chip_smoke.py`` phase 4
(8 greedy requests, bf16 paged KV, prefix sharing, speculation k=4):
one warm run, then a fresh engine serves the same requests under the
profiler. Prints one JSON object: wall time of the profiled run, device
busy time (sum of kernel time; the rest of the wall is the device's idle
share), and kernel time grouped by family (paged-attention kernel K3,
matmuls, elementwise / normalisation, indexing / copies, other), with the
top kernels by name. Writes the chrome trace under ``--out``.
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


def family(name: str) -> str:
    n = name.lower()
    if "paged_attention" in n:
        return "paged_attention_k3"
    if "gemm" in n or "gemv" in n or "sgemm" in n or "cutlass" in n:
        return "matmul"
    if "index" in n or "gather" in n or "scatter" in n or "copy" in n:
        return "index_copy"
    if ("elementwise" in n or "norm" in n or "reduce" in n
            or "softmax" in n or "gelu" in n):
        return "elementwise_norm_reduce"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    model = chip_smoke.build_model(24)
    prompts = chip_smoke.make_prompts(model.config.vocab_size)
    warm = DecodeEngine(model, kv_dtype="bf16", **chip_smoke.engine_config())
    warm.warmup()
    chip_smoke.serve(warm, prompts)
    del warm

    eng = DecodeEngine(model, kv_dtype="bf16", **chip_smoke.engine_config())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    groups: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        dev_us = evt.self_device_time_total
        if dev_us <= 0:
            continue
        fam = family(evt.key)
        g = groups.setdefault(fam, {"ms": 0.0, "calls": 0})
        g["ms"] += dev_us / 1e3
        g["calls"] += evt.count
        kernels.append((dev_us / 1e3, evt.count, evt.key))
    busy = sum(g["ms"] for g in groups.values())
    st = eng.stats()
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "serving_trace.json"))
    kernels.sort(reverse=True)
    print(json.dumps({
        "card": smi,
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
        "prefill_calls": st["prefill_calls"],
        "decode_steps": st["decode_steps"],
        "verify_steps": st["verify_steps"],
        "tokens": st["total_tokens"],
        "by_family_ms": {k: round(v["ms"], 3) for k, v in groups.items()},
        "by_family_calls": {k: v["calls"] for k, v in groups.items()},
        "top_kernels": [{"ms": round(ms, 3), "calls": n, "name": name[:90]}
                        for ms, n, name in kernels[:12]],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
