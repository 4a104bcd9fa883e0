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
    python3 scripts/profile_torch.py ernie [--out profile_out] [--steps 2]
    python3 scripts/profile_torch.py bert  [--out profile_out] [--steps 2]
    python3 scripts/profile_torch.py bert_amp [--out profile_out]
    python3 scripts/profile_torch.py resnet [--out profile_out] [--steps 2]
    python3 scripts/profile_torch.py resnet_amp [--out profile_out]
    python3 scripts/profile_torch.py generate [--out profile_out]
    python3 scripts/profile_torch.py llama_generate [--out profile_out]

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
+ cosine learning rate). ``ernie`` drives phase 23's fine-tune step
(ERNIE-3.0-base, ``Model.train_batch`` on one 32 x 128 batch of its
padded sentence pairs, dropouts 0.1: the attention takes the dense route).
``bert`` and ``bert_amp`` drive phase 25 (BERT-base masked LM, 8 x 512,
``TrainStep`` + AdamW; in f32 and under ``auto_cast(level="O1")``).
``resnet`` and ``resnet_amp`` drive phases 27 and 28 (ResNet-50, batch
256 at 224 x 224, ``TrainStep`` + Momentum; in f32 and after
``decorate(level="O2")`` under ``auto_cast(level="O2")``, cuDNN's
algorithm search on as there), then profile ``Momentum.step`` alone on
gradients left by one more backward (``momentum_step_ms``).
``generate`` and ``llama_generate`` drive the KV-cached ``model.generate``
of phases 31 and 32 (GPT-3 1.3B, 4 x 128 prompt tokens, 64 new;
Llama-3-8B, 2 x 64, 32 new; greedy): one warm run, then one under the
profiler.

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
    # cuDNN's convolutions (its kernels name the pass: fprop / dgrad /
    # wgrad) and batch norms, before the matmul names they share (xmma)
    for frag, fam in (("wgrad", "conv_wgrad"), ("dgrad", "conv_dgrad"),
                      ("fprop", "conv_fprop"), ("convolve", "conv_fprop"),
                      ("winograd", "conv_other"), ("conv", "conv_other"),
                      ("batch_norm", "batch_norm"), ("bn_", "batch_norm"),
                      ("max_pool", "pool"), ("avg_pool", "pool"),
                      ("adaptive", "pool")):
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


def generate(build, cell):
    model = build()
    prompts = chip_smoke.gen_prompts(model.config.vocab_size,
                                     cell["prompts"], cell["prompt_len"])
    model.generate(prompts, cell["new"])  # warm
    prof, wall = profiled(lambda: model.generate(prompts, cell["new"]))
    return prof, wall, 1, {"tokens": cell["prompts"] * cell["new"],
                           "steps": cell["new"]}


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


def ernie(steps):
    from paddle_tpu_torch.io import DataLoader

    net = chip_smoke.build_ernie()
    model = chip_smoke.ernie_model(net, 1000)
    data = chip_smoke.PairData(chip_smoke.ERNIE_BATCH, net.config.vocab_size,
                               chip_smoke.ERNIE_SEQ, chip_smoke.SEED + 20)
    *xs, ys = next(iter(DataLoader(data, batch_size=chip_smoke.ERNIE_BATCH,
                                   device=chip_smoke.DEVICE)))
    prof, wall, n, extra = profiled_steps(
        lambda *b: model.train_batch(b[:-1], b[-1]), (*xs, ys), steps,
        xs[0].numel())
    extra["real_tokens_per_step"] = int(xs[2].sum())
    return prof, wall, n, extra


def bert(steps, level):
    step, batch, real = chip_smoke.bert_trainer(level)
    prof, wall, n, extra = profiled_steps(step, batch, steps,
                                          batch[0].numel())
    extra["real_tokens_per_step"] = real
    return prof, wall, n, extra


def resnet(steps, level):
    """Phase 27 / 28's step under the profiler, then ``Momentum.step``
    alone on the gradients of one more forward and backward."""
    torch.backends.cudnn.benchmark = True
    model = chip_smoke.build_resnet()
    step = chip_smoke.resnet_trainer(model, level)
    batch = chip_smoke.resnet_batch()
    prof, wall, n, extra = profiled_steps(step, batch, steps,
                                          chip_smoke.RESNET_BATCH)
    opt = step._opt
    params = [p for p in opt._parameter_list if p.requires_grad]
    grads = torch.autograd.grad(step._loss_fn(model, *batch), params)
    for p, g in zip(params, grads):
        p.grad = g
    busy, launches = chip_smoke.device_busy_ms(opt.step)
    extra.update(images_per_step=chip_smoke.RESNET_BATCH,
                 momentum_step_ms=busy, momentum_launches=launches)
    return prof, wall, n, extra


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", choices=("serving", "training", "moe",
                                     "llama_serving", "llama_training",
                                     "training_amp", "llama_training_amp",
                                     "ernie", "bert", "bert_amp", "resnet",
                                     "resnet_amp", "generate",
                                     "llama_generate"))
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
    elif args.path == "generate":
        prof, wall, n, extra = generate(gpt, chip_smoke.GEN_GPT)
    elif args.path == "llama_generate":
        prof, wall, n, extra = generate(lambda: llama(layers),
                                        chip_smoke.GEN_LLAMA)
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
    elif args.path == "ernie":
        prof, wall, n, extra = ernie(args.steps)
    elif args.path in ("bert", "bert_amp"):
        prof, wall, n, extra = bert(args.steps, "O1" if args.path ==
                                    "bert_amp" else None)
    elif args.path in ("resnet", "resnet_amp"):
        prof, wall, n, extra = resnet(args.steps, "O2" if args.path ==
                                      "resnet_amp" else None)
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
