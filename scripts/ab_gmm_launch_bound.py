#!/usr/bin/env python3
"""The grouped-matmul kernels with and without a two-blocks-per-SM launch
bound, timed in one process on one CUDA card.

    python3 scripts/ab_gmm_launch_bound.py

Builds ``paddle_tpu_torch/ops/cuda/grouped_matmul.cu`` twice into
``paddle_tpu_torch/ops/cuda/_build/ab/``: ``unbounded`` with every
``__launch_bounds__`` at one block per SM and ``bounded`` with two (which
caps ptxas at 128 registers a thread), printing each variant's registers
and spills. Then times the five grouped matmuls of one MoE training step
at the Mixtral 8x7B expert shapes (``chip_smoke.py`` phase 10's inputs,
f32) under each variant in the order unbounded, bounded, bounded,
unbounded, checking that both variants give bit-equal results.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops import grouped_matmul as gm  # noqa: E402
from paddle_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = os.path.join(ROOT, "paddle_tpu_torch", "ops", "cuda",
                      "grouped_matmul.cu")
BOUND = re.compile(r"__launch_bounds__\(kThreads(, 2)?\)")


def variant_library(name: str, min_blocks: int) -> ctypes.CDLL:
    """The kernels built with every launch bound set to ``min_blocks``
    blocks per SM; prints ptxas's registers and spills."""
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    bound = ("__launch_bounds__(kThreads)" if min_blocks == 1
             else f"__launch_bounds__(kThreads, {min_blocks})")
    with open(SOURCE) as f:
        text = BOUND.sub(bound, f.read())
    src = os.path.join(out_dir, f"grouped_matmul_{name}.cu")
    lib_path = os.path.join(out_dir, f"libgmm_{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-Xcompiler", "-fPIC", "-o", lib_path, src],
        capture_output=True, text=True, check=True)
    regs = re.findall(r"Used (\d+) registers", proc.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    print(f"{name}: registers {regs}, spill-store bytes {spills}",
          flush=True)
    lib = ctypes.CDLL(lib_path)
    for fn, (argtypes, restype) in build._SIGNATURES.items():
        if fn.startswith("paddle_grouped_matmul"):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_gmm_launch_bound: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi_line(), flush=True)
    libs = {"unbounded": variant_library("unbounded", 1),
            "bounded": variant_library("bounded", 2)}
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 6)
    m = chip_smoke.MOE_TOP_K * chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ
    d, f, e = chip_smoke.MOE_DIM, chip_smoke.MOE_HIDDEN, chip_smoke.MOE_EXPERTS
    host = chip_smoke.dirichlet_sizes(
        np.random.default_rng(chip_smoke.SEED + 6), m, e)
    sizes = torch.as_tensor(host, dtype=torch.int32, device=dev)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, a = rand(m, d), rand(m, f)
    w_in, w_out = rand(e, d, f, scale=d ** -0.5), rand(e, f, d,
                                                       scale=f ** -0.5)
    dh, dy = rand(m, f), rand(m, d)
    calls = {
        "up fwd": lambda: gm.grouped_matmul_cuda(x, w_in, sizes),
        "down fwd": lambda: gm.grouped_matmul_cuda(a, w_out, sizes),
        "down dlhs": lambda: gm.grouped_matmul_cuda(
            dy, w_out.transpose(1, 2), sizes),
        "up drhs": lambda: gm.grouped_matmul_drhs_cuda(x, dh, sizes),
        "down drhs": lambda: gm.grouped_matmul_drhs_cuda(a, dy, sizes),
    }
    first = {}
    for name in ("unbounded", "bounded", "bounded", "unbounded"):
        build._lib = libs[name]
        line = []
        for call, fn in calls.items():
            out = fn()
            if call in first and not torch.equal(out, first[call]):
                raise AssertionError(f"{name} {call}: results differ")
            first.setdefault(call, out)
            ms = chip_smoke.cuda_ms(fn, iters=10, warm=2)
            line.append(f"{call} {ms:.4f}")
        print(f"{name:9s} ms: " + ", ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
