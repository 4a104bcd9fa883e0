#!/usr/bin/env python3
"""Accuracy control for the TF32 split of the tensor-core attention tile.

    python3 scripts/tf32_one_pass_control.py

The attention tile (``paddle_tpu_torch/ops/cuda/attention_tile.cuh``)
computes an f32-accurate product as 3 TF32 products (2 where one operand
is exact in TF32). This script builds ``paged_attention.cu`` and
``flash_attention.cu`` a second time with ``-DATTN_TILE_ONE_PASS``, where
the tile takes one TF32 product instead, and runs ``chip_smoke.py``'s
kernel-vs-plain checks on both builds, at the tolerances ``chip_smoke.py``
holds the kernels to:

- K3: the phase-3 sweep (f32 / bf16 / int8 pools, both regimes), max|err|
  against ``KERNEL_ATOL`` (absolute); the split regime runs on f32 FMAs in
  both builds and is the control's control;
- K1: the f32 forward over ``FLASH_CASES`` and at the training shape
  (B=2, T=2048, H=16, D=128, causal), max|err| / max|ref| of o against
  ``FLASH_TOL``.

It prints each build's worst error per kernel, then one JSON line, and
exits non-zero unless the split build passes every tolerance and the
one-pass build fails the tile kernels': a tolerance that let one TF32
pass through would not show that the split is needed. Needs one CUDA card
of compute capability 9.0 and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops.cuda import build  # noqa: E402

SOURCES = ("paged_attention.cu", "flash_attention.cu")
ENTRIES = ("paddle_paged_attention", "paddle_flash_attention_fwd")


def one_pass_library() -> ctypes.CDLL:
    """K3 and K1 built with one TF32 product per f32-accurate one."""
    out_dir = build.BUILD_DIR / "one_pass"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs = [out_dir / f"{Path(s).stem}.o" for s in SOURCES]
    build._run_all([[nvcc, *build.NVCC_FLAGS, "-DATTN_TILE_ONE_PASS",
                     "-Xcompiler", "-fPIC", "-c", str(build._DIR / s), "-o",
                     str(o)] for s, o in zip(SOURCES, objs)])
    so = out_dir / "libone_pass.so"
    build._run_all([[nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(so),
                     *map(str, objs)]])
    lib = ctypes.CDLL(str(so))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build._SIGNATURES[name]
    return lib


def k1_worst() -> float:
    """Worst max|err| / max|ref| of K1's f32 o over FLASH_CASES and the
    training shape."""
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 2)
    inputs = [cs.flash_case(fa, gen, case) for case in cs.FLASH_CASES]
    q, k, v, _ = cs.flash_inputs(gen, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                 cs.TRAIN_SEQ, 16, 16, 128, torch.float32,
                                 True)
    inputs.append((q, k, v, None, None, True, False, "training shape"))
    worst = 0.0
    for q, k, v, _, bias, causal, _, tag in inputs:
        if q.dtype != torch.float32:
            continue
        o, _ = fa.flash_attention_forward_cuda(q, k, v, bias, causal=causal)
        o_p, _ = fa.flash_attention_forward_plain(q, k, v, bias,
                                                  causal=causal)
        _, rel = cs._rel(o, o_p)
        cs.log(f"K1 {tag}: o rel err {rel:.3e}")
        worst = max(worst, rel)
    return worst


def run(label: str) -> dict:
    cs.log(f"# build: {label}")
    k3 = cs.phase_kernel_sweep(pa, atol=math.inf)
    res = {"k3_tile": k3["tile"], "k3_split": k3["split"], "k1": k1_worst()}
    cs.log(f"{label}: K3 tile {res['k3_tile']:.3e}, K3 split "
           f"{res['k3_split']:.3e} (KERNEL_ATOL {cs.KERNEL_ATOL}); K1 f32 o "
           f"{res['k1']:.3e} (FLASH_TOL {cs.FLASH_TOL[torch.float32]})")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_one_pass_control: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    cs.log(smi)
    build.library()
    split = run("TF32 split (as shipped)")
    one_pass_lib = one_pass_library()
    build._lib = one_pass_lib  # the wrappers now launch the one-pass build
    one = run("one TF32 pass (control)")
    k3_tol, k1_tol = cs.KERNEL_ATOL, cs.FLASH_TOL[torch.float32]
    ok = (split["k3_tile"] <= k3_tol and split["k3_split"] <= k3_tol
          and split["k1"] <= k1_tol and one["k3_tile"] > k3_tol
          and one["k1"] > k1_tol)
    cs.log(smi)
    cs.log(json.dumps({"split": split, "one_pass": one, "k3_atol": k3_tol,
                       "k1_rtol": k1_tol, "one_pass_rejected": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
