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
  ``FLASH_TOL``;
- K2a / K2b: the f32 backward over the same inputs, both halves given the
  plain forward's o and lse (so K1's build does not enter), max|err| /
  max|ref| of dq against ``FLASH_TOL`` and of dk / dv against 1e-4, the
  tolerances ``chip_smoke.py`` phase 6a holds them to.

It prints each build's worst error per kernel, then one JSON line, and
exits non-zero unless the split build passes every tolerance and the
one-pass build fails each tensor-core kernel's (K3 tile, K1, K2a, K2b): a
tolerance that let one TF32 pass through would not show that the split is
needed. Needs one CUDA card of compute capability 9.0 and ``nvcc``.
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
ENTRIES = ("paddle_paged_attention", "paddle_flash_attention_fwd",
           "paddle_flash_attention_bwd_dq", "paddle_flash_attention_bwd_dkv")
#: dk / dv against their plain versions (chip_smoke.compare_flash)
DKV_TOL = 1e-4


def one_pass_library() -> ctypes.CDLL:
    """K3, K1 and K2 built with one TF32 product per f32-accurate one."""
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


def flash_inputs():
    """The f32 inputs of FLASH_CASES and the training shape: (q, k, v,
    dO, bias, causal, tag)."""
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 2)
    inputs = [cs.flash_case(fa, gen, case) for case in cs.FLASH_CASES]
    inputs.append((*cs.flash_inputs(gen, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                    cs.TRAIN_SEQ, 16, 16, 128,
                                    torch.float32, True),
                   None, True, False, "training shape"))
    return [(q, k, v, do, bias, causal, tag)
            for q, k, v, do, bias, causal, _, tag in inputs
            if q.dtype == torch.float32]


def flash_worst(inputs) -> dict:
    """Worst max|err| / max|ref| over the inputs: K1's o, K2a's dq and
    K2b's dk / dv (the backward halves fed the plain forward's o and lse)."""
    worst = dict.fromkeys(("k1", "k2a", "k2b"), 0.0)
    for q, k, v, do, bias, causal, tag in inputs:
        kw = dict(causal=causal)
        o, _ = fa.flash_attention_forward_cuda(q, k, v, bias, **kw)
        o_p, lse = fa.flash_attention_forward_plain(q, k, v, bias, **kw)
        delta = fa._delta(o_p, do).contiguous()
        args = (q, k, v, bias, do, lse, delta)
        dq, _ = fa.flash_attention_bwd_dq_cuda(*args, **kw)
        dq_p, _ = fa.flash_attention_bwd_dq_plain(*args, **kw)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(*args, **kw)
        dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(*args, **kw)
        rel = {"k1": cs._rel(o, o_p)[1], "k2a": cs._rel(dq, dq_p)[1],
               "k2b": max(cs._rel(dk, dk_p)[1], cs._rel(dv, dv_p)[1])}
        cs.log(f"{tag}: rel err K1 o {rel['k1']:.3e}, K2a dq "
               f"{rel['k2a']:.3e}, K2b dk/dv {rel['k2b']:.3e}")
        for key, x in rel.items():
            worst[key] = max(worst[key], x)
    return worst


def run(label: str, inputs) -> dict:
    cs.log(f"# build: {label}")
    k3 = cs.phase_kernel_sweep(pa, atol=math.inf)
    res = {"k3_tile": k3["tile"], "k3_split": k3["split"],
           **flash_worst(inputs)}
    cs.log(f"{label}: K3 tile {res['k3_tile']:.3e}, K3 split "
           f"{res['k3_split']:.3e} (KERNEL_ATOL {cs.KERNEL_ATOL}); f32 K1 o "
           f"{res['k1']:.3e}, K2a dq {res['k2a']:.3e} (FLASH_TOL "
           f"{cs.FLASH_TOL[torch.float32]}), K2b dk/dv {res['k2b']:.3e} "
           f"({DKV_TOL})")
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
    inputs = flash_inputs()
    split = run("TF32 split (as shipped)", inputs)
    one_pass_lib = one_pass_library()
    build._lib = one_pass_lib  # the wrappers now launch the one-pass build
    one = run("one TF32 pass (control)", inputs)
    tol = {"k3_tile": cs.KERNEL_ATOL, "k3_split": cs.KERNEL_ATOL,
           "k1": cs.FLASH_TOL[torch.float32],
           "k2a": cs.FLASH_TOL[torch.float32], "k2b": DKV_TOL}
    passed = {key: split[key] <= t for key, t in tol.items()}
    rejected = {key: one[key] > tol[key]
                for key in ("k3_tile", "k1", "k2a", "k2b")}
    ok = all(passed.values()) and all(rejected.values())
    cs.log(smi)
    cs.log(json.dumps({"split": split, "one_pass": one, "tolerance": tol,
                       "split_passes": passed,
                       "one_pass_rejected": rejected, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
