#!/usr/bin/env python3
"""Design variants of the grouped-matmul kernels K4a / K4b, checked and
timed on one CUDA card against the shipped build.

    python3 scripts/gmm_variants.py [NAME ...]

Each variant is ``paddle_tpu_torch/ops/cuda/grouped_matmul.cu`` edited by
plain text substitution, built by its own ``nvcc`` (all started together,
``-Xptxas -v`` to print registers and spills) into
``paddle_tpu_torch/ops/cuda/_build/variants_gmm/<name>/``, and loaded in
place of the shipped library. At the five grouped matmuls of one MoE
training step at the Mixtral 8x7B widths (``chip_smoke.py`` phase 10's
inputs: up / down forward, down dlhs on the rhs^T view, up / down drhs),
in f32 and bf16, each variant is first held against the plain versions at
``chip_smoke.py``'s tolerances, then timed (CUDA events over a loop of
calls). Variants:

- ``shipped``: the source as it is;
- ``bf16_n128``: bf16 block tiles of 128 x 128 in a three-stage ring
  (two blocks an SM) instead of 128 x 256 in four stages (one);
- ``bf16_m192``: bf16 block tiles of 192 x 256 on three warpgroups (384
  threads at most 168 registers each; 22 % less feed an output row);
- ``bf16_s3``: the bf16 ring in three stages (one tile loading ahead);
- ``bf16_bk32``: bf16 stages of 32 reductions (64-byte swizzle rows for
  the K-major tiles) in an eight-stage ring, six tiles loading ahead;
- ``f32_two_blocks``: the f32 kernels capped at 128 registers a thread so
  that two blocks share an SM;
- ``f32_s4``: the f32 ring in four stages;
- ``no_raster``: K4a's blocks in plain row-major order (bands of one row
  tile), the order before the bands;
- ``no_loads`` (ablation): the ring is filled once and never refilled, so
  the time is the products, the barriers and the epilogue without the
  device-memory traffic (its values are wrong and not checked).

Prints one line per variant, dtype and call, then one JSON object. Needs
one CUDA card of compute capability 9.0 and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import grouped_matmul as gm  # noqa: E402
from paddle_tpu_torch.ops.cuda import build  # noqa: E402

CU = "grouped_matmul.cu"
ENTRIES = ("paddle_grouped_matmul_fwd", "paddle_grouped_matmul_drhs")

#: name -> ([(old, new), ...] substitutions in the source, checked
#: against the plain versions)
VARIANTS = {
    "shipped": ([], True),
    "bf16_n128": ([("kBf16FwdN = 256, kBf16FwdStages = 4",
                    "kBf16FwdN = 128, kBf16FwdStages = 3"),
                   ("kBf16DrhsN = 256, kBf16DrhsStages = 4",
                    "kBf16DrhsN = 128, kBf16DrhsStages = 3")], True),
    "bf16_m192": ([("kBf16TileM = 128, kBf16Depth = 64",
                    "kBf16TileM = 192, kBf16Depth = 64")], True),
    "bf16_s3": ([("kBf16FwdStages = 4", "kBf16FwdStages = 3"),
                 ("kBf16DrhsStages = 4", "kBf16DrhsStages = 3")], True),
    "bf16_bk32": ([("kBf16TileM = 128, kBf16Depth = 64",
                    "kBf16TileM = 128, kBf16Depth = 32"),
                   ("kBf16FwdStages = 4", "kBf16FwdStages = 8"),
                   ("kBf16DrhsStages = 4", "kBf16DrhsStages = 8")], True),
    "f32_two_blocks": ([("kF32MinBlocks = 1", "kF32MinBlocks = 2")], True),
    "f32_s4": ([("kF32Stages = 3", "kF32Stages = 4")], True),
    "no_raster": ([("constexpr int kGroupM = 8;",
                    "constexpr int kGroupM = 1;")], True),
    "no_loads": ([("    load(s + S - 2);\n", ""),
                  ("    load(s + S - 1);\n", "")], False),
}


def source(name):
    """The variant's source; raises if a text to replace is not in the
    shipped source (the variant went stale)."""
    text = (build._DIR / CU).read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {CU}")
        text = text.replace(old, new)
    return text


def start_build(name):
    """Write the variant's source and start its nvcc; (dir, process)."""
    out = build.BUILD_DIR / "variants_gmm" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / CU).write_text(source(name))
    for h in build.HEADERS:
        (out / h).write_text((build._DIR / h).read_text())
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-Xcompiler",
           "-fPIC", "-shared", "-o", str(out / "lib.so"), str(out / CU)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(out) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(out / "lib.so"))
    for n in ENTRIES:
        fn = getattr(lib, n)
        fn.argtypes, fn.restype = build._SIGNATURES[n]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("gmm_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    smi = cs.smi_line()
    cs.log(smi)
    builds = {n: start_build(n) for n in names}
    libs = {}
    for n, (out, proc) in builds.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(text, file=sys.stderr)
            raise SystemExit(f"nvcc failed on variant {n}")
        regs = sorted(set(map(int, re.findall(r"Used (\d+) registers",
                                               text))))
        spills = sorted(set(map(int, re.findall(
            r"(\d+) bytes spill stores", text))))
        cs.log(f"{n}: registers {regs}, spill-store bytes {spills}")
        libs[n] = load(out)
    sizes, _, _, ops = cs.moe_gmm_inputs()
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        t = {k: v.to(dt) for k, v in ops.items()}
        for call, kind, lhs, other in cs.moe_gmm_calls(t):
            kern = (gm.grouped_matmul_cuda if kind == "fwd"
                    else gm.grouped_matmul_drhs_cuda)
            plain = (gm.grouped_matmul_plain if kind == "fwd"
                     else gm.grouped_matmul_drhs_plain)
            ref = plain(lhs, other, sizes)
            tol = cs.GMM_TOL[dt if kind == "fwd" else torch.float32]
            for n, lib in libs.items():
                build._lib = lib  # the wrappers now launch this variant
                _, rel = cs._rel(kern(lhs, other, sizes), ref)
                ms = cs.cuda_ms(lambda: kern(lhs, other, sizes), iters=10,
                                warm=2)
                key = f"{n} {call} {str(dt)[6:]}"
                res[key] = {"ms": ms, "rel": rel}
                cs.log(f"{n:15s} {call:10s} {str(dt)[6:]:8s}: {ms:.4f} ms, "
                       f"rel err {rel:.1e}")
                if VARIANTS[n][1] and not rel <= tol:
                    raise AssertionError(f"{key} disagrees with the plain "
                                         f"version: {rel} > {tol}")
            del ref
        del t, lhs, other
        torch.cuda.empty_cache()
    cs.log(smi)
    cs.log(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
