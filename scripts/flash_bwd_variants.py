#!/usr/bin/env python3
"""Design variants of the flash backward kernels K2a / K2b, timed on one
CUDA card against the shipped build.

    python3 scripts/flash_bwd_variants.py [NAME ...]

Each variant is ``paddle_tpu_torch/ops/cuda/flash_attention.cu`` (with
``attention_tile.cuh``) edited by plain text substitution, built by its own
``nvcc`` (all started together) into ``paddle_tpu_torch/ops/cuda/_build/
variants/<name>/``, and loaded in place of the shipped library. At the
training shape (B=2, T=2048, H=16, D=128, causal; q / k / v strided out of
one fused projection, f32 and bf16) each variant is first checked against
the plain versions at ``chip_smoke.py``'s tolerances (ablations, which
drop work and compute wrong values, are not), then K2a, K2b and the pair
are timed (CUDA events over a loop of calls), then SDPA's backward once
for reference. Variants:

- ``shipped``: the source as it is;
- ``rna_split``: the backward's split rounds hi as K1 / K3 do (three
  operations) instead of truncating (two);
- ``dq_bk16``: K2a on 16-key tiles (NT = 2) instead of 32;
- ``dkv_one_stage``: K2b's f32 ring with one stage instead of two;
- ``dkv_bq32``: K2b's f32 query tiles of 32 (NT = 4) in one stage;
- ``unroll2``: qk2_tf32_ldsm's loop over D unrolled by 2, not fully;
- ``no_pv`` (ablation): the dQ, dK and dV products left out, so the time
  is the S / dP products, the softmax and the loads.

Prints one line per variant and dtype, then one JSON object. Needs one
CUDA card of compute capability 9.0 and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import build  # noqa: E402

CU, TILE = "flash_attention.cu", "attention_tile.cuh"
ENTRIES = ("paddle_flash_attention_fwd", "paddle_flash_attention_bwd_dq",
           "paddle_flash_attention_bwd_dkv")
_TRUNC = """  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));"""
_RNA = """  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));"""
_PV = ("at::pv_tf32<D, NT, T, true>(acc, s, k_s, S, lane);",
       "at::pv_tf32<D, NT, T, true>(dv_acc, s, dos, S, lane);",
       "at::pv_tf32<D, NT, T, true>(dk_acc, dp, qs, S, lane);")
_KEEP = ("if (s[0][0] == 1.2345f) acc[0][0] += s[1][1];",
         "if (s[0][0] == 1.2345f) dv_acc[0][0] += s[1][1];",
         "if (dp[0][0] == 1.2345f) dk_acc[0][0] += dp[1][1];")

#: name -> ({file: [(old, new), ...]}, checked against plain)
VARIANTS = {
    "shipped": ({}, True),
    "rna_split": ({TILE: [(_TRUNC, _RNA)]}, True),
    "dq_bk16": ({CU: [("constexpr int kDqBKF32 = 32,",
                       "constexpr int kDqBKF32 = 16,")]}, True),
    "dkv_one_stage": ({CU: [("constexpr int kDkvStagesF32 = 2,",
                             "constexpr int kDkvStagesF32 = 1,")]}, True),
    "dkv_bq32": ({CU: [("constexpr int kDkvBQF32 = 16,",
                        "constexpr int kDkvBQF32 = 32,"),
                       ("constexpr int kDkvStagesF32 = 2,",
                        "constexpr int kDkvStagesF32 = 1,")]}, True),
    "unroll2": ({TILE: [("#pragma unroll\n  for (int kk = 0; kk < D; kk += "
                         "16) {\n    uint32_t hi[4][4]",
                         "#pragma unroll 2\n  for (int kk = 0; kk < D; kk "
                         "+= 16) {\n    uint32_t hi[4][4]")]}, True),
    "no_pv": ({CU: list(zip(_PV, _KEEP))}, False),
}


def sources(name):
    """{file: text} of the variant's sources; raises if a text to replace
    is not in the shipped source (the variant went stale)."""
    out = {}
    for f in (CU, TILE):
        text = (build._DIR / f).read_text()
        for old, new in VARIANTS[name][0].get(f, []):
            if old not in text:
                raise ValueError(f"{name}: the text to replace is not in {f}")
            text = text.replace(old, new)
        out[f] = text
    return out


def start_build(name):
    """Write the variant's sources and start its nvcc; (dir, process)."""
    out = build.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f, text in sources(name).items():
        (out / f).write_text(text)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xcompiler", "-fPIC",
           "-shared", "-o", str(out / "lib.so"), str(out / CU)]
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
        print("flash_bwd_variants: CUDA is not available", file=sys.stderr)
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
        libs[n] = load(out)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 3)
    b, t, h, d = cs.TRAIN_BATCH, cs.TRAIN_SEQ, 16, 128
    inputs = {dt: cs.flash_inputs(gen, b, t, t, h, h, d, dt, True)
              for dt in (torch.float32, torch.bfloat16)}
    res = {}
    for n, lib in libs.items():
        build._lib = lib  # the wrappers now launch this variant
        for dt, (q, k, v, do) in inputs.items():
            if VARIANTS[n][1]:
                cs.compare_flash(fa, q, k, v, do, None, True, False, {},
                                 f"{n} {str(dt)[6:]}")
            o, lse = fa.flash_attention_forward_plain(q, k, v, causal=True)
            delta = fa._delta(o, do).contiguous()
            args = (q, k, v, None, do, lse, delta)

            def dq():
                fa.flash_attention_bwd_dq_cuda(*args, causal=True)

            def dkv():
                fa.flash_attention_bwd_dkv_cuda(*args, causal=True)

            def pair():
                dq()
                dkv()
            r = {"dq": cs.cuda_ms(dq), "dkv": cs.cuda_ms(dkv),
                 "pair": cs.cuda_ms(pair)}
            res[f"{n} {str(dt)[6:]}"] = r
            cs.log(f"{n:14s} {str(dt)[6:]:8s}: K2a {r['dq']:.4f} ms, K2b "
                   f"{r['dkv']:.4f} ms, pair {r['pair']:.4f} ms")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention import sdpa_kernel
    for dt, (q, k, v, do) in inputs.items():
        qh, kh, vh = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        be = cs.sdpa_backend(qh, kh, vh, is_causal=True)
        with sdpa_kernel([be]):
            out = sdpa(qh, kh, vh, is_causal=True)
            ms = cs.cuda_ms(lambda: torch.autograd.grad(
                out, (qh, kh, vh), do.transpose(1, 2), retain_graph=True))
        res[f"sdpa_backward {str(dt)[6:]}"] = {"ms": ms, "backend": be.name}
        cs.log(f"sdpa backward  {str(dt)[6:]:8s}: [{be.name}] {ms:.4f} ms")
    cs.log(smi)
    cs.log(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
