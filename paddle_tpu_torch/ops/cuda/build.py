"""Build and bind the port's hand-written CUDA kernels at first use.

Each ``.cu`` source of this directory is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library under ``_build/`` (listed in ``.gitignore``), named by a
hash of the sources and flags so a stale build is never loaded. The
kernels export plain C entry points, bound here with ``ctypes``: no source
includes PyTorch's headers, so the build takes seconds, not minutes. A
failed build raises; nothing stands in for a kernel that did not build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
SOURCES = ("paged_attention.cu", "flash_attention.cu", "grouped_matmul.cu")
#: headers the sources include (part of the build's hash)
HEADERS = ("attention_tile.cuh",)
LIB_NAME = "paddle_tpu_torch_kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", *ARCH_FLAGS]

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
#: argtypes of each exported entry point (pointers and the stream as
#: c_void_p so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    # q, k_pool, v_pool, k_scales, v_scales, page_table, start, out,
    # scratch, S, T, H, Hkv, P, D, MP, kv_dtype, q_dtype, nsplit, scale,
    # fill, stream
    "paddle_paged_attention": ([_P] * 9 + [_I] * 10 + [_F, _F, _P], _I),
    # q, k, v, bias, o, lse, strides, 12 ints, scale, stream
    "paddle_flash_attention_fwd": ([_P] * 6 + [_STRIDES] + [_I] * 12
                                   + [_F, _P], _I),
    # q, k, v, bias, dout, lse, delta, dq, dbias, strides, ...
    "paddle_flash_attention_bwd_dq": ([_P] * 9 + [_STRIDES] + [_I] * 12
                                      + [_F, _P], _I),
    # q, k, v, bias, dout, lse, delta, dk, dv, strides, ...
    "paddle_flash_attention_bwd_dkv": ([_P] * 9 + [_STRIDES] + [_I] * 12
                                       + [_F, _P], _I),
    # lhs, rhs, offs, out, strides, M, K, N, G, dtype, rhs_k_contig, vec
    "paddle_grouped_matmul_fwd": ([_P] * 4 + [_STRIDES] + [_I] * 7 + [_P],
                                  _I),
    # lhs, dout, offs, drhs, strides, M, K, N, G, dtype, vec
    "paddle_grouped_matmul_drhs": ([_P] * 4 + [_STRIDES] + [_I] * 6 + [_P],
                                   _I),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build paddle_tpu_torch's kernels")
    return found


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{out}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def _build() -> Path:
    sources = [_DIR / s for s in SOURCES]
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sources + [_DIR / h for h in HEADERS]:
        digest.update(s.read_bytes())
    tag = digest.hexdigest()[:12]
    out = BUILD_DIR / f"lib{LIB_NAME}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-c", str(s), "-o",
               str(o)] for s, o in zip(sources, objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
