"""Build and bind the port's hand-written CUDA kernels at first use.

All ``.cu`` sources of this directory are compiled in one call for
``sm_90a`` into ``_build/`` (listed in ``.gitignore``) and loaded as one
shared library. The kernels export plain C entry points, bound here with
``ctypes``: no source includes PyTorch's headers, so the build takes
seconds, not minutes. ``torch.utils.cpp_extension.load`` drives the build
when ``ninja`` is present; otherwise ``nvcc -shared`` is called directly.
A failed build raises; nothing stands in for a kernel that did not build.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
SOURCES = ("paged_attention.cu",)
LIB_NAME = "paddle_tpu_torch_kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", *ARCH_FLAGS]

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of each exported entry point (pointers and the stream as
#: c_void_p so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "paddle_paged_attention": (
        [_P] * 8 + [_I] * 8 + [ctypes.c_float, ctypes.c_float, _P], _I),
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


def _build() -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(_DIR / s) for s in SOURCES]
    from torch.utils.cpp_extension import is_ninja_available, load

    if is_ninja_available():
        path = load(name=LIB_NAME, sources=sources,
                    build_directory=str(BUILD_DIR),
                    extra_cuda_cflags=NVCC_FLAGS, is_python_module=False,
                    verbose=False)
        return Path(path)
    out = BUILD_DIR / f"lib{LIB_NAME}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC",
           "-o", str(out), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stderr}")
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
