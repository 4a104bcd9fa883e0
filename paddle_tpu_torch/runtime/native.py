"""ctypes loader for the port's host runtime (``runtime/csrc/host_rt.cc``;
counterpart of ``paddle_tpu/runtime/native.py``).

The library is built with ``g++`` at first use into ``runtime/_build/``
(named by a hash of the source and flags, so an edited source never loads
a stale build) and loaded through ctypes. Concurrent first uses (ranks
launched together, test workers) serialize on a cross-process ``fcntl``
lock, and the build writes to a temporary name and renames it into place,
so no process can load a half-written library. Every caller degrades to
plain numpy when the library is unavailable (``available() == False``):
no compiler, a failed build, or ``PADDLE_TPU_DISABLE_NATIVE`` set.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "host_rt.cc")
_BUILD = os.path.join(_HERE, "_build")
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-fvisibility=hidden", "-Wall",
              "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD, f"libhost_rt-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    import fcntl

    os.makedirs(_BUILD, exist_ok=True)
    lock_fd = os.open(os.path.join(_BUILD, ".build.lock"),
                      os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
        if os.path.exists(path):
            return True
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS,
                            "-o", tmp, _SRC], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
            return True
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            return False
    finally:
        fcntl.flock(lock_fd, fcntl.LOCK_UN)
        os.close(lock_fd)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i64 = ctypes.c_uint64, ctypes.c_int64
    p, cp = ctypes.c_void_p, ctypes.c_char_p

    lib.pt_arena_create.argtypes = [u64]
    lib.pt_arena_create.restype = p
    lib.pt_arena_destroy.argtypes = [p]
    lib.pt_arena_alloc.argtypes = [p, u64]
    lib.pt_arena_alloc.restype = p
    lib.pt_arena_free.argtypes = [p, p]
    lib.pt_arena_stats.argtypes = [p, ctypes.POINTER(u64 * 4)]

    lib.pt_stack.argtypes = [p, ctypes.POINTER(p), i64, u64, ctypes.c_int]

    lib.pt_now_ns.restype = i64
    lib.pt_trace_record.argtypes = [cp, cp, i64, i64, i64]
    lib.pt_trace_export.argtypes = [p, i64]
    lib.pt_trace_export.restype = i64
    lib.pt_trace_count.restype = i64
    lib.pt_trace_enabled.restype = ctypes.c_int
    return lib


def get_lib():
    """The loaded library, or None if unavailable (built on first call)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PADDLE_TPU_DISABLE_NATIVE"):
            return None
        try:
            path = lib_path()
            if _build(path):
                _lib = _bind(ctypes.CDLL(path))
        except OSError:  # no source, an unwritable tree, a bad library
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None
