"""Kernel loader: builds `csrc/*.cu` with nvcc at first use.

Each source becomes a shared library with a plain C interface for
`sm_90a` (Hopper), loaded with ctypes. The library's name carries a hash
of its source and flags, so an edited kernel is rebuilt and a stale one
is never loaded. A build writes a temporary file and renames it into
place, so concurrent processes never load a half-written library. A
failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: source name -> (C entry point, its argument types); every entry point
#: returns the launch's cudaError_t
KERNELS = {
    "encode_serial": ("lz4t_encode_serial",
                      (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P)),
    "decode_serial": ("lz4t_decode_serial",
                      (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default
    /usr/local/cuda). Raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "lz4_tpu_torch: nvcc not found (put it on PATH or set CUDA_HOME); "
        "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, float]:
    """Build the named kernels (all by default) that are not built yet,
    one nvcc per source, all started together. Returns the seconds each
    build took (0.0 for one already built). The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    `.log`. Raises on the first failed build."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    secs = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            secs[name] = 0.0
            continue
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        started[name] = (proc, so, tmp, time.perf_counter())
    failed = []
    for name, (proc, so, tmp, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        with open(f"{so}.log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("lz4_tpu_torch: nvcc failed for "
                           + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """nvcc's report for the built kernel (empty if not built here)."""
    try:
        with open(f"{library_path(name)}.log", encoding="utf-8",
                  errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def load(name: str):
    """The C entry point of kernel `name`, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            fn_name, argtypes = KERNELS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return getattr(lib, KERNELS[name][0])
