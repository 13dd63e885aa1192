"""Kernel loader: builds `csrc/*.cu` with nvcc at first use.

Each source becomes a shared library with a plain C interface for
`sm_90a` (Hopper), loaded with ctypes. The library's name carries a hash
of every file the build reads (the source and the headers it includes
from `csrc/`), the flags and the extra `-D` defines, so an edited kernel
or header is rebuilt, a stale one is never loaded, and a variant built
with other defines never shares a library with the kernel itself. A
build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library. A failed build raises:
there is no fallback. `launch` is the one way the wrappers of the
product kernels (B1-B6) reach their entry points.

The probe gathers' libraries (`probe_lane`, `probe_gather`) are also
CPython extension modules (`csrc/pyentry.h`): `module(name)` imports one
as `lz4t_<name>`, whose `gather` checks, allocates and launches in one C
call. Every source is built against the interpreter's headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import re
import shutil
import subprocess
import sysconfig
import threading
import time

import torch

from lz4_tpu_torch.spans import span

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", sysconfig.get_paths()["include"])

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
#: source name -> (C entry point, its argument types); every entry point
#: returns the launch's cudaError_t
KERNELS = {
    "encode_serial": ("lz4t_encode_serial",
                      (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P)),
    "decode_serial": ("lz4t_decode_serial",
                      (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "decode_wave": ("lz4t_decode_wave", (_P, _P, _P, _P, _I, _I, _P)),
    "encode_wave": ("lz4t_encode_wave",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "encode_hc": ("lz4t_encode_hc", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P)),
    "xxh32": ("lz4t_xxh32_blocks", (_P, _P, _P, _I, _I, _U, _P)),
    # the probes of `probes/{walk,gather,lane}_probe.py`
    "probe_walk": ("lz4t_probe_walk", (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P)),
    "probe_gather": ("lz4t_probe_gather", (_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _P)),
    "probe_lane": ("lz4t_probe_lane", (_P, _P, _P, _I, _I, _I, _P)),
}

_LIBS: dict[tuple, ctypes.CDLL] = {}
_MODULES: dict[str, object] = {}
_LOCK = threading.Lock()
#: the builds this process ran: kernel name (with `:` and its defines
#: where it has any) -> seconds nvcc took; a library found built is not
#: listed
built: dict[str, float] = {}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list[str]:
    """The files the build of kernel `name` reads: `csrc/<name>.cu` and,
    transitively, every header it includes with `#include "..."` that
    lies in `csrc/`."""
    todo = [os.path.join(CSRC, f"{name}.cu")]
    seen: list[str] = []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(dep):
                todo.append(os.path.normpath(dep))
    return seen


def library_path(name: str, defines=()) -> str:
    key = hashlib.sha256()
    for path in sorted(sources(name)):
        with open(path, "rb") as f:
            key.update(os.path.relpath(path, CSRC).encode() + b"\0"
                       + f.read() + b"\0")
    key.update(" ".join(NVCC_FLAGS).encode() + b"\0"
               + " ".join(defines).encode())
    return os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")


def build(names=None, defines=()) -> dict[str, float]:
    """Build the named kernels (all by default) that are not built yet,
    one nvcc per source, all started together, each with `-D<d>` for
    every d in `defines`. Returns the seconds each build took (0.0 for
    one already built). The compiler's report (registers, shared memory,
    spills) is kept beside each library as `.log`. Raises on the first
    failed build."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    secs = {}
    for name in names:
        so = library_path(name, defines)
        if os.path.exists(so):
            secs[name] = 0.0
            continue
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        started[name] = (proc, so, tmp, time.perf_counter())
    failed = []
    for name, (proc, so, tmp, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        built[":".join((name, *defines))] = secs[name]
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


def build_log(name: str, defines=()) -> str:
    """nvcc's report for the built kernel (empty if not built here)."""
    try:
        with open(f"{library_path(name, defines)}.log", encoding="utf-8",
                  errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def load(name: str, defines=()):
    """The C entry point of kernel `name` (built with `defines`), building
    it if needed."""
    defines = tuple(defines)
    with _LOCK:
        lib = _LIBS.get((name, defines))
        if lib is None:
            with span("lz4t.build"):
                build([name], defines)
            lib = ctypes.CDLL(library_path(name, defines))
            fn_name, argtypes = KERNELS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _LIBS[(name, defines)] = lib
        return getattr(lib, KERNELS[name][0])


def launch(name: str, tag: str, device, plain, outs, *args):
    """One batch through product kernel `name` (`tag`, as "B1", names it
    in errors) on `device`, inside the `lz4t.launch` span.

    On the CPU this runs `plain()`, the kernel's plain version. On a GPU
    it launches the kernel on the device's current stream with `args` in
    its C entry point's order, a tensor passed as its `data_ptr()` and
    None as NULL. `outs` is what the kernel writes, a tensor or a tuple
    of them that the caller made on `device`; where no tensor of it holds
    an element, nothing launches. Returns `(result, launched)`:
    `plain()`'s result or `outs`, and 1 where the kernel launched, else
    0. Raises ValueError on any other device, RuntimeError where the
    launch returns a CUDA error.
    """
    with span("lz4t.launch"):
        if device.type == "cpu":
            return plain(), 0
        if device.type != "cuda":
            raise ValueError(f"no {tag} kernel for device {device}")
        if not any(o.numel() for o in
                   (outs if isinstance(outs, tuple) else (outs,))):
            return outs, 0
        fn = load(name)
        with torch.cuda.device(device):
            rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args),
                    torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{tag} {name} launch failed: CUDA error {rc}")
        return outs, 1


def module(name: str):
    """Kernel `name`'s library imported as the CPython extension module
    `lz4t_<name>` (building it if needed)."""
    with _LOCK:
        mod = _MODULES.get(name)
        if mod is None:
            with span("lz4t.build"):
                build([name])
            loader = importlib.machinery.ExtensionFileLoader(
                f"lz4t_{name}", library_path(name))
            spec = importlib.util.spec_from_loader(loader.name, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _MODULES[name] = mod
        return mod
