"""Deterministic real-file benchmark corpus (the port's own copy of
lz4_tpu/utils/realcorpus.py).

Silesia is unreachable (no network), so the bench corpus is assembled
from real files present on the machine, mixing the same content classes
Silesia does (text, source code, executables, structured data) in fixed
proportions. Composition is deterministic for one machine image: fixed
glob roots, sorted file order, fixed per-class byte budgets. It reads
local files only.
"""
from __future__ import annotations

import functools
import os
import sysconfig
import tempfile

#: per-class byte budget (total ~= 48 MB before truncation by caller)
CLASSES = (
    # (name, roots, extensions, budget bytes)
    ("pysrc", (sysconfig.get_paths()["stdlib"],), (".py",), 16 << 20),
    ("binary", ("/usr/lib/x86_64-linux-gnu", "/usr/bin"),
     (".so.6", ".so.2", "python3.11"), 16 << 20),
    ("text", ("/usr/share/doc", "/usr/share/common-licenses"),
     ("", ".txt", ".md"), 8 << 20),
    ("headers", ("/usr/include",), (".h",), 8 << 20),
)


def _collect(roots, exts, budget) -> bytes:
    out = bytearray()
    for root in roots:
        if len(out) >= budget:
            break
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for fn in sorted(filenames):
                if len(out) >= budget:
                    return bytes(out[:budget])
                if exts and not any(fn.endswith(e) for e in exts if e):
                    if "" not in exts or "." in fn[1:]:
                        continue
                p = os.path.join(dirpath, fn)
                try:
                    if os.path.islink(p) or not os.path.isfile(p):
                        continue
                    with open(p, "rb") as f:
                        out += f.read(budget - len(out))
                except OSError:
                    continue
    return bytes(out[:budget])


@functools.lru_cache(maxsize=1)
def real_corpus(total_bytes: int = 48 << 20) -> bytes:
    """Concatenated real-file corpus, truncated/tiled to total_bytes.
    Cached in the temporary directory (assembly walks thousands of
    files)."""
    cache = os.path.join(tempfile.gettempdir(),
                         f"lz4tpu_torch_realcorpus_{total_bytes}.bin")
    try:
        if os.path.getsize(cache) == total_bytes:
            with open(cache, "rb") as f:
                return f.read()
    except OSError:
        pass
    data = b"".join(_collect(roots, exts, budget)
                    for _name, roots, exts, budget in CLASSES)
    if not data:                       # pathological image: fall back
        from lz4_tpu_torch.utils.datagen import mixed_corpus
        data = mixed_corpus(min(total_bytes, 4 << 20), seed=20260817)
    if len(data) < total_bytes:
        reps = -(-total_bytes // len(data))
        data = data * reps
    data = data[:total_bytes]
    try:
        tmp = f"{cache}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, cache)
    except OSError:
        pass
    return data


def describe(data: bytes) -> str:
    return (f"real-file corpus {len(data) / 1e6:.0f} MB "
            f"(classes: {', '.join(c[0] for c in CLASSES)})")
