"""The program's own counters, read after the window for the `info`
lines: the routes `TorchBackend` took and each kernel wrapper's
launches."""
from __future__ import annotations

import importlib

ROUTES = ("wave_decoded", "wave_encoded", "hc_encoded", "device_hc_encoded",
          "piece_decoded", "sortscan_decoded", "host_fallbacks")
WRAPPERS = ("encode_cuda", "encode_hc", "encode_wave", "decode_cuda",
            "decode_wave")


def launches() -> dict:
    out = {}
    for name in WRAPPERS:
        mod = importlib.import_module(f"lz4_tpu_torch.block.{name}")
        out[name] = getattr(mod, "launches", None)
    return out


def read(backend=None) -> dict:
    routes = {} if backend is None else {
        r: getattr(backend, r) for r in ROUTES if hasattr(backend, r)}
    return {"routes": routes, "launches": launches()}
