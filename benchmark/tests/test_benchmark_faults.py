"""A run whose timed path is broken underneath comes out not correct:
the harness drives the rest of a run (the check for a card left out, on
the CPU at a small size) with each fault that a cell of one chip can
have planted in the program's entry. (The exchange between chips is no
fault of a one-chip cell.)"""
import io
import json

import pytest
import torch

import lz4_tpu_torch.block.encode_cuda as encode_cuda
from lz4_tpu_torch.parallel.engine import TorchBackend

from benchmark import run
from benchmark.tests.small import small_cell


def flip(b: bytes) -> bytes:
    """One byte of an answer altered, in its middle."""
    if not b:
        return b"\x01"
    a = bytearray(b)
    a[len(a) // 2] ^= 0x5A
    return bytes(a)


def backend_fault(orig, fault):
    def call(self, blocks, *args, **kw):
        if fault == "unchanged":            # returns its state unchanged
            return list(blocks)
        if fault == "half":                 # half of the batch left out
            return orig(self, blocks[: len(blocks) // 2], *args, **kw)
        return [flip(x) for x in orig(self, blocks, *args, **kw)]
    return call


def device_fault(orig, fault):
    def call(src, lens, *args, **kw):
        if fault == "unchanged":
            return src.clone(), lens.clone(), torch.zeros_like(lens)
        out, csizes, trailing = orig(src, lens, *args, **kw)
        if fault == "half":
            h = src.shape[0] // 2
            return out[:h], csizes[:h], trailing[:h]
        out = out.clone()
        rows = torch.arange(out.shape[0])
        out[rows, csizes.long() // 2] ^= 0x5A
        return out, csizes, trailing
    return call


FAULTS = ("unchanged", "half", "altered")


def run_small(name):
    return run.execute(small_cell(name), 2**31 + 17, 0.3, False,
                       device="cpu", out=io.StringIO())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name, method", [
    ("lz4hc9-64k.compress", "compress_batch"),
    ("lz4-64k.compress", "compress_batch")])
def test_backend_fault_is_not_correct(monkeypatch, name, method, fault):
    orig = getattr(TorchBackend, method)
    monkeypatch.setattr(TorchBackend, method, backend_fault(orig, fault))
    r = run_small(name)
    assert not r["correct"]
    key = "missing_blocks" if fault == "half" else "bad_blocks"
    assert r["checks"][key]["value"] > r["checks"][key]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_device_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(encode_cuda, "encode_blocks",
                        device_fault(encode_cuda.encode_blocks, fault))
    r = run_small("lz4-64k.device-compress")
    assert not r["correct"]
    key = "missing_blocks" if fault == "half" else "bad_blocks"
    assert r["checks"][key]["value"] > r["checks"][key]["limit"]


def test_a_raising_call_is_not_correct(monkeypatch):
    """Calls after the warm-up raise: counted, and the run goes on."""
    orig = TorchBackend.compress_batch
    calls = []

    def boom(self, *a, **k):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return orig(self, *a, **k)
    monkeypatch.setattr(TorchBackend, "compress_batch", boom)
    r = run_small("lz4-64k.compress")
    assert not r["correct"] and r["checks"]["raised_calls"]["value"] > 0


CARD_SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name, method", [
    ("lz4hc9-64k.compress", "compress_batch"),
    ("lz4-64k.compress", "compress_batch"),
    ("lz4-64k.device-compress", None)])
def test_fault_on_the_card(card, monkeypatch, capsys, name, method, fault):
    """Each fault at the cell's own size on three seeds (2 s windows):
    the readings that set the upper end of each compared number."""
    from benchmark import cells
    if method is None:
        monkeypatch.setattr(encode_cuda, "encode_blocks",
                            device_fault(encode_cuda.encode_blocks, fault))
    else:
        monkeypatch.setattr(TorchBackend, method, backend_fault(
            getattr(TorchBackend, method), fault))
    for seed in CARD_SEEDS:
        r = run.execute(cells.load_cell(name), seed, 2.0, False,
                        device=card, out=io.StringIO())
        with capsys.disabled():
            print("fault", name, fault, seed, json.dumps(
                {k: v["value"] for k, v in r["checks"].items()}))
        assert not r["correct"]
