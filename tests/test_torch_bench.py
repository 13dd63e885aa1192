"""The port's bench (`lz4_tpu_torch.bench`) at a tiny size on the CPU,
where the kernels' plain versions run: every stage runs, its checks pass,
and it prints one JSON line naming its device."""
import json

import pytest
import torch

from lz4_tpu_torch import bench


def test_tiny_bench_on_cpu(capsys):
    r = bench.main(mb=1 / 16, seconds=0, block=8192, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == r
    assert r["metric"] == "compress_throughput" and r["unit"] == "MB/s"
    d = r["detail"]
    assert d["device"] == "cpu" and d["block"] == 8192
    assert d["hc_batch_blocks"] == d["wave_blocks"] == 8
    for key in ("decompress_MBs", "ratio", "device_hc3_batch_MBs",
                "device_hc9_batch_MBs", "wave_decode_MBs", "wave_encode_MBs",
                "wave_emit_host_MBs", "host_compress_MBs",
                "host_decompress_MBs", "cli_decode_MBs"):
        assert d[key] > 0, key
    assert d["ratio"] > 1.5
    assert d["wave_encode_size_vs_uncapped"] >= 1.0
    for key in ("vs_baseline", "size_vs_ref", "ref_cli_samebox_compress_MBs"):
        assert key not in d and key not in r


def test_arguments():
    a = bench._parse(["--mb", "8", "--seconds", "1", "--block", "4096",
                      "--device", "cpu"])
    assert vars(a) == {"mb": 8.0, "seconds": 1.0, "block": 4096,
                       "device": "cpu"}
    assert vars(bench._parse([])) == {"mb": 48, "seconds": 3.0,
                                      "block": 65536, "device": None}
    with pytest.raises(ValueError, match="block"):
        bench.main(mb=1, block=100, device="cpu")


def test_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(mb=1 / 16, seconds=0, block=8192)
