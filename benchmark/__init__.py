"""The benchmark of lz4_tpu_torch: `python -m benchmark.run` (see run.py)."""
