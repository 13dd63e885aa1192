"""Cells cut to a size the CPU tests can run: blocks of 8 KB in strata
and batches of 8, through the plain PyTorch versions of the program."""
from __future__ import annotations

from benchmark import cells

#: the cells of BENCHMARK.json
WORKLOADS = ("lz4hc9-64k.compress", "lz4-64k.compress",
             "lz4-64k.device-compress")


def small_cell(name: str, blocks: int = 16, stratum: int = 8,
               block_bytes: int = 8192, **kw) -> cells.Cell:
    cell_ = cells.load_cell(name, **kw)
    cell_.config["corpus_blocks"] = blocks
    cell_.corpus["stratum_blocks"] = stratum
    cell_.config["block_bytes"] = block_bytes
    cell_.mix["batch_blocks"] = min(stratum, cell_.mix["batch_blocks"])
    return cell_
