"""The control of the comparison that decides `correct`: the reference,
put in the program's place, breaking one guarantee that the
configuration states. It has to come out as not correct.

- Compress cells (`kind` "stream"): the benchmark's frozen level-1
  encoder links each block to the one before it in its batch, as a
  stream of linked blocks does (a better ratio, the step that would
  tempt a later change): a match may reach into the previous block,
  which breaks "every block is compressed on its own".
- Decompress cells (`kind` "block"): a plain decoder that copies every
  match in one wide move, as a fast copy does, and so ignores a match
  that overlaps its own output: this breaks "lossless".

    python -m benchmark.control --workload <name> --seeds 1,2,3 --calls N

reads `bad_blocks` over the sample that a run of N calls checks (the
same picks, from the same seeds, at the cell's own corpus size), one
JSON line a seed. The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark import check, corpus, frozen_encoder, reference
from benchmark.cells import Cell, load_cell


def decode_wide_copies(stream: bytes, n_out: int) -> bytes:
    """A decoder that moves each match as one block of bytes from a
    buffer of n_out zeros: where a match overlaps its own output, it
    copies zeros in place of the repeated bytes."""
    src = bytes(stream)
    out = bytearray(n_out)
    i = pos = 0
    while i < len(src):
        tok = src[i]
        i += 1
        lit = tok >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out[pos: pos + lit] = src[i: i + lit]
        i += lit
        pos += lit
        if i >= len(src):
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        ml = tok & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += reference.MINMATCH
        out[pos: pos + ml] = bytes(out[pos - off: pos - off + ml])
        pos += ml
    return bytes(out[:n_out])


def control_answers(cell: Cell, kind: str, host, picks_of,
                    calls: int) -> list:
    """(batch, block, answer) of the control at every pick of `calls`
    calls, as a run's `keep` would hold them; `kind` is the entry's."""
    bs = cell.mix["batch_blocks"]
    n_batches = cell.config["corpus_blocks"] // bs
    acc = cell.config["acceleration"]
    kept = []
    for i in range(calls):
        k = i % n_batches
        for j in picks_of(i):
            row = k * bs + j
            block = host[row].tobytes()
            if kind == "stream":
                prev = host[row - 1].tobytes() if j > 0 else b""
                kept.append((k, j, frozen_encoder.compress_linked(
                    block, prev, acc)))
            else:
                stream = frozen_encoder.compress_rows(
                    host[row: row + 1], [len(block)], acc)[0]
                kept.append((k, j, decode_wide_copies(stream, len(block))))
    return kept


def reading(cell: Cell, seed: int, calls: int, device) -> dict:
    """The control's compared number on `seed`."""
    bs = cell.mix["batch_blocks"]
    data, _ = corpus.make_corpus(cell.corpus, seed,
                                 cell.config["corpus_blocks"],
                                 cell.config["block_bytes"], device)
    host = data.cpu().numpy()
    del data
    picks = check.Picks(seed, cell.mix["checks_per_call"], bs)
    kind = cell.entry_class().kind
    kept = control_answers(cell, kind, host, picks, calls)
    bad, notes = check.verify(kind, kept,
                              lambda k, j: host[k * bs + j].tobytes())
    return {"workload": cell.name, "seed": seed, "calls": calls,
            "checked_blocks": len(kept), "bad_blocks": bad,
            "limit": check.LIMITS["bad_blocks"],
            "correct": bad <= check.LIMITS["bad_blocks"],
            "first_faults": notes[:2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(reading(cell, int(s), args.calls, "cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
