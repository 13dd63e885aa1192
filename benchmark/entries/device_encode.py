"""`lz4_tpu_torch.block.encode_cuda.encode_blocks(src, lens, cap_n=)` on
blocks resident on the card: the batched device-to-device use of the
codec. The results stay on the device; a call ends at a synchronize.

The sampled answers are copied, inside the window, into page-locked host
memory reserved in set-up, without waiting for the card; they become
bytes once the window has closed. Where the reserve runs out, the rest
are copied with a wait."""
from __future__ import annotations

import torch

from benchmark import counters


class Entry:
    label = "encode_blocks"
    kind = "stream"

    def __init__(self, run):
        from lz4_tpu_torch.block.encode_cuda import encode_blocks
        self.encode = encode_blocks
        self.device = run.device
        self.cap_n = run.block_bytes
        self.acceleration = run.config["acceleration"]
        self.src = [run.data[run.rows(k)] for k in range(run.n_batches)]
        self.lens = torch.full((run.batch_blocks,), run.block_bytes,
                               dtype=torch.int32, device=run.device)
        self.sizes = [int(s.numel()) for s in self.src]
        self.per_call = run.cell.mix["checks_per_call"]
        self.width = self.cap_n
        self.rows = self.row_sizes = None     # the reserve (`reserve`)
        self.used = 0

    def call(self, k):
        out, csizes, _ = self.encode(self.src[k], self.lens,
                                     cap_n=self.cap_n,
                                     acceleration=self.acceleration)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.width = out.shape[1]
        return out, csizes

    def reserve(self, calls):
        """Host room for the sample of `calls` calls."""
        pin = self.device.type == "cuda"
        n = calls * self.per_call
        self.rows = torch.empty((n, self.width), dtype=torch.uint8,
                                pin_memory=pin)
        self.row_sizes = torch.empty(n, dtype=torch.int32, pin_memory=pin)

    def tally(self, k, res):
        """(blocks returned, uncompressed bytes, compressed sizes: a
        device tensor, summed after the window)."""
        out, csizes = res
        return out.shape[0], self.sizes[k], csizes

    def keep(self, k, res, picks):
        """The picked rows: a slot of the reserve each (an int), or, where
        it is full, their bytes, copied to the host at once."""
        out, csizes = res
        have = [j for j in picks if j < out.shape[0]]
        idx = torch.as_tensor(have, dtype=torch.long, device=out.device)
        a, b = self.used, self.used + len(have)
        if self.rows is not None and b <= self.rows.shape[0] \
                and out.shape[1] == self.rows.shape[1]:
            self.rows[a:b].copy_(out.index_select(0, idx), non_blocking=True)
            self.row_sizes[a:b].copy_(csizes.index_select(0, idx),
                                      non_blocking=True)
            self.used = b
            got = dict(zip(have, range(a, b)))
        else:
            rows = out.index_select(0, idx).cpu().numpy()
            sizes = csizes.index_select(0, idx).cpu().tolist()
            got = {j: rows[n, : max(0, sizes[n])].tobytes()
                   for n, j in enumerate(have)}
        return [(k, j, got.get(j)) for j in picks]

    def finish(self, kept):
        """The kept answers as bytes (after the window)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

        def answer(a):
            if not isinstance(a, int):
                return a
            return self.rows[a, : max(0, int(self.row_sizes[a]))] \
                .numpy().tobytes()
        kept = [(k, j, answer(a)) for k, j, a in kept]
        self.rows = self.row_sizes = None
        return kept

    def counters(self):
        return counters.read()
