"""`TorchBackend.compress_batch(blocks, level=, acceleration=)` on
blocks held as bytes in host memory: the program's block-batch entry,
called as the frame writer (`FrameCompressor.update`) calls it for the
whole blocks of one read of the CLI. A call ends when the list of
compressed streams is back."""
from __future__ import annotations

from benchmark import counters


class Entry:
    label = "compress_batch"
    kind = "stream"

    def __init__(self, run):
        from lz4_tpu_torch.parallel.engine import TorchBackend
        self.backend = TorchBackend(run.device)
        self.level = run.config["level"]
        self.acceleration = run.config["acceleration"]
        self.batches = [[row.tobytes() for row in run.host[run.rows(k)]]
                        for k in range(run.n_batches)]
        self.sizes = [sum(map(len, b)) for b in self.batches]
        self.prefixes = [None] * run.batch_blocks   # independent blocks

    def call(self, k):
        return self.backend.compress_batch(
            self.batches[k], level=self.level,
            acceleration=self.acceleration, dict_prefixes=self.prefixes,
            favor_dec_speed=False)

    def tally(self, k, res):
        """(blocks returned, uncompressed bytes, compressed bytes)."""
        return len(res), self.sizes[k], sum(map(len, res))

    def keep(self, k, res, picks):
        return [(k, j, res[j] if j < len(res) else None) for j in picks]

    def finish(self, kept):
        return kept

    def counters(self):
        return counters.read(self.backend)
