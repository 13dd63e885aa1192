"""`TorchBackend.compress_batch(blocks, level=, acceleration=,
dict_prefixes=)` on linked blocks held as bytes in host memory: the
frame writer's call for a linked frame (`FrameCompressor.update`), each
block with the 64 KB of its stream before it as its prefix. A call ends
when the list of compressed streams is back.

Each corpus row is one stream's history and its next block: the row's
first half is the prefix, its second half the block that is compressed.
The rate counts the blocks' bytes, not the histories'. After the window
each kept stream is joined with its history into one independent block
of the whole row (`reference_linked.join`), which the strict reference
then decodes against the row."""
from __future__ import annotations

from benchmark import counters, reference_linked


class Entry:
    label = "compress_batch"
    kind = "stream"

    def __init__(self, run):
        from lz4_tpu_torch.parallel.engine import TorchBackend
        self.backend = TorchBackend(run.device)
        self.level = run.config["level"]
        self.acceleration = run.config["acceleration"]
        half = run.block_bytes // 2
        self.prefixes, self.batches = [], []
        for k in range(run.n_batches):
            rows = run.host[run.rows(k)]
            self.prefixes.append([row[:half].tobytes() for row in rows])
            self.batches.append([row[half:].tobytes() for row in rows])
        self.sizes = [sum(map(len, b)) for b in self.batches]

    def call(self, k):
        return self.backend.compress_batch(
            self.batches[k], level=self.level,
            acceleration=self.acceleration, dict_prefixes=self.prefixes[k],
            favor_dec_speed=False)

    def tally(self, k, res):
        """(blocks returned, the blocks' uncompressed bytes, the streams'
        bytes)."""
        return len(res), self.sizes[k], sum(map(len, res))

    def keep(self, k, res, picks):
        return [(k, j, res[j] if j < len(res) else None) for j in picks]

    def finish(self, kept):
        """Each kept stream joined with its history (after the window)."""
        return [(k, j, None if s is None
                 else reference_linked.join(self.prefixes[k][j], s))
                for k, j, s in kept]

    def counters(self):
        from lz4_tpu_torch.block import encode_cuda
        out = counters.read(self.backend)
        out["encode_cuda.smem_launches"] = getattr(
            encode_cuda, "smem_launches", None)
        out["encode_cuda.dict_launches"] = getattr(
            encode_cuda, "dict_launches", None)
        return out
