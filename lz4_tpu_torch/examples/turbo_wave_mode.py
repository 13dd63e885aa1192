"""The wave tiers: distance-capped streams (offsets at most 2 KB) whose
matches the wave match finder (kernel B4) finds for a whole batch of
blocks at once, and the batch frame surface that decodes many frames
abreast on the wave decoder (kernel B3). Both run on the GPU unless
`device="cpu"` names the plain PyTorch versions.

    python -m lz4_tpu_torch.examples.turbo_wave_mode
"""
from lz4_tpu_torch import native
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.block.encode_wave import encode_wave_batch
from lz4_tpu_torch.frame.batch import decompress_frames_wave
from lz4_tpu_torch.frame.format import FrameInfo, Preferences
from lz4_tpu_torch.frame.writer import FrameCompressor
from lz4_tpu_torch.utils.datagen import mixed_corpus


def main(device=None):
    # --- raw block batch through the wave encoder (offsets <= 2 KB) ---
    blocks = [mixed_corpus(30000 + 1000 * i, seed=40 + i)
              for i in range(4)]
    streams = encode_wave_batch(blocks, max_dist=2048, device=device)
    assert all(native.blockcodec.decompress(s, len(b)) == b
               for b, s in zip(blocks, streams))
    ratio = sum(map(len, streams)) / sum(map(len, blocks))
    print(f"wave-encoded {len(blocks)} blocks, "
          f"{sum(map(len, blocks))} -> {sum(map(len, streams))} bytes "
          f"({100 * ratio:.1f}%)")

    # --- many .lz4 frames decoded abreast (linked -BD included) ---
    frames = []
    for i, d in enumerate(blocks):
        info = FrameInfo(block_size_id=4, block_independent=i % 2 == 0)
        c = FrameCompressor(Preferences(frame_info=info), level=1,
                            backend=HostBackend())
        frames.append(c.begin() + c.update(d) + c.end())
    outs = decompress_frames_wave(frames, device=device)
    assert outs == blocks
    print(f"batch-decoded {len(frames)} frames "
          f"(alternating independent/-BD linked) byte-exact")


if __name__ == "__main__":
    main()
