"""Deterministic test-corpus generator with tunable compressibility.

Fills the role of the reference's tests/datagen.c (parametrized match
probability `-P#`, seeded determinism `-s#`) with an original design:
a seeded numpy Generator emits a mix of back-references (window-limited)
and literals drawn from a skewed alphabet, so `match_prob` directly
controls the achievable LZ4 ratio.
"""
from __future__ import annotations

import numpy as np


def gen_buffer(size: int, match_prob: float = 0.7, seed: int = 0,
               lit_alphabet: int = 32, window: int = 65535) -> bytes:
    """Generate `size` deterministic bytes.

    match_prob ~0.0 → incompressible noise; ~0.7 → LZ4-friendly (~2x);
    ~0.95 → highly repetitive.
    """
    rng = np.random.default_rng(seed)
    out = np.empty(size, dtype=np.uint8)
    pos = 0
    # seed run of literals so back-references have history
    boot = min(size, 256)
    out[:boot] = rng.integers(0, lit_alphabet, boot, dtype=np.uint8) + ord("0")
    pos = boot
    # draw decisions in bulk; each op is a vectorized slice copy
    batch = 4096
    while pos < size:
        decisions = rng.random(batch)
        lit_lens = rng.integers(1, 8, batch)
        lits = rng.integers(0, lit_alphabet, (batch, 8), dtype=np.uint8) \
            + ord("0")
        offs = rng.integers(1, window, batch)
        lens = (rng.pareto(1.7, batch) * 4 + 4).astype(np.int64).clip(4, 512)
        for i in range(batch):
            if pos >= size:
                break
            if decisions[i] < match_prob and pos > 16:
                off = max(int(offs[i]) % pos, 1)
                length = min(int(lens[i]), size - pos)
                src = pos - off
                if off >= length:
                    out[pos: pos + length] = out[src: src + length]
                else:   # overlap: the match repeats an off-period pattern
                    reps = -(-length // off)
                    out[pos: pos + length] = np.tile(
                        out[src: pos], reps)[:length]
                pos += length
            else:
                ll = min(int(lit_lens[i]), size - pos)
                out[pos: pos + ll] = lits[i, :ll]
                pos += ll
    return out.tobytes()


_WORDS = ("lorem ipsum dolor sit amet consectetur adipiscing elit sed do "
          "eiusmod tempor incididunt ut labore et dolore magna aliqua enim "
          "ad minim veniam quis nostrud exercitation ullamco laboris nisi "
          "aliquip ex ea commodo consequat duis aute irure in reprehenderit "
          "voluptate velit esse cillum eu fugiat nulla pariatur excepteur "
          "sint occaecat cupidatat non proident sunt culpa qui officia "
          "deserunt mollit anim id est laborum").split()


def gen_text(size: int, seed: int = 0) -> bytes:
    """Deterministic natural-text-like generator (the reference's
    lorem.c / LOREM_genBuffer analog): Zipf-ish word draws, sentence
    capitalization and punctuation."""
    if size <= 0:
        return b""
    rng = np.random.default_rng(seed)
    out = []
    n = 0
    sentence = 0
    ranks = rng.zipf(1.3, max(1, size // 4)) % len(_WORDS)
    i = 0
    while n < size:
        w = _WORDS[int(ranks[i % len(ranks)])]
        i += 1
        if sentence == 0:
            w = w.capitalize()
        sentence += 1
        if sentence >= int(rng.integers(6, 14)):
            w += "."
            sentence = 0
        out.append(w)
        n += len(w) + 1
    return (" ".join(out))[:size].encode()


def mixed_corpus(total: int, seed: int = 0) -> bytes:
    """A Silesia-like mixed-compressibility corpus: thirds of text-like,
    binary-like, and near-incompressible data."""
    third = total // 3
    parts = [
        gen_buffer(third, match_prob=0.80, seed=seed, lit_alphabet=26),
        gen_buffer(third, match_prob=0.55, seed=seed + 1, lit_alphabet=200),
        gen_buffer(total - 2 * third, match_prob=0.05, seed=seed + 2,
                   lit_alphabet=250),
    ]
    return b"".join(parts)


def knuth_hash16(words) -> np.ndarray:
    """B1's table slot of each 32-bit little-endian word: the top
    HASH_LOG (16) bits of its product with Knuth's multiplier."""
    from lz4_tpu_torch.block.encode_cuda import HASH_LOG, HASH_MUL
    w = np.asarray(words, dtype=np.uint64)
    return ((w * HASH_MUL) & 0xFFFFFFFF) >> (32 - HASH_LOG)


def gen_hash_walk(size: int, slots: int = 256, seed: int = 0) -> bytes:
    """Bytes whose every 4-byte window hashes (`knuth_hash16`) into one of
    `slots` random table slots, wherever some next byte allows it: the
    probes of one B1 scan window then share slots far more often than in
    real data."""
    rng = np.random.default_rng(seed)
    allowed = np.zeros(1 << 16, bool)
    allowed[rng.choice(1 << 16, slots, replace=False)] = True
    top = np.arange(256, dtype=np.uint64) << np.uint64(24)
    out = bytearray(rng.bytes(min(3, size)))
    for _ in range(3, size):
        base = out[-3] | (out[-2] << 8) | (out[-1] << 16)
        ok = np.nonzero(allowed[knuth_hash16(top | np.uint64(base))])[0]
        out.append(int(rng.choice(ok)) if ok.size
                   else int(rng.integers(256)))
    return bytes(out)


def gen_slot_words(size: int, pool: int = 64, seed: int = 0) -> bytes:
    """4-byte words drawn at random from `pool` distinct words that all
    hash (`knuth_hash16`) to one table slot, found by a numpy search over
    random words. At an acceleration whose skip is a multiple of 4, every
    probe of a B1 scan window from an aligned anchor lands in that slot;
    the repeats make real matches among them."""
    rng = np.random.default_rng(seed)
    cand = np.unique(rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint64))
    h = knuth_hash16(cand)
    words = cand[h == np.bincount(h.astype(np.int64)).argmax()][:pool]
    picks = words[rng.integers(0, words.size, (size + 3) // 4)]
    return picks.astype("<u4").tobytes()[:size]
