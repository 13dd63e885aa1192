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
