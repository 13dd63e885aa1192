"""Batched XXH32 on the device: kernel B6 (`csrc/xxh32.cu`) and its plain
PyTorch version.

Contract of `lz4_tpu.xxh32_device.xxh32_blocks` (and of
`xxh32_blocks_pallas`, which computes the same function): data
uint8[B, cap], lens int32[B], seed in [0, 2^32) -> the XXH32 of each row's
first lens[b] bytes. cap must be a multiple of 16; bytes past a row's
length are ignored. The values come back as an int64 tensor holding
[0, 2^32), since torch's uint32 has few operations.

Used to check a decoded batch on the device against host hashes of the
source blocks without copying the batch back (the port's bench).

B6 gives each row four lanes (lane k runs accumulator k), 8 rows to a
hashing warp and one hashing warp to a CTA (`grid_for`), beside a copy
warp that streams each row through a ring of `STAGES` stages of
`STAGE_BYTES` in shared memory with bulk copies (see `csrc/xxh32.cu`).
`XXH32SplitModel` follows that schedule on the CPU for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from lz4_tpu_torch import _build
from lz4_tpu_torch.block.batch import resolve_device

P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
P4 = 668265263
P5 = 374761393
_M32 = 0xFFFFFFFF

#: B6's layout (the constants of `csrc/xxh32.cu`)
LANES_PER_ROW = 4
ROWS_PER_WARP = 32 // LANES_PER_ROW
STAGE_BYTES = 2048
STAGES = 4
RING_PAD = 16

#: kernel launches made by `xxh32_blocks` (and nowhere else)
launches = 0


def _check(data, lens, seed, cap):
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8 \
            or data.dim() != 2:
        raise TypeError("data must be a uint8[B, cap] tensor")
    if cap <= 0 or cap % 16 or data.shape[1] != cap:
        raise ValueError(f"data must be uint8[B, {cap}] with cap a positive "
                         f"multiple of 16, got {tuple(data.shape)}")
    if not isinstance(lens, torch.Tensor) or lens.dtype != torch.int32 \
            or tuple(lens.shape) != (data.shape[0],):
        raise TypeError("lens must be an int32[B] tensor")
    for name, t in (("data", data), ("lens", lens)):
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, not {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")


def xxh32_blocks(data, lens, seed: int = 0, *, cap: int) -> torch.Tensor:
    """XXH32 of each row (see the module docstring). CPU tensors run the
    plain version; CUDA tensors launch B6. numpy arrays go to the GPU
    (raising where there is none)."""
    global launches
    if not isinstance(data, torch.Tensor):
        device = resolve_device(None)
        data = torch.as_tensor(data).to(device)
        lens = torch.as_tensor(lens).to(device)
    _check(data, lens, seed, cap)
    if data.is_cuda and data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary (B6 reads "
                         "16-byte stripes)")
    B = data.shape[0]
    out = torch.empty(B, dtype=torch.int64, device=data.device)
    res, n = _build.launch(
        "xxh32", "B6", data.device,
        lambda: xxh32_blocks_plain(data, lens, seed, cap=cap), out, data,
        lens, out, B, cap, int(seed))
    launches += n
    return res


def grid_for(B: int) -> int:
    """CTAs (8 rows each) of B6's launch over B rows."""
    return -(-B // ROWS_PER_WARP)


# --------------------------------------------------------------------------
# plain version: the stripe scan with a [B, 4] carry, in int64 masked to
# 32 bits (products split so that none overflows)
# --------------------------------------------------------------------------

def _mul(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) and a constant k < 2^32."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _round(acc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _mul(_rotl((acc + _mul(w, P2)) & _M32, 13), P1)


def xxh32_blocks_plain(data: torch.Tensor, lens: torch.Tensor,
                       seed: int = 0, *, cap: int) -> torch.Tensor:
    """Plain PyTorch version of B6 on CPU tensors (the JAX scan and its
    finalization)."""
    B = data.shape[0]
    d = data.to(torch.int64)
    w = d[:, 0::4] | (d[:, 1::4] << 8) | (d[:, 2::4] << 16) | \
        (d[:, 3::4] << 24)                                  # [B, cap/4]
    n = lens.to(torch.int64).clamp(0, cap)
    seed = int(seed) & _M32
    acc = torch.tensor([(seed + P1 + P2) & _M32, (seed + P2) & _M32, seed,
                        (seed - P1) & _M32], dtype=torch.int64)
    acc = acc.repeat(B, 1)                                   # [B, 4]
    stripes = w.reshape(B, cap // 16, 4)
    for s in range(cap // 16):
        active = ((s + 1) * 16 <= n)[:, None]
        acc = torch.where(active, _round(acc, stripes[:, s]), acc)
    h_big = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7)
             + _rotl(acc[:, 2], 12) + _rotl(acc[:, 3], 18)) & _M32
    h = torch.where(n >= 16, h_big, torch.full_like(n, (seed + P5) & _M32))
    h = (h + n) & _M32
    tail = (n // 16) * 16
    nw = (n - tail) // 4
    widx = tail // 4
    for k in range(3):
        wk = w.gather(1, (widx + k).clamp(max=w.shape[1] - 1)[:, None])[:, 0]
        h = torch.where(nw > k, _mul(_rotl((h + _mul(wk, P3)) & _M32, 17),
                                     P4), h)
    bstart = tail + nw * 4
    nb = n - bstart
    for k in range(3):
        bk = d.gather(1, (bstart + k).clamp(max=cap - 1)[:, None])[:, 0]
        h = torch.where(nb > k, _mul(_rotl((h + _mul(bk, P5)) & _M32, 11),
                                     P1), h)
    h = _mul(h ^ (h >> 15), P2)
    h = _mul(h ^ (h >> 13), P3)
    return h ^ (h >> 16)


# --------------------------------------------------------------------------
# model of B6's schedule (for the tests; nothing on the card calls it)
# --------------------------------------------------------------------------

_U32 = np.uint32
_ROT = (1, 7, 12, 18)                     # the merge's rotation of lane k
P1_INV = pow(P1, -1, 1 << 32)             # P1 is odd: acc = r * P1 has one r


def _rotl_np(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _rotl_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


class _Barrier:
    """An mbarrier: a phase completes when `count` arrivals have come and
    every byte they announced has landed."""

    def __init__(self, count: int):
        self.count, self.arrived, self.tx, self.phases = count, 0, 0, 0

    def arrive(self, tx: int = 0):
        self.arrived += 1
        self.tx += tx
        self._check()

    def land(self, nbytes: int):
        self.tx -= nbytes
        self._check()

    def _check(self):
        if self.arrived == self.count and self.tx == 0:
            self.phases += 1
            self.arrived = 0

    def done(self, phase: int) -> bool:
        """True once phase number `phase` has completed (a wait on its
        parity would pass)."""
        assert self.phases <= phase + 1, "wait on a parity two phases back"
        return self.phases > phase


class XXH32SplitModel:
    """B6's schedule on the CPU, actor by actor. Rows go to CTAs of 8
    (`grid_for`); each CTA has a hashing warp, whose lane k of group g runs
    accumulator k of row 8 * cta + g, and a copy warp, whose lane g starts
    row g's bulk copies. Each row's ceil16(n) bytes go in chunks of
    `stage_bytes` into a ring of `stages` stages (one ring per row,
    `RING_PAD` bytes apart): chunk c to stage c % stages. The copy warp
    waits until the hashing warp has released chunk c - stages (the
    stage's empty barrier), then every row's lane arrives on the stage's
    full barrier with the bytes it expects (rows past B and past their end
    with none) and starts its copy, which lands later. The hashing warp
    waits for chunk c on the full barrier's phase c // stages, runs the
    stripes of its rows that the chunk holds (lane k reads word k of each
    stripe, carrying r with acc = r * P1: r' = rotl(r * P1 + w * P2, 13)),
    and releases the stage. The four accumulators merge by two xor
    shuffles; the group's first lane adds the length, takes the tail words
    and bytes from the ring and applies the avalanche.

    A seeded scheduler runs one step at a time of a runnable actor (the
    copy warp, the hashing warp, a copy in flight) in a random order; a
    state where none can run is a hang and raises. Every copy asserts that
    it lies inside ceil16(n) <= cap and that its stage was released; every
    ring read that its stage holds the chunk it wants. The ring starts
    filled with 0xA5. `copies` lists (row, offset, bytes) of every bulk
    copy in the order started."""

    def __init__(self, stage_bytes: int = STAGE_BYTES, stages: int = STAGES,
                 seed: int = 0):
        if stage_bytes <= 0 or stage_bytes % 16 or stages <= 0:
            raise ValueError("stage_bytes must be a positive multiple of 16 "
                             "and stages positive")
        self.C = stage_bytes
        self.S = stages
        self.rng = np.random.default_rng(seed)
        self.copies: list[tuple[int, int, int]] = []

    def hash(self, data: np.ndarray, lens, seed: int = 0) -> np.ndarray:
        """uint32[B]: the XXH32 of each row's first lens[b] bytes."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        B, cap = data.shape
        if cap <= 0 or cap % 16:
            raise ValueError("cap must be a positive multiple of 16")
        lens = np.asarray(lens, dtype=np.int64)
        out = np.zeros(B, dtype=_U32)
        for cta in range(grid_for(B)):
            self._cta(cta, data, lens, int(seed) & _M32, out)
        return out

    def _cta(self, cta, data, lens, seed, out):
        B, cap = data.shape
        C, S, G = self.C, self.S, ROWS_PER_WARP
        rows = cta * G + np.arange(G)
        live = rows < B
        n = np.where(live, np.clip(lens[np.minimum(rows, B - 1)], 0, cap), 0)
        copy_bytes = (n + 15) // 16 * 16
        max_chunks = int((-(-copy_bytes // C)).max())  # __reduce_max_sync
        ring = np.full((G, S * C + RING_PAD), 0xA5, dtype=np.uint8)
        held = np.full((G, S), -1)                     # chunk in each stage
        full = [_Barrier(G) for _ in range(S)]
        empty = [_Barrier(1) for _ in range(S)]
        released = np.full(S, -1)                      # last chunk released
        flying = []                                    # copies not landed

        def copy_warp():
            for c in range(max_chunks):
                st = c % S
                while c >= S and not empty[st].done(c // S - 1):
                    yield False
                assert released[st] == c - S or c < S
                for g in range(G):                     # lane g
                    off = c * C
                    nb = max(0, min(C, int(copy_bytes[g]) - off))
                    full[st].arrive(nb)
                    if nb:
                        assert off + nb <= copy_bytes[g] <= cap
                        self.copies.append((int(rows[g]), off, nb))
                        flying.append((g, st, c, off, nb))
                yield True

        k = np.arange(LANES_PER_ROW)
        a0 = np.array([(seed + P1 + P2) & _M32, (seed + P2) & _M32, seed,
                       (seed - P1) & _M32], dtype=_U32)[k]
        r = np.tile(a0 * _U32(P1_INV), (G, 1))       # [group, lane]
        ns = n // 16
        per = C // 16

        def hashing_warp():
            nonlocal r
            for c in range(max_chunks):
                st = c % S
                while not full[st].done(c // S):
                    yield False
                cnt = np.clip(ns - c * per, 0, per)
                for g in np.nonzero(cnt)[0]:
                    assert held[g, st] == c, "stage holds another chunk"
                for i in range(int(cnt.max())):
                    words = ring[:, st * C + 16 * i: st * C + 16 * i + 16
                                 ].copy().view("<u4").astype(_U32)
                    new = _rotl_np(r * _U32(P1) + words * _U32(P2), 13)
                    r = np.where((i < cnt)[:, None], new, r)
                released[st] = c
                empty[st].arrive()
                yield True

        actors = [copy_warp(), hashing_warp()]
        blocked = set()                  # actors waiting since the last move
        while actors or flying:
            pick = int(self.rng.integers(len(actors) + len(flying)))
            if pick >= len(actors):                    # a copy lands
                g, st, c, off, nb = flying.pop(pick - len(actors))
                ring[g, st * C: st * C + nb] = data[rows[g], off: off + nb]
                held[g, st] = c
                full[st].land(nb)
                blocked.clear()
                continue
            try:
                moved = next(actors[pick])
            except StopIteration:
                actors.pop(pick)
                blocked.clear()
                continue
            if moved:
                blocked.clear()
            else:
                blocked.add(id(actors[pick]))
                if len(blocked) == len(actors) and not flying:
                    raise AssertionError("B6 schedule hangs")

        acc = r * _U32(P1)
        v = np.stack([_rotl_np(acc[:, j], rot) for j, rot in enumerate(_ROT)],
                     axis=1)
        v = v + v[:, [1, 0, 3, 2]]                     # __shfl_xor 1
        v = v + v[:, [2, 3, 0, 1]]                     # __shfl_xor 2
        for g in np.nonzero(live)[0]:                  # lane 4g
            ng = int(n[g])
            h = int(v[g, 0]) if ng >= 16 else (seed + P5) & _M32
            h = (h + ng) & _M32
            p = int(ns[g]) * 16
            if p < ng:
                st = (p // C) % S
                assert held[g, st] == p // C, "tail's stage was refilled"
                t = ring[g, st * C + p % C: st * C + p % C + (ng - p)]
                q = 0
                while q + 4 <= len(t):
                    wd = int.from_bytes(t[q: q + 4].tobytes(), "little")
                    h = _rotl_int((h + wd * P3) & _M32, 17) * P4 & _M32
                    q += 4
                for byte in t[q:]:
                    h = _rotl_int((h + int(byte) * P5) & _M32, 11) * P1 & _M32
            h ^= h >> 15
            h = h * P2 & _M32
            h ^= h >> 13
            h = h * P3 & _M32
            out[rows[g]] = h ^ (h >> 16)
