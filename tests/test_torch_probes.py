"""The probe kernels' plain versions (`lz4_tpu_torch.probes.walk_probe`,
`gather_probe`, `lane_probe`) against the TPU probes they port, on the
same numpy inputs, at cut sizes.

The TPU kernels sit inside each tool's main() and cannot be imported, so
each is restated here as the tool writes it (file and line beside each)
and run through `pl.pallas_call(..., interpret=True)` on the CPU. The
only change is the zero-fill of `wave_kern`'s scratch (see there). Cut
sizes: B 2 and R 64 for `tools/pallas_probe.py` (hops 512 steps), n 4096
bytes and e 512 steps for the walks, 4096 steps of the burn loop, NIT 64
and rows up to 512 for `tools/session_r4probe2.py`; beside them the walks
at the tool's counts and over the whole row, and the wave step past the
wrap of its history.

Tolerance: exact for every int32 body. The burn loop: the port rounds
each multiply and add to float32 (as its kernel does with `__fmul_rn` and
`__fadd_rn`), while XLA on the CPU fuses them into one FMA; after 4096
steps the two differ by about one unit in the last place, so they are
held to a relative 1e-6.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lz4_tpu_torch.probes import gather_probe, lane_probe  # noqa: E402
from lz4_tpu_torch.probes import walk_probe  # noqa: E402

N_CUT = 4096
E_CUT = 512
BURN_CUT = 4096
R, C, B = 64, 128, 2
N = R * C
HOPS_CUT = 512
NIT = 64

SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


# ------------------------------------------- session_pallas_probe2 / 3

def k_a(w_ref, n_ref, o_ref):
    # tools/session_pallas_probe3.py:81 (probe2's k_smem, :52, is the
    # same body with b = pl.program_id(0))
    b = pl.program_id(0) % 8
    n = n_ref[b]

    def body(st):
        p, acc = st
        byte = (w_ref[b, p // 4] >> (8 * (p % 4))) & 255
        return p + 1 + (byte & 3), acc + byte

    p, acc = jax.lax.while_loop(lambda st: st[0] < n, body,
                                (jnp.int32(0), jnp.int32(0)))
    o_ref[b] = acc


def k_smem(words_ref, n_ref, out_ref):
    # tools/session_pallas_probe2.py:52
    b = pl.program_id(0)
    n = n_ref[b]

    def body(st):
        p, acc = st
        w = words_ref[b, p // 4]
        byte = (w >> (8 * (p % 4))) & 255
        step = 1 + (byte & 3)
        return p + step, acc + byte

    p, acc = jax.lax.while_loop(lambda st: st[0] < n, body,
                                (jnp.int32(0), jnp.int32(0)))
    out_ref[b] = acc


def k_b(w_ref, n_ref, o_ref):
    # tools/session_pallas_probe3.py:97
    b = pl.program_id(0) % 8
    n = n_ref[b]

    def body(st):
        p, acc = st
        byte = (w_ref[b, p // 4] >> (8 * (p % 4))) & 255
        return p + 3, acc + byte

    p, acc = jax.lax.while_loop(lambda st: st[0] < n, body,
                                (jnp.int32(0), jnp.int32(0)))
    o_ref[b] = acc


def k_c(w_ref, n_ref, o_ref):
    # tools/session_pallas_probe3.py:113
    b = pl.program_id(0) % 8
    n = n_ref[b]

    def body(st):
        p, acc = st
        byte = (p * 7) & 255
        return p + 1 + (byte & 3), acc + byte

    p, acc = jax.lax.while_loop(lambda st: st[0] < n, body,
                                (jnp.int32(0), jnp.int32(0)))
    o_ref[b] = acc


def k_d(w_ref, n_ref, o_ref):
    # tools/session_pallas_probe3.py:130
    b = pl.program_id(0) % 8
    seg = n_ref[b] // 8

    def body(st):
        ps = st[:8]
        accs = st[8:16]
        ends = st[16:24]
        out = []
        outa = []
        for k in range(8):
            p = ps[k]
            byte = (w_ref[b, p // 4] >> (8 * (p % 4))) & 255
            adv = jnp.where(p < ends[k], 1 + (byte & 3), jnp.int32(0))
            out.append(p + adv)
            outa.append(accs[k] + jnp.where(p < ends[k], byte, 0))
        return tuple(out) + tuple(outa) + st[16:24]

    def cond(st):
        c = jnp.int32(0)
        for k in range(8):
            c = c + (st[k] < st[16 + k]).astype(jnp.int32)
        return c > 0

    init = tuple(jnp.int32(k) * seg for k in range(8)) \
        + tuple(jnp.int32(0) for _ in range(8)) \
        + tuple(jnp.int32(k + 1) * seg for k in range(8))
    st = jax.lax.while_loop(cond, body, init)
    acc = st[8]
    for k in range(9, 16):
        acc = acc + st[k]
    o_ref[b] = acc


def k_e(w_ref, n_ref, o_ref, steps=E_CUT):
    # tools/session_pallas_probe3.py:166, 26214 steps cut to E_CUT (the
    # tool's count in test_walk_plain_matches_tpu_kernel_at_full_size)
    b = pl.program_id(0) % 8

    def body(i, st):
        p, acc = st
        byte = (w_ref[b, p // 4] >> (8 * (p % 4))) & 255
        return (p + 1 + (byte & 3)) % 65536, acc + byte

    p, acc = jax.lax.fori_loop(0, steps, body,
                               (jnp.int32(0), jnp.int32(0)))
    o_ref[b] = acc


def k_burn(x_ref, o_ref):
    # tools/session_pallas_probe2.py:116, 200000 steps cut to BURN_CUT
    def body(i, acc):
        return acc * 1.000001 + x_ref[0]

    o_ref[pl.program_id(0)] = jax.lax.fori_loop(
        0, BURN_CUT, body, jnp.float32(0.0))


def _walk_tpu(kern, words, ns, grid):
    # tools/session_pallas_probe3.py:58 (probe2's call :74 is the same
    # with grid B); both under interpret=True here
    f = pl.pallas_call(
        kern, grid=(grid,), in_specs=[SMEM, SMEM], out_specs=SMEM,
        out_shape=jax.ShapeDtypeStruct((words.shape[0],), jnp.int32),
        interpret=True)
    return np.asarray(f(jnp.asarray(words), jnp.asarray(ns)))


WALK_KERNELS = {"a": k_a, "b": k_b, "c": k_c, "d": k_d, "d_warp": k_d,
                "e": k_e}


@pytest.fixture(scope="module")
def walk_inputs():
    return walk_probe.inputs(n=N_CUT)


@pytest.mark.parametrize("grid", [8, 16], ids=["grid8", "grid16"])
@pytest.mark.parametrize("variant", list(WALK_KERNELS))
def test_walk_plain_matches_tpu_kernel(walk_inputs, variant, grid):
    """Each walk variant (d_warp computes d's function) against the
    restated TPU body; grid 16 is LZ4_TPU_P3_GRID=16 (rows g % 8)."""
    words, ns = walk_inputs
    want = _walk_tpu(WALK_KERNELS[variant], words, ns, grid)
    acc, taken, cycles = walk_probe.walk(words, ns, variant, grid=grid,
                                         steps=E_CUT, device="cpu")
    assert cycles is None and acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    assert taken.shape == (grid,)
    if variant == "e":
        assert taken.tolist() == [E_CUT] * grid


def test_smem_plain_matches_probe2_kernel(walk_inputs):
    words, ns = walk_inputs
    want = _walk_tpu(k_smem, words, ns, words.shape[0])
    acc, _, _ = walk_probe.walk(words, ns, "a", device="cpu")
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("variant,n", [("a", 65536), ("a", 66560),
                                       ("d", 66560), ("e", 65536)],
                         ids=["a-tool-n", "a-whole-row", "d-whole-row",
                              "e-tool-steps"])
def test_walk_plain_matches_tpu_kernel_at_full_size(variant, n):
    """The tool's counts (n = 65,536 bytes, e 26,214 steps, so p wraps at
    65,536) and the whole 66,560-byte row, past the cut's first 4 KB."""
    words, ns = walk_probe.inputs(n=n)
    kern = (functools.partial(k_e, steps=walk_probe.E_STEPS)
            if variant == "e" else WALK_KERNELS[variant])
    want = _walk_tpu(kern, words, ns, 8)
    acc, taken, _ = walk_probe.walk(words, ns, variant, device="cpu")
    np.testing.assert_array_equal(acc.numpy(), want)
    if variant == "e":
        assert taken.tolist() == [walk_probe.E_STEPS] * 8


def test_walk_steps_match_a_host_replay(walk_inputs):
    """The chain steps the port reports (its ns and cycles a step divide
    by them) against a replay of the tool's host check (probe2:90-101)."""
    words, ns = walk_inputs
    acc, taken, _ = walk_probe.walk(words, ns, "a", device="cpu")
    for i in range(words.shape[0]):
        p = a = k = 0
        while p < N_CUT:
            byte = (int(words[i][p // 4]) >> (8 * (p % 4))) & 255
            p += 1 + (byte & 3)
            a += byte
            k += 1
        assert (int(acc[i]), int(taken[i])) == (a & 0xFFFFFFFF, k)
    d, dtaken, _ = walk_probe.walk(words, ns, "d", device="cpu")
    dw, dwtaken, _ = walk_probe.walk(words, ns, "d_warp", device="cpu")
    assert torch.equal(d, dw) and torch.equal(dtaken, dwtaken)


def test_walk_clamps_n_to_the_row():
    words, _ = walk_probe.inputs(rows=2, words=64)
    ns = np.array([10**6, -5], np.int32)
    acc, taken, _ = walk_probe.walk(words, ns, "a", device="cpu")
    whole, _, _ = walk_probe.walk(words, np.array([256, 0], np.int32), "a",
                                  device="cpu")
    assert torch.equal(acc, whole) and int(taken[1]) == 0


@pytest.mark.parametrize("mode", ["arbitrary", "parallel"])
def test_burn_plain_matches_tpu_kernel(mode):
    f = pl.pallas_call(
        k_burn, grid=(16,), in_specs=[SMEM], out_specs=SMEM,
        out_shape=jax.ShapeDtypeStruct((16,), jnp.float32),
        compiler_params=pltpu.CompilerParams(dimension_semantics=(mode,)),
        interpret=True)
    want = np.asarray(f(jnp.ones((1,), jnp.float32)))
    got, cycles = walk_probe.burn(np.ones(1, np.float32), mode,
                                  steps=BURN_CUT, device="cpu")
    assert cycles is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_burn_plain_rounds_each_op_to_float32():
    """The kernel's __fmul_rn / __fadd_rn: a float32 rounding after the
    multiply and after the add, step by step."""
    got, _ = walk_probe.burn(np.full(1, 0.75, np.float32), "parallel",
                             steps=300, grid=2, device="cpu")
    acc = np.float32(0)
    for _ in range(300):
        acc = np.float32(np.float32(acc * np.float32(1.000001))
                         + np.float32(0.75))
    assert got.tolist() == [float(acc)] * 2


# ------------------------------------------------------- pallas_probe

def _vcall(kernel, n_in, out_shape, *xs):
    # tools/pallas_probe.py:64 (`call`), vmapped over blocks as the tool
    f = pl.pallas_call(kernel, out_shape=out_shape,
                       in_specs=[VMEM] * n_in, out_specs=VMEM,
                       interpret=True)
    return np.asarray(jax.vmap(f)(*(jnp.asarray(x) for x in xs)))


def k_lane(x_ref, i_ref, o_ref):
    # tools/pallas_probe.py:78
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=1)


def k_flat(x_ref, i_ref, o_ref):
    # tools/pallas_probe.py:89
    flat = x_ref[:].reshape(-1)
    o_ref[:] = jnp.take(flat, i_ref[:].reshape(-1), axis=0).reshape(R, C)


def k_row(x_ref, i_ref, o_ref):
    # tools/pallas_probe.py:103
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=0)


def k_chase(p_ref, o_ref):
    # tools/pallas_probe.py:115
    ptr = p_ref[:].reshape(-1)
    for _ in range(8):
        nxt = jnp.take(ptr, jnp.clip(ptr, 0, N - 1), axis=0)
        ptr = jnp.where(ptr >= 0, nxt, ptr)
    o_ref[:] = ptr.reshape(R, C)


def k_hops(nm_ref, ml_ref, o_ref):
    # tools/pallas_probe.py:134, STEPS = 8192 cut to HOPS_CUT
    def body(k, cur):
        r = cur // C
        c = cur % C
        step = ml_ref[r, c]
        nxt_lin = jnp.minimum(cur + step, N - 1)
        nxt = nm_ref[nxt_lin // C, nxt_lin % C]
        o_ref[k // C, k % C] = cur
        return nxt

    jax.lax.fori_loop(0, HOPS_CUT, body, jnp.int32(0))


@pytest.fixture(scope="module")
def gather_inputs():
    return gather_probe.inputs(b=B, r=R, c=C)


def _tpu_gather(body, d):
    i32 = jnp.int32
    if body == "chase":
        return _vcall(k_chase, 1, jax.ShapeDtypeStruct((R, C), i32),
                      d["chase"])
    if body == "hops":
        return _vcall(k_hops, 2,
                      jax.ShapeDtypeStruct((HOPS_CUT // C, C), i32),
                      d["nm"], d["ml"])
    kern = {"lane": k_lane, "flat": k_flat, "row": k_row}[body]
    return _vcall(kern, 2, jax.ShapeDtypeStruct((R, C), i32), d["x"],
                  d[body])


@pytest.mark.parametrize("body", list(gather_probe.VARIANTS))
def test_gather_plain_matches_tpu_kernel(gather_inputs, body):
    d = gather_inputs
    want = _tpu_gather(body, d)
    args = gather_probe._args(body, d)
    got, stats = gather_probe.gather(
        body, *args, steps=HOPS_CUT if body == "hops" else None,
        device="cpu")
    assert stats is None and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("body,axis", [("lane", 2), ("row", 1),
                                       ("flat", None)])
def test_gather_out_of_range_indices_wrap(body, axis):
    """Out-of-range and negative indices wrap mod the gathered extent (the
    TPU's semantics), held to numpy's % (XLA on the CPU clamps instead)."""
    rng = np.random.default_rng(11)
    x = rng.integers(-2**31, 2**31, (B, R, C), dtype=np.int32)
    idx = rng.integers(-3 * N, 3 * N, (B, R, C), dtype=np.int32)
    got, _ = gather_probe.gather(body, x, idx, device="cpu")
    if axis is None:
        want = np.take_along_axis(x.reshape(B, N), idx.reshape(B, N) % N,
                                  1).reshape(B, R, C)
    else:
        want = np.take_along_axis(x, idx % x.shape[axis], axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hops_wrap_a_negative_cursor():
    """A cursor or a next index outside [0, N) reads element mod N; cur +
    step is taken without wrapping and capped at N - 1."""
    rng = np.random.default_rng(12)
    nm = rng.integers(-3 * N, 3 * N, (1, R, C), dtype=np.int32)
    ml = rng.integers(-50, 50, (1, R, C), dtype=np.int32)
    got, _ = gather_probe.gather("hops", nm, ml, steps=C, device="cpu")
    nmf, mlf = nm.reshape(-1).astype(np.int64), ml.reshape(-1)
    cur, want = 0, []
    for _ in range(C):
        want.append(cur)
        cur = int(nmf[min(cur + int(mlf[cur % N]), N - 1) % N])
    assert got.reshape(-1).tolist() == want


# ------------------------------------------------------ session_r4probe2

def ta(x, idx, axis):
    # tools/session_r4probe2.py:74
    return jnp.take_along_axis(x, jnp.broadcast_to(idx, x.shape), axis)


def two_step(s, w):
    # tools/session_r4probe2.py:119
    c = jnp.broadcast_to(w[0:1, :] % 128, s.shape)
    r = jnp.broadcast_to((w[0:1, :] // 128) % 8, s.shape)
    b = ta(s, c, 1)                # B[i,j] = s[i, c[j]]
    return ta(b, r, 0)             # out[i,j] = s[r[j], c[j]]


def _kern_call(fn, src, idx):
    # tools/session_r4probe2.py:81 (`kern`) and its call :85
    def kern(s_ref, i_ref, o_ref):
        o_ref[:] = fn(s_ref[:], i_ref[:])

    f = pl.pallas_call(
        kern, in_specs=[VMEM, VMEM], out_specs=VMEM,
        out_shape=jax.ShapeDtypeStruct(src.shape, jnp.int32),
        interpret=True)
    return np.asarray(f(jnp.asarray(src), jnp.asarray(idx)))


CHECKS = {"c_a0_8": ("a0", lambda s, i: ta(s, i, 0)),
          "c_a1_8": ("a1", lambda s, i: ta(s, i, 1)),
          "c_2step": ("2step", two_step),
          "c_a0_64": ("a0", lambda s, i: ta(s, i, 0)),
          "c_a0_512": ("a0", lambda s, i: ta(s, i, 0))}


@pytest.fixture(scope="module")
def lane_inputs():
    return lane_probe.inputs()


@pytest.mark.parametrize("body", list(CHECKS))
def test_lane_gather_plain_matches_tpu_kernel(lane_inputs, body):
    kind, fn = CHECKS[body]
    src, idx = lane_inputs[body]
    want = _kern_call(fn, src, idx)
    got = lane_probe.gather(kind, src, idx, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,rows", [("a0", 8), ("a0", 64), ("a1", 8)])
def test_lane_gather_out_of_range_wraps(kind, rows):
    """The tool's a0_8_mod check (r4probe2:108-111, TPU only) and its
    kin: indices out of range, negative ones too, wrap mod the extent;
    plain against numpy's %."""
    rng = np.random.default_rng(rows)
    src = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int32)
    idx = rng.integers(-5000, 5000, (rows, 128), dtype=np.int32)
    got = lane_probe.gather(kind, src, idx, device="cpu")
    axis = 0 if kind == "a0" else 1
    want = np.take_along_axis(src, idx % src.shape[axis], axis)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "a0" and rows == 8:
        mod_src, mod_idx = lane_probe.inputs()["c_a0_8_mod"]
        assert mod_idx.min() >= 16
        np.testing.assert_array_equal(
            lane_probe.gather("a0", mod_src, mod_idx, device="cpu").numpy(),
            np.take_along_axis(mod_src, mod_idx % 8, 0))


def test_two_step_floor_semantics_for_negative_words():
    """w // 128 and w % 128 round toward minus infinity, as jnp's do."""
    rng = np.random.default_rng(13)
    src = rng.integers(0, 2**30, (8, 128), dtype=np.int32)
    w = rng.integers(-2**31, 2**31, (8, 128), dtype=np.int32)
    assert (w[0] < 0).any()
    got = lane_probe.gather("2step", src, w, device="cpu")
    want = _kern_call(two_step, src, w)
    np.testing.assert_array_equal(got.numpy(), want)
    row = src[(w[0] // 128) % 8, w[0] % 128]
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(row, (8, 128)))


def mk_loop(body_fn, n_iter):
    # tools/session_r4probe2.py:178
    def kern(s_ref, o_ref):
        src = s_ref[:8, :]

        def body(i, acc):
            return body_fn(s_ref, acc, i)

        acc0 = src
        o_ref[:] = jax.lax.fori_loop(0, n_iter, body, acc0)
    return kern


def b_base(s_ref, acc, i):
    # tools/session_r4probe2.py:191
    idx = (acc + i) & 7
    return acc ^ idx


def b_a0_8(s_ref, acc, i):
    # tools/session_r4probe2.py:197
    idx = (acc + i) & 7
    g = ta(s_ref[:8, :], idx, 0)
    return acc ^ g


def b_a1_8(s_ref, acc, i):
    # tools/session_r4probe2.py:204
    idx = (acc + i) & 127
    g = ta(s_ref[:8, :], idx, 1)
    return acc ^ g


def b_2step(s_ref, acc, i):
    # tools/session_r4probe2.py:211
    w = (acc + i) & 1023
    g = two_step(s_ref[:8, :], w)
    return acc ^ g


def mk_a0_big(rows):
    # tools/session_r4probe2.py:218
    def b(s_ref, acc, i):
        idx = (acc + i) % rows
        g = ta(s_ref[:], jnp.broadcast_to(idx[0:1, :], (rows, 128)), 0)
        return acc ^ g[:8, :]
    return b


def b_onehot(s_ref, acc, i):
    # tools/session_r4probe2.py:233
    idx = (acc[0:1, :] + i) % 512
    rows = jax.lax.broadcasted_iota(jnp.int32, (512, 128), 0)
    oh = (rows == idx).astype(jnp.int32)
    g = jnp.sum(oh * s_ref[:], axis=0, keepdims=True)
    return acc ^ g


def _loop_tpu(body_fn, src, n_iter):
    # tools/session_r4probe2.py:151 (`bench`'s call), interpret=True
    f = pl.pallas_call(
        mk_loop(body_fn, n_iter), in_specs=[VMEM], out_specs=VMEM,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        interpret=True)
    return np.asarray(f(jnp.asarray(src)))


LOOPS = {"t_base": ("base", b_base, 1), "t_a0_8": ("a0_8", b_a0_8, 1),
         "t_a1_8": ("a1_8", b_a1_8, 1), "t_2step": ("2step", b_2step, 1),
         "t_a0_64": ("a0_big", mk_a0_big(64), 1),
         "t_a0_512": ("a0_big", mk_a0_big(512), 4),
         "t_onehot": ("onehot", b_onehot, 4)}


@pytest.mark.parametrize("body", list(LOOPS))
def test_lane_loop_plain_matches_tpu_kernel(lane_inputs, body):
    """mk_loop's bodies at NIT = 64 (a0_512 and onehot NIT / 4, as the
    tool's n512)."""
    kind, fn, frac = LOOPS[body]
    src, _ = lane_inputs[body]
    want = _loop_tpu(fn, src, NIT // frac)
    got, stats = lane_probe.loop(kind, src, NIT // frac, device="cpu")
    assert stats is None
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_loop_wraps_like_int32():
    """Sources over the whole int32 range: acc + i and the one-hot sum
    wrap as jnp's int32 does."""
    rng = np.random.default_rng(14)
    for kind, fn, rows in (("a0_8", b_a0_8, 8), ("2step", b_2step, 8),
                           ("onehot", b_onehot, 512)):
        src = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int32)
        got, _ = lane_probe.loop(kind, src, 16, device="cpu")
        np.testing.assert_array_equal(got.numpy(), _loop_tpu(fn, src, 16))


def wave_kern(s_ref, o_ref, out_scr, nw=None):
    # tools/session_r4probe2.py:248, NW = NIT // 8 (NW_CUT unless `nw`
    # is given). The one change: the
    # scratch is zero-filled first. The TPU leaves it undefined (the
    # interpreter reads INT32_MIN) and the body reads it before writing
    # it; the port zero-fills its history, so the restatement does too.
    out_scr[:] = jnp.zeros(out_scr.shape, jnp.int32)

    def body(i, acc):
        # comp fetch: two adjacent words per lane from a 4KB window
        w = (acc + i) & 1023
        g0 = two_step(s_ref[:8, :], w)
        g1 = two_step(s_ref[:8, :], (w + 1) & 1023)
        # parse ALU ~40 vector ops
        t = g0
        for sh in (4, 8, 12, 16, 20):
            t = t ^ ((g1 >> sh) & 255)
            t = t + ((g0 >> sh) & 15)
            t = jnp.where((t & 1) > 0, t + g1, t - g0)
        # near-window match gather from out history (512 rows)
        midx = jnp.broadcast_to((t[0:1, :] + i) % 512, (512, 128))
        mg = ta(out_scr[:], midx, 0)[:8, :]
        # phase combine + boundary selects (~15 ops)
        v = jnp.where((t & 2) > 0, mg, g0)
        v = (v << 8) | (mg & 255)
        v = v ^ (g1 & t)
        # dense row store at advancing q
        q = i & 511
        out_scr[pl.ds(q, 1), :] = v[0:1, :]
        return acc ^ v

    acc0 = s_ref[:8, :]
    o_ref[:] = jax.lax.fori_loop(0, NW_CUT if nw is None else nw, body,
                                 acc0)


NW_CUT = NIT // 8


def _wave_tpu(src, nw=None):
    # tools/session_r4probe2.py:278, interpret=True
    f = pl.pallas_call(
        functools.partial(wave_kern, nw=nw), in_specs=[VMEM], out_specs=VMEM,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        scratch_shapes=[pltpu.VMEM((512, 128), jnp.int32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(src)))


@pytest.mark.parametrize("nw", [NW_CUT, 1100], ids=["cut", "past-wrap"])
def test_wave_plain_matches_tpu_kernel(lane_inputs, nw):
    """At 1100 steps the 512-row history wraps twice, so the gathers read
    rows written a lap before."""
    src, _ = lane_inputs["t_wave"]
    got, stats = lane_probe.wave(src, nw, device="cpu")
    assert stats is None
    np.testing.assert_array_equal(got.numpy(), _wave_tpu(src, nw))


def test_wave_negative_t_floor_mod_and_shift_wrap():
    """Sources over the whole int32 range drive t negative, so (t + i) %
    512 must be a floor mod, and v << 8 must wrap in int32."""
    rng = np.random.default_rng(15)
    src = rng.integers(-2**31, 2**31, (8, 128), dtype=np.int32)
    got, _ = lane_probe.wave(src, NW_CUT, device="cpu")
    np.testing.assert_array_equal(got.numpy(), _wave_tpu(src))
    # t of the first step (the body's parse ALU in int32) is negative in
    # some lanes, so the floor mod is exercised
    s8 = src.astype(np.int64)
    w0 = s8[0] & 1023
    g0 = s8[(w0 // 128) % 8, w0 % 128]
    w1 = (w0 + 1) & 1023
    g1 = s8[(w1 // 128) % 8, w1 % 128]
    t = g0
    for sh in (4, 8, 12, 16, 20):
        t = (t ^ ((g1 >> sh) & 255)) + ((g0 >> sh) & 15)
        t = np.where(t & 1, t + g1, t - g0)
        t = (t + 2**31) % 2**32 - 2**31
    assert (t < 0).any()


@pytest.mark.parametrize("fn,args", [
    (lambda: walk_probe.walk(np.zeros((2, 8), np.int64),
                             np.zeros(2, np.int32), "a", device="cpu"),
     "int32"),
    (lambda: walk_probe.walk(np.zeros((2, 8), np.int32),
                             np.zeros(3, np.int32), "a", device="cpu"),
     "ns must be"),
    (lambda: walk_probe.walk(np.zeros((2, 8), np.int32),
                             np.zeros(2, np.int32), "e", device="cpu"),
     "64 KB"),
    (lambda: walk_probe.walk(np.zeros((2, 8), np.int32),
                             np.zeros(2, np.int32), "z", device="cpu"),
     "variant"),
    (lambda: walk_probe.burn(np.ones(2, np.float32), "parallel",
                             device="cpu"), "float32\\[1\\]"),
    (lambda: gather_probe.gather("lane", np.zeros((1, 6, 128), np.int32),
                                 np.zeros((1, 6, 128), np.int32),
                                 device="cpu"), "powers of two"),
    (lambda: gather_probe.gather("hops", np.zeros((1, 8, 128), np.int32),
                                 np.zeros((1, 8, 128), np.int32), steps=100,
                                 device="cpu"), "multiple"),
    (lambda: lane_probe.gather("a1", np.zeros((16, 128), np.int32),
                               np.zeros((16, 128), np.int32), device="cpu"),
     "8 rows"),
    (lambda: lane_probe.loop("a0_big", np.zeros((8, 64), np.int32), 4,
                             device="cpu"), "int32\\[rows, 128\\]"),
    (lambda: lane_probe.wave(np.zeros((16, 128), np.int32), 4,
                             device="cpu"), "int32\\[8, 128\\]"),
], ids=["walk-dtype", "walk-ns", "walk-e-row", "walk-variant", "burn-x",
        "gather-pow2", "hops-steps", "lane-a1-rows", "loop-src", "wave-src"])
def test_probe_wrappers_check_their_arguments(fn, args):
    with pytest.raises((TypeError, ValueError), match=args):
        fn()


# ------------------------- the redesigned gathers' work split (P4 0-2, P1 0-2)
#
# A model of which thread writes which output word and which source word
# it reads, mirroring the launchers' grid arithmetic and the kernels' index
# math (`csrc/probe_lane.cu`: launch_gather, gather_kernel;
# `csrc/probe_gather.cu`: lane_kernel, direct_kernel, source_of and the
# launcher's switch), vectorised over threads. The 16-byte and the 4-byte
# instantiations split the work the same way. Each model is held to the
# plain version, and every output word must be written exactly once.

THREADS = 256                 # kGatherThreads, kThreads
TILE = 128                    # kTile: a warp's words in lane_kernel
MAX_GRID = 1 << 20            # kMaxGrid
STRIP_COLS = 32               # kStripCols: row_kernel's strip width
STRIP_WORDS = 16384           # kStripWords
FLAT_THREADS = 512            # kFlatThreads
PIECE_WORDS = 16384           # kPieceWords: flat_kernel's piece of x
FLAT_WORDS = (1024, 65536)    # kFlatMinWords, kFlatMaxWords
INDEX_KINDS = ("random", "out-of-range", "negative", "full")


def _indices(kind, extent, shape, seed):
    rng = np.random.default_rng(seed)
    lo, hi = {"random": (0, extent), "out-of-range": (extent, 4 * extent),
              "negative": (-3 * extent, 0),
              "full": (-2**31, 2**31)}[kind]
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _apply_split(written, read, src, idx_total):
    """Output of a split: every written word exactly once, from src."""
    counts = np.bincount(written, minlength=idx_total)
    assert counts.shape == (idx_total,) and (counts == 1).all()
    out = np.empty(idx_total, np.int32)
    out[written] = src.reshape(-1)[read]
    return out


def p4_split(kind, rows, idx):
    """(written, read) word indices of P4's gather over its grid: rows *
    128 / 4 / 256 CTAs, thread g = cta * 256 + t takes words 4g..4g+3."""
    grid = rows * (128 // 4) // THREADS
    g = (np.arange(grid)[:, None] * THREADS
         + np.arange(THREADS)[None, :]).reshape(-1)
    g = g[g < rows * (128 // 4)]
    e = 4 * g[:, None] + np.arange(4)[None, :]           # [threads, 4]
    r, c = e // 128, e % 128
    w = idx.reshape(-1)[c if kind == "2step" else e]
    u = w.astype(np.int64) & 0xFFFFFFFF                   # uint32
    if kind == "a0":
        at = (u & (rows - 1)) * 128 + c
    elif kind == "a1":
        at = r * 128 + (u & 127)
    else:
        at = ((u >> 7) & 7) * 128 + (u & 127)
    return e.reshape(-1), at.reshape(-1)


P4_SPLITS = [("a0", r) for r in (8, 16, 64, 512, 4096, 32768)] + [
    ("a1", 8), ("2step", 8)]


@pytest.mark.parametrize("ikind", INDEX_KINDS)
@pytest.mark.parametrize("kind,rows", P4_SPLITS,
                         ids=[f"{k}-{r}" for k, r in P4_SPLITS])
def test_p4_gather_split_model(kind, rows, ikind):
    rng = np.random.default_rng(rows)
    src = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(
        np.int32)
    extent = {"a0": rows, "a1": 128, "2step": 1024}[kind]
    idx = _indices(ikind, extent, (rows, 128), rows + 1)
    written, read = p4_split(kind, rows, idx)
    got = _apply_split(written, read, src, rows * 128).reshape(rows, 128)
    want = lane_probe.gather(kind, src, idx, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _p1_threads(items, per_cta):
    """The items (word groups, or a warp's tiles) that the launcher's
    grid_of(items, per_cta) and the kernels' grid-stride loops visit:
    worker = cta * per_cta + t takes items worker + j * grid * per_cta."""
    grid = min(-(-items // per_cta), MAX_GRID)
    stride = grid * per_cta
    first = np.arange(stride)
    item = (first[:, None] + stride * np.arange(-(-items // stride))[None, :])
    return item[item < items]


def p1_split(body, b, r, c, idx):
    """(written, read) word indices of P1's lane, flat or row over the
    launcher's grid: lane_kernel where body is lane and C <= 128,
    row_kernel where body is row, C >= 4 and R * min(C, 32) <= 16384,
    flat_kernel where body is flat and 1024 <= N <= 65536, else
    direct_kernel."""
    total = b * r * c
    lr, lc = r.bit_length() - 1, c.bit_length() - 1
    w_all = idx.reshape(-1).astype(np.int64) & 0xFFFFFFFF   # uint32
    width = min(c, STRIP_COLS)
    if body == "row" and c >= 4 and r * width <= STRIP_WORDS:
        q4, parts = width // 4, c // width
        t = _p1_threads(b * parts, 1)                     # a CTA's strips
        blk, c0 = (t // parts) * r * c, (t % parts) * width
        g = (np.arange(THREADS)[:, None]
             + THREADS * np.arange(STRIP_WORDS // 4 // THREADS)[None, :])
        g = g[g < r * q4]                                 # a thread's groups
        rr, q = g // q4, g % q4
        k = np.arange(4)
        e = ((blk + c0)[:, None, None] + (rr * c + 4 * q)[None, :, None]
             + k).reshape(-1)
        # strip[p] holds x[blk + (p // W) * C + c0 + p % W]; the kernel
        # reads p = (idx mod R) * W + 4q + k
        pos = ((w_all[e] & (r - 1)) * width
               + np.broadcast_to((4 * q)[None, :, None] + k,
                                 (t.size, g.size, 4)).reshape(-1))
        base = np.repeat(blk + c0, g.size * 4)
        return e, base + (pos // width) * c + pos % width
    if body == "lane" and c <= TILE:
        tiles = _p1_threads(-(-total // TILE), THREADS // 32)
        e = (tiles[:, None] * TILE + 4 * np.arange(32)[None, :]).reshape(-1)
        e = (e[:, None] + np.arange(4)[None, :]).reshape(-1)
        e = e[e < total]
        i = e % TILE                                # the word in the tile
        at = (e - i) + (i & ~(c - 1)) + (w_all[e] & (c - 1))
        return e, at
    n = r * c
    if body == "flat" and FLAT_WORDS[0] <= n <= FLAT_WORDS[1]:
        p = min(n, PIECE_WORDS)
        t = _p1_threads(b * (n // p), 1)                # a CTA's chunks
        blk = t // (n // p) * n
        first = blk + t % (n // p) * p
        g = (np.arange(FLAT_THREADS)[:, None] + FLAT_THREADS
             * np.arange(PIECE_WORDS // 4 // FLAT_THREADS))
        g = g[g < p // 4]                               # a thread's groups
        e = (first[:, None, None] + 4 * g[None, :, None]
             + np.arange(4)).reshape(-1)
        u = w_all[e] & (n - 1)
        # piece u // P holds x[blk + (u // P) * P + i] at i
        return e, np.repeat(blk, g.size * 4) + (u // p) * p + (u & (p - 1))
    groups = _p1_threads(-(-total // 4), THREADS)
    e = (4 * groups[:, None] + np.arange(4)[None, :]).reshape(-1)
    e = e[e < total]
    u = w_all[e]
    n_mask = (1 << (lr + lc)) - 1
    if body == "lane":
        at = (e & ~((1 << lc) - 1)) | (u & ((1 << lc) - 1))
    elif body == "flat":
        at = (e & ~n_mask) | (u & n_mask)
    else:
        at = (e & ~n_mask) | ((u & ((1 << lr) - 1)) << lc) | (e & (c - 1))
    return e, at


P1_SHAPES = [(1, 1, 1), (3, 8, 4), (2, 64, 128), (5, 512, 128),
             (1, 16, 8192), (1, 8192, 16)]


@pytest.mark.parametrize("ikind", INDEX_KINDS)
@pytest.mark.parametrize("shape", P1_SHAPES,
                         ids=["x".join(map(str, s)) for s in P1_SHAPES])
@pytest.mark.parametrize("body", ["lane", "row", "flat"])
def test_p1_gather_split_model(body, shape, ikind):
    b, r, c = shape
    rng = np.random.default_rng(r * c + b)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    extent = {"lane": c, "row": r, "flat": r * c}[body]
    idx = _indices(ikind, extent, shape, b + r + c)
    written, read = p1_split(body, b, r, c, idx)
    got = _apply_split(written, read, x, b * r * c).reshape(shape)
    want, _ = gather_probe.gather(body, x, idx, device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
