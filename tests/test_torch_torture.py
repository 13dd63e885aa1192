"""The port's differential fuzzer (`lz4_tpu_torch.probes.torture`, the port
of tools/torture.py) against the JAX package: its payload draws, its
mutated streams through both packages' decoders, a planted fault, and a
short run of the tool's CLI on the plain versions.

Tolerance: exact (verdicts and bytes)."""
import json
import random
import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

from lz4_tpu.block import backend as jax_backend
from lz4_tpu.block import decode_jax
from lz4_tpu.block.decode_pallas import decode_blocks_pallas
from lz4_tpu.block.ref_codec import BlockDecodeError as JaxBlockDecodeError
from lz4_tpu.utils import datagen as jax_datagen
from lz4_tpu_torch.block import decode_cuda
from lz4_tpu_torch.block.batch import pack_blocks, to_device_batch
from lz4_tpu_torch.probes import torture

SEEDS = [3, 17, 101, 2024, 65537, 123456, 777777, 31415926]


def _tool_rand_payload(r):
    """tools/torture.py:117-129, on the JAX package's datagen."""
    kind = r.randrange(4)
    size = r.choice([0, 1, 7, 13, 100, 4096, 65536, 70000, 200000])
    if kind == 0:
        return jax_datagen.gen_buffer(
            size, match_prob=r.choice([0.0, 0.4, 0.9]),
            seed=r.randrange(1 << 30))
    if kind == 1:
        return jax_datagen.gen_text(size, seed=r.randrange(1 << 30))
    if kind == 2:
        return bytes([r.randrange(4)]) * size
    return random.Random(r.randrange(1 << 30)).randbytes(size)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_rand_payload_matches_the_tool(seed):
    a, b = random.Random(seed), random.Random(seed)
    for _ in range(4):
        assert torture.rand_payload(a) == _tool_rand_payload(b)
    assert a.random() == b.random()


def _verdict(fn):
    try:
        return fn()
    except (JaxBlockDecodeError, torture.BlockDecodeError):
        return None


def _rows(stream, d, cap_in):
    return pack_blocks([stream], [d], cap=cap_in, with_dict=bool(d))


def _pallas_decode(stream, cap, d):
    """decode_blocks_pallas in interpret mode at the port's B2 shape."""
    src, lens, db, dl = _rows(stream, d, max(4352, len(stream)))
    o, ol, er = decode_blocks_pallas(
        jnp.asarray(src), jnp.asarray(lens),
        None if db is None else jnp.asarray(db),
        None if dl is None else jnp.asarray(dl), cap_out=4096,
        interpret=True)
    if int(np.asarray(er)[0]):
        return None
    out = np.asarray(o)[0, : int(np.asarray(ol)[0])].tobytes()
    return None if len(out) > cap else out


def _b2_plain(stream, cap, d):
    """B2's plain version at the same shape."""
    o, ol, er = decode_cuda.decode_blocks(
        *to_device_batch(*_rows(stream, d, max(4352, len(stream))),
                         device="cpu"), cap_out=4096)
    if int(er[0]):
        return None
    out = o[0, : int(ol[0])].numpy().tobytes()
    return None if len(out) > cap else out


@pytest.mark.parametrize("seed", SEEDS)
def test_mutated_streams_agree_across_packages(seed):
    """A <= 4 KB payload, compressed by the port's host C and mutated by
    the port's `mutate`: every decoder of both packages gives the same
    verdict, and the same bytes where it accepts."""
    r = random.Random(seed)
    raw = b""
    while not raw:
        raw = torture.rand_payload(r)[:4096]
    d = (torture.rand_payload(r)[:r.choice([0, 100, 65536])] or None
         if seed % 2 else None)
    opts = torture.Options(device="cpu")
    comp = opts.host.compress_batch([raw], level=r.choice([0, 1, 9]),
                                    dict_prefixes=[d])[0]
    m = torture.mutate(comp, r)
    cap = len(raw)
    got = {
        "jax host": _verdict(lambda: jax_backend.HostBackend()
                             .decompress_batch([m], [cap],
                                               dict_prefixes=[d])[0]),
        "jax pallas": _pallas_decode(m, cap, d),
        "jax decode_jax": _verdict(lambda: decode_jax.decode_blocks_host(
            [m], [cap], dict_prefixes=[d] if d else None)[0]),
        "port host": torture.host_decode(m, cap, d, opts),
        "port B2 plain": _b2_plain(m, cap, d),
        "port sortscan": torture.device_decode(m, cap, d, opts),
    }
    assert len(set(got.values())) == 1, {k: None if v is None else len(v)
                                         for k, v in got.items()}
    # the unmutated stream decodes everywhere
    assert torture.host_decode(comp, cap, d, opts) == raw
    assert _b2_plain(comp, cap, d) == raw


def test_planted_fault_names_the_seed(monkeypatch):
    """A device leg that accepts what host C rejects fails the cycle,
    and the failure names the cycle's seed."""
    def accept_all(comp, cap, d, opts):
        out = torture.host_decode(comp, cap, d, opts)
        return b"" if out is None else out

    monkeypatch.setattr(torture, "device_decode", accept_all)
    opts = torture.Options(device="cpu", kernels=True)
    counters = Counter()
    for cseed in range(300):
        try:
            torture.run_cycle(cseed, opts, counters)
        except torture.Disagreement as e:
            assert f"seed {cseed}" in str(e)
            assert "device/host decoder divergence" in str(e)
            break
    else:
        pytest.fail("no cycle fed a rejected stream to the device leg")


def test_cli_short_run_on_the_plain_versions():
    """A 20 s run of the CLI on the CPU (`--kernels --wave`) survives,
    and its counters show mutated streams on B2 and the wave leg whether
    or not liblz4 is present."""
    proc = subprocess.run(
        [sys.executable, "-m", "lz4_tpu_torch.probes.torture", "--device",
         "cpu", "--kernels", "--wave", "--seconds", "20"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("[torture] master seed ")
    res = json.loads(lines[-1])["torture"]
    c = res["counters"]
    assert c["mutated.B2"] > 0 and c["mutated.wave"] > 0
    assert c["mutated.host"] > 0 and c["cycles"] > 0
    assert c.get("disagreements", 0) == 0
    if not res["oracle"]:
        assert "oracle: none" in proc.stdout
    # on the CPU no kernel launches
    assert set(res["launches"].values()) == {0}
