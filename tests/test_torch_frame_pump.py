"""The port's frame pump (`native/framewalk.c`, the `frame_pump` facade
and the reader's pump stage) against the JAX package's, on the same
numpy-seeded frames: the facade call by call, whole-frame decodes with
the pump on and off, streamed feeds (output, `consumed` and `next_hint`
after every call), the errors of damaged frames, and the I/O engine's
zero-copy path. Tolerance: exact.
"""
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from lz4_tpu import native as jnative  # noqa: E402
from lz4_tpu.block import backend as jbackend  # noqa: E402
from lz4_tpu.frame import reader as jreader  # noqa: E402
from lz4_tpu.io import engine as jio  # noqa: E402
from lz4_tpu_torch import native  # noqa: E402
from lz4_tpu_torch.block.backend import HostBackend  # noqa: E402
from lz4_tpu_torch.frame import reader  # noqa: E402
from lz4_tpu_torch.frame.format import (FrameInfo, Preferences,  # noqa: E402
                                        parse_frame_header)
from lz4_tpu_torch.frame.writer import (CDict, compress_frame,  # noqa: E402
                                        compress_legacy_frame,
                                        write_skippable_frame)
from lz4_tpu_torch.io.engine import IoPrefs, decompress_file  # noqa: E402
from lz4_tpu_torch.parallel.engine import TorchBackend  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer  # noqa: E402

HOST = HostBackend()
JHOST = jbackend.HostBackend()
BLOCK_IDS = {65536: 4, 262144: 5, 1 << 20: 6}
DICT_LENS = {"nodict": 0, "dict1k": 1024, "dict64k": 65536, "dict80k": 81920}


def _dict(n: int) -> bytes | None:
    return gen_buffer(n, match_prob=0.6, seed=n) if n else None


def _data(size: int, dict_content: bytes | None, seed: int) -> bytes:
    """Segments of 4000 bytes, each fresh random bytes or a copy of the
    bytes 65535 back (the longest offset LZ4 allows, across block seams
    and pump calls in linked frames, and into the end of the dictionary
    where it reaches that far) with a few bytes edited."""
    rng = np.random.default_rng(seed)
    seg, dist = 4000, 65535
    hist = (dict_content or b"")[-dist:]
    buf = bytearray(hist)
    for i in range(-(-size // seg)):
        start = len(buf) - dist
        if start < 0 or i % 3 == 0:
            buf += rng.integers(0, 256, seg, dtype=np.uint8).tobytes()
            continue
        part = bytearray(buf[start: start + seg])
        for p in rng.integers(0, seg, 4):
            part[p] = int(rng.integers(0, 256))
        buf += part
    return bytes(buf[len(hist):][:size])


def _frame(data, *, block_max=65536, independent=True, block_checksum=False,
           content_checksum=False, dict_content=None, content_size=False):
    prefs = Preferences(frame_info=FrameInfo(
        block_size_id=BLOCK_IDS[block_max], block_independent=independent,
        block_checksum=block_checksum, content_checksum=content_checksum))
    return compress_frame(data, prefs=prefs, backend=HOST,
                          cdict=CDict(dict_content) if dict_content else None,
                          store_content_size=content_size)


def _units(body: bytes, block_checksum: bool) -> list[int]:
    """Offsets in a frame body where each unit (block, endmark) starts,
    and the body's end."""
    pos, out = 0, []
    while True:
        out.append(pos)
        word = struct.unpack("<I", body[pos: pos + 4])[0]
        if word == 0:
            break
        pos += 4 + (word & 0x7FFFFFFF) + (4 if block_checksum else 0)
    return out + [len(body)]


def _outcome(fn):
    """The value fn returns, or the class and code of what it raises."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, getattr(e, "code", None)


@pytest.mark.parametrize("dname", list(DICT_LENS))
@pytest.mark.parametrize("content_checksum", [False, True],
                         ids=["nocsum", "csum"])
@pytest.mark.parametrize("block_checksum", [False, True],
                         ids=["nobsum", "bsum"])
@pytest.mark.parametrize("independent", [True, False],
                         ids=["indep", "linked"])
@pytest.mark.parametrize("block_max", list(BLOCK_IDS))
def test_frame_pump_facade(block_max, independent, block_checksum,
                           content_checksum, dname):
    """Each call's (status, produced bytes, consumed) equal the JAX
    facade's, the body cut at every unit boundary and inside every unit
    (the second call resumes where the first stopped, so the history
    crosses the call), with an arena of block_max then the bulk cap."""
    d = _dict(DICT_LENS[dname])
    data = _data(block_max * 5 // 2, d, seed=block_max)
    frame = _frame(data, block_max=block_max, independent=independent,
                   block_checksum=block_checksum,
                   content_checksum=content_checksum, dict_content=d)
    body = frame[parse_frame_header(frame)[1]:]
    units = _units(body, block_checksum)
    cuts = sorted({c for a, b in zip(units, units[1:])
                   for c in (a, a + 1, (a + b) // 2, b - 1)} | {len(body)})
    kw = dict(block_checksum=block_checksum, independent=independent,
              content_checksum=content_checksum, verify=True,
              block_max=block_max, dict_content=d)
    bulk = max(2 * block_max, 1 << 22)
    for cut in cuts:
        st = native.blockcodec.frame_state_new(**kw)
        jst = jnative.blockcodec.frame_state_new(**kw)
        got = bytearray()
        pos, s = 0, 0
        for src, cap in ((body[:cut], block_max), (body, bulk)):
            s, p, c = native.blockcodec.frame_pump(st, src, pos, cap)
            js, jp, jc = jnative.blockcodec.frame_pump(jst, src, pos, cap)
            assert (s, bytes(p), c) == (js, bytes(jp), jc), (cut, pos)
            assert native.blockcodec.frame_stage(st) == \
                jnative.blockcodec.frame_stage(jst)
            got += p
            pos += c
            if s == 1:
                break
        assert s == 1 and pos == len(body) and got == data, cut


def _kinds():
    d64 = _dict(65536)
    d1 = _dict(1024)
    return {
        "indep-bsum-csum": (dict(independent=True, block_checksum=True,
                                 content_checksum=True), None),
        "indep-plain-size": (dict(independent=True, content_size=True),
                             None),
        "linked-csum": (dict(independent=False, content_checksum=True),
                        None),
        "linked-dict64k-bsum": (dict(independent=False, block_checksum=True,
                                     content_checksum=True), d64),
        "indep-dict1k": (dict(independent=True, content_checksum=True), d1),
        "linked-256k": (dict(independent=False, block_max=262144,
                             content_checksum=True), d64),
    }


KINDS = _kinds()


def _concatenated(kind: str) -> tuple[bytes, bytes, bytes | None]:
    """(stream, decoded, dict): a frame of the kind, a skippable frame, a
    legacy frame, and a second frame of the kind; and an empty frame."""
    kw, d = KINDS[kind]
    a = _data(300000, d, seed=1)
    b = _data(90000, d, seed=2)
    leg = gen_buffer(50000, match_prob=0.7, seed=3)
    stream = (_frame(a, dict_content=d, **kw)
              + write_skippable_frame(b"x" * 77)
              + compress_legacy_frame(leg, backend=HOST)
              + _frame(b, dict_content=d, **kw)
              + _frame(b"", dict_content=d, **kw))
    return stream, a + leg + b, d


@pytest.mark.parametrize("kind", list(KINDS))
def test_decompress_frame_pump_walk_and_jax(kind, monkeypatch):
    stream, want, d = _concatenated(kind)
    pumped = reader.decompress_frame(stream, backend=HOST, dict_content=d)
    monkeypatch.setattr(reader.FrameDecompressor, "frame_pump", False)
    walked = reader.decompress_frame(stream, backend=HOST, dict_content=d)
    jaxed = jreader.decompress_frame(stream, backend=JHOST, dict_content=d)
    assert pumped == walked == jaxed == want


def test_pump_serves_host_backend_only(monkeypatch):
    frame = _frame(_data(70000, None, seed=4))
    dec = reader.FrameDecompressor(backend=HOST)
    dec.feed(frame[:7])
    assert dec._stage == dec._PUMP
    dec = reader.FrameDecompressor(backend=TorchBackend("cpu"))
    dec.feed(frame[:7])
    assert dec._stage == dec._BLOCK_HEADER
    monkeypatch.setattr(reader.FrameDecompressor, "frame_pump", False)
    dec = reader.FrameDecompressor(backend=HOST)
    dec.feed(frame[:7])
    assert dec._stage == dec._BLOCK_HEADER


STREAM_KINDS = ("indep-bsum-csum", "linked-csum", "linked-dict64k-bsum")


@pytest.mark.parametrize("chunk", [1, 3, 4, 7, 4099, 65539, None],
                         ids=lambda c: f"chunk{c or 'whole'}")
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_streamed_feeds_match_jax(kind, chunk):
    """After every feed: the output, `consumed`, `next_hint` and
    `frame_done` equal the JAX reader's (pump on in both); the bytes
    after the frame are not consumed."""
    kw, d = KINDS[kind]
    data = gen_buffer(150000, match_prob=0.9, seed=5)
    stream = _frame(data, dict_content=d, **kw) + write_skippable_frame(b"t")
    dec = reader.FrameDecompressor(backend=HOST, dict_content=d)
    jdec = jreader.FrameDecompressor(backend=JHOST, dict_content=d)
    n = chunk or len(stream)
    out = bytearray()
    pos = 0
    while not dec.frame_done:
        piece = stream[pos: pos + n]
        o, c = dec.feed(piece)
        jo, jc = jdec.feed(piece)
        assert isinstance(o, bytes)
        assert (o, c, dec.next_hint, dec.frame_done) == \
            (jo, jc, jdec.next_hint, jdec.frame_done), pos
        assert c > 0
        out += o
        pos += c
    assert out == data and stream[pos:] == write_skippable_frame(b"t")


def _damaged(fault: str) -> tuple[bytes, bytes | None]:
    """A frame with one fault: a block checksum, the content checksum,
    a block word over block_max, or a malformed payload."""
    d = _dict(65536) if fault == "malformed_linked" else None
    data = gen_buffer(200000, match_prob=0.8, seed=6)
    frame = bytearray(_frame(data, block_checksum=fault == "block_checksum",
                             content_checksum=True, dict_content=d,
                             independent=fault != "malformed_linked"))
    hdr = parse_frame_header(bytes(frame))[1]
    units = [hdr + u for u in _units(bytes(frame[hdr:]),
                                     fault == "block_checksum")]
    second = units[1]
    size = struct.unpack("<I", frame[second: second + 4])[0] & 0x7FFFFFFF
    if fault == "block_checksum":
        frame[second + 4 + size] ^= 0x40
    elif fault == "content_checksum":
        frame[-1] ^= 0x01
    elif fault == "oversize_word":
        frame[second: second + 4] = struct.pack("<I", 65537)
    else:
        # every sequence with match offset 0, which no decoder accepts
        frame[second + 4: second + 4 + size] = bytes(size)
    return bytes(frame), d


@pytest.mark.parametrize("verify", [True, False], ids=["verify", "noverify"])
@pytest.mark.parametrize("fault", ["block_checksum", "content_checksum",
                                   "oversize_word", "malformed",
                                   "malformed_linked"])
def test_damaged_frames_match_jax(fault, verify, monkeypatch):
    """The port's pump raises the JAX pump's class and code, and its
    Python walk the JAX walk's; with verify_checksums off the output is
    the JAX reader's."""
    frame, d = _damaged(fault)

    def decode(mod, be):
        dec = mod.FrameDecompressor(backend=be, dict_content=d,
                                    verify_checksums=verify)
        out = bytearray()
        for i in range(0, len(frame), 50000):
            out += dec.feed(frame[i: i + 50000])[0]
        return bytes(out), dec.frame_done

    got = _outcome(lambda: decode(reader, HOST))
    assert got == _outcome(lambda: decode(jreader, JHOST))
    if fault in ("block_checksum", "content_checksum"):
        assert got[0] == ("ok" if not verify else "FrameError")
    else:
        assert got[0] == ("FrameError" if fault == "oversize_word"
                          else "BlockDecodeError")
    monkeypatch.setattr(reader.FrameDecompressor, "frame_pump", False)
    monkeypatch.setenv("LZ4_TPU_FRAME_PUMP", "0")
    walked = _outcome(lambda: decode(reader, HOST))
    assert walked == _outcome(lambda: decode(jreader, JHOST))
    assert walked == got


def test_shortened_block_word_pump_and_walk_differ_as_in_jax(monkeypatch):
    """An independent frame without block checksums whose block word is
    cut short: the pump decodes the short block in order and raises
    BlockDecodeError, the Python walk defers the decode and first meets
    the garbage word after it (maxBlockSize_invalid). The port keeps both
    behaviours of the JAX package."""
    frame = bytearray(_frame(gen_buffer(200000, match_prob=0.8, seed=7)))
    hdr = parse_frame_header(bytes(frame))[1]
    second = hdr + _units(bytes(frame[hdr:]), False)[1]
    word = struct.unpack("<I", frame[second: second + 4])[0]
    frame[second: second + 4] = struct.pack("<I", word - 2000)
    frame = bytes(frame)
    pumped = _outcome(lambda: reader.decompress_frame(frame, backend=HOST))
    assert pumped == _outcome(
        lambda: jreader.decompress_frame(frame, backend=JHOST))
    assert pumped == ("BlockDecodeError", None)
    monkeypatch.setattr(reader.FrameDecompressor, "frame_pump", False)
    monkeypatch.setenv("LZ4_TPU_FRAME_PUMP", "0")
    walked = _outcome(lambda: reader.decompress_frame(frame, backend=HOST))
    assert walked == _outcome(
        lambda: jreader.decompress_frame(frame, backend=JHOST))
    assert walked == ("FrameError", "maxBlockSize_invalid")


@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_mutated_frames_match_jax(kind, monkeypatch):
    """64 frames with one to three random bytes replaced: pump on, pump
    off and the JAX reader (pump on) agree on every outcome."""
    kw, d = KINDS[kind]
    frame = _frame(_data(150000, d, seed=8), dict_content=d, **kw)
    rng = np.random.default_rng(9)
    for k in range(64):
        m = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(7, len(m)))] = int(rng.integers(0, 256))
        m = bytes(m)
        monkeypatch.setattr(reader.FrameDecompressor, "frame_pump", True)
        pumped = _outcome(lambda: reader.decompress_frame(
            m, backend=HOST, dict_content=d))
        assert pumped == _outcome(lambda: jreader.decompress_frame(
            m, backend=JHOST, dict_content=d)), k
        monkeypatch.setattr(reader.FrameDecompressor, "frame_pump", False)
        assert pumped == _outcome(lambda: reader.decompress_frame(
            m, backend=HOST, dict_content=d)), k


def test_zero_copy_feed():
    data = _data(300000, None, seed=10)
    frame = _frame(data, content_checksum=True)
    out, used = reader.FrameDecompressor(backend=HOST).feed(frame)
    assert isinstance(out, bytes) and out == data and used == len(frame)
    dec = reader.FrameDecompressor(backend=HOST, zero_copy=True)
    view, used = dec.feed(frame)
    assert isinstance(view, memoryview) and bytes(view) == data
    assert dec.frame_done and used == len(frame)
    # a second feed makes a new arena: the first view is not written again
    dec2 = reader.FrameDecompressor(backend=HOST, zero_copy=True)
    other = _frame(_data(300000, None, seed=11), content_checksum=True)
    dec2.feed(other)
    assert bytes(view) == data


def test_io_engine_decode_matches_jax(tmp_path):
    """A 4 MB-block file (linked, with a content checksum, then an
    independent frame) through both I/O engines' decoders on the host
    tier: equal outputs, equal to the source."""
    data = _data(11 << 20, None, seed=12)
    src = tmp_path / "f.lz4"
    src.write_bytes(b"".join(compress_frame(part, prefs=Preferences(
        frame_info=FrameInfo(block_size_id=7, block_independent=ind,
                             content_checksum=True)), backend=HOST)
        for part, ind in ((data[: 9 << 20], False), (data[9 << 20:], True))))
    a, b = tmp_path / "port.out", tmp_path / "jax.out"
    assert decompress_file(str(src), str(a), IoPrefs(), backend=HOST)[1] \
        == len(data)
    jio.decompress_file(str(src), str(b), jio.IoPrefs(), backend=JHOST)
    assert a.read_bytes() == b.read_bytes() == data
