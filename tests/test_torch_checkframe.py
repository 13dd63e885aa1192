"""The port's frame validator (`lz4_tpu_torch.checkframe`) against the JAX
package's tool (tools/checkframe.py) on the same files: frames written by
both packages with every block size id, linked and independent, block and
content checksums, content size and a dictionary ID; skippable, legacy
and concatenated frames; the corruptions of tests/test_checkframe.py and
truncations. Either both return the same list of frames or both raise
`FrameError` with the same message; the CLIs give the same exit codes."""
import functools
import os
import struct
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import checkframe as tool  # noqa: E402

from lz4_tpu.frame import format as jax_format  # noqa: E402
from lz4_tpu.frame import writer as jax_writer  # noqa: E402
from lz4_tpu_torch import checkframe as port  # noqa: E402
from lz4_tpu_torch.block.backend import HostBackend  # noqa: E402
from lz4_tpu_torch.frame import format as port_format  # noqa: E402
from lz4_tpu_torch.frame import writer as port_writer  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text  # noqa: E402

PACKAGES = {"jax": (jax_writer, jax_format, {}),
            "port": (port_writer, port_format, {"backend": HostBackend()})}
DATA = gen_text(300_000, seed=5)


@functools.lru_cache(maxsize=None)
def _frame(pkg, bsid=4, independent=True, bcsum=False, ccsum=True,
           csize=False, dict_id=None, level=1):
    writer, fmt, kw = PACKAGES[pkg]
    prefs = fmt.Preferences(frame_info=fmt.FrameInfo(
        block_size_id=bsid, block_independent=independent,
        block_checksum=bcsum, content_checksum=ccsum))
    cdict = (writer.CDict(gen_buffer(4000, seed=9), dict_id=dict_id)
             if dict_id else None)
    return writer.compress_frame(DATA, level, prefs, cdict=cdict,
                                 store_content_size=csize, **kw)


VALID = {}
for _pkg in PACKAGES:
    for _bsid in (4, 5, 6, 7):
        for _indep in (True, False):
            VALID[f"{_pkg}-bsid{_bsid}-{'indep' if _indep else 'linked'}"] = (
                _pkg, dict(bsid=_bsid, independent=_indep,
                           bcsum=_bsid % 2 == 0, ccsum=_indep))
    VALID[f"{_pkg}-csize"] = (_pkg, dict(csize=True, bcsum=True))
    VALID[f"{_pkg}-nocsum"] = (_pkg, dict(ccsum=False))
    VALID[f"{_pkg}-dictid"] = (_pkg, dict(dict_id=0x1234, csize=True))
    VALID[f"{_pkg}-hc9"] = (_pkg, dict(level=9, bsid=5, independent=False))


def _legacy():
    return port_writer.compress_legacy_frame(DATA[:50_000], 1,
                                             backend=HostBackend())


def _skippable(payload=b"meta!!", sub_id=0):
    return port_writer.write_skippable_frame(payload, sub_id)


def _files():
    files = {name: _frame(pkg, **kw) for name, (pkg, kw) in VALID.items()}
    base = bytearray(_frame("jax"))
    files["skip-lz4f-lz4f"] = _skippable() + _frame("jax") + _frame("port")
    files["legacy"] = _legacy()
    files["legacy-then-lz4f"] = _legacy() + _frame("port")
    files["lz4f-legacy-skip15"] = (_frame("port") + _legacy()
                                   + _skippable(b"x" * 100, 15))
    files["empty-skippable"] = _skippable(b"")
    # the corruptions of tests/test_checkframe.py
    files["bad-magic"] = bytes([base[0] ^ 0xFF]) + bytes(base[1:])
    hc = bytearray(base)
    hc[6] ^= 0xFF
    files["bad-hc"] = bytes(hc)
    res = bytearray(base)
    res[4] |= 0x02
    files["reserved-flg"] = bytes(res)
    files["trunc-half"] = bytes(base[: len(base) // 2])
    # more structure faults
    ver = bytearray(base)
    ver[4] ^= 0x40
    files["bad-version"] = bytes(ver)
    bd = bytearray(base)
    bd[5] |= 0x80
    files["reserved-bd"] = bytes(bd)
    bsid = bytearray(base)
    bsid[5] = (bsid[5] & 0x8F) | (3 << 4)
    files["bad-bsid"] = bytes(bsid)
    big = bytearray(base)
    struct.pack_into("<I", big, 7, 70_000)
    files["oversized-block"] = bytes(big)
    files["empty"] = b""
    files["unknown-magic"] = b"\x00\x01\x02\x03" + bytes(base[4:])
    files["skippable-cut"] = _skippable(b"x" * 100)[:50]
    files["legacy-oversized"] = (struct.pack("<II", 0x184C2102, 9 << 20)
                                 + b"\x00" * 16)
    for cut in (3, 5, 6, 7, 9, 11, len(base) - 5, len(base) - 1):
        files[f"trunc-{cut}"] = bytes(base[:cut])
    linked = _frame("port", bsid=5, independent=False, bcsum=True)
    files["trunc-linked-checksum"] = linked[:-2]
    return files


FILES = _files()
MIXED = ("skip-lz4f-lz4f", "legacy", "legacy-then-lz4f", "lz4f-legacy-skip15",
         "empty-skippable")


@pytest.fixture
def path_of(tmp_path):
    def write(name):
        p = tmp_path / f"{name}.lz4"
        p.write_bytes(FILES[name])
        return str(p)
    return write


def _outcome(mod, path):
    try:
        return "ok", mod.check_file(path)
    except mod.FrameError as e:
        return "FrameError", str(e)


@pytest.mark.parametrize("name", list(FILES))
def test_check_file_matches_the_tool(path_of, name):
    path = path_of(name)
    got, want = _outcome(port, path), _outcome(tool, path)
    assert got == want
    if name in VALID or name in MIXED:
        assert got[0] == "ok", got
    else:
        assert got[0] == "FrameError", got


def test_valid_frames_are_described(path_of):
    frames = port.check_file(path_of("jax-csize"))
    assert frames[0]["type"] == "lz4f"
    assert frames[0]["content_size"] == len(DATA)
    assert frames[0]["blocks"] == -(-len(DATA) // 65536)
    kinds = [f["type"] for f in port.check_file(path_of("skip-lz4f-lz4f"))]
    assert kinds == ["skippable", "lz4f", "lz4f"]


def test_cli_exit_codes_match_the_tool(path_of, tmp_path, capsys):
    good = [path_of("port-bsid4-indep"), path_of("legacy")]
    bad = [path_of("bad-hc")]
    missing = [str(tmp_path / "no-such-file.lz4")]
    for argv, code in ((good, 0), (good + bad, 1), (missing, 1), ([], 1)):
        assert port.main(argv) == code
        port_out = capsys.readouterr()
        assert tool.main(argv) == code
        tool_out = capsys.readouterr()
        assert port_out.out == tool_out.out
