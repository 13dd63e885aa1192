"""LZ4 format constants (the port's own copy of lz4_tpu/constants.py).

These mirror the *normative* LZ4 block & frame format specifications
(lz4's doc/lz4_Block_format.md and doc/lz4_Frame_format.md; numeric
constants cross-checked against lib/lz4.c:242-258 and
lib/lz4frame.c:333-342). Only the published format values live here.
"""

# ---------------------------------------------------------------- block format
MINMATCH = 4          # minimum match length (doc/lz4_Block_format.md:87)
LASTLITERALS = 5      # last 5 bytes of a block are always literals
MFLIMIT = 12          # last match must start >= 12 bytes before block end
LZ4_DISTANCE_MAX = 65535   # max offset (2-byte little-endian, 0 is invalid)
ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1   # 15
RUN_MASK = 15                  # literal-length nibble saturation value
LZ4_MAX_INPUT_SIZE = 0x7E000000  # lz4.h:214

# A block shorter than MFLIMIT+1 cannot contain any match.
MIN_BLOCK_WITH_MATCH = MFLIMIT + 1  # 13


def compress_bound(isize: int) -> int:
    """Worst-case compressed size for a block of `isize` bytes.

    Formula from the public API contract (lz4.h:215): isize + isize/255 + 16.
    """
    if isize > LZ4_MAX_INPUT_SIZE:
        return 0
    return isize + isize // 255 + 16


# ---------------------------------------------------------------- frame format
LZ4F_MAGIC = 0x184D2204          # frame magic, little-endian on wire
LZ4F_MAGIC_SKIPPABLE_START = 0x184D2A50   # skippable frames: 0x184D2A50..5F
LZ4F_MAGIC_SKIPPABLE_MASK = 0xFFFFFFF0
LEGACY_MAGIC = 0x184C2102        # legacy frame magic
LEGACY_BLOCKSIZE = 8 * 1024 * 1024   # legacy format: 8 MB blocks

LZ4F_VERSION = 1                 # FLG version bits (7-6) must be 01

# Block-maximum-size table: BD byte bits 6-4 → size. IDs 4..7 are defined.
BLOCK_SIZES = {
    4: 64 * 1024,        # LZ4F_max64KB
    5: 256 * 1024,       # LZ4F_max256KB
    6: 1024 * 1024,      # LZ4F_max1MB
    7: 4 * 1024 * 1024,  # LZ4F_max4MB
}
DEFAULT_BLOCK_SIZE_ID = 4   # 64 KB default, lz4frame.c:250

# Data-block header: 4-byte LE size; high bit set means "stored uncompressed".
BLOCK_UNCOMPRESSED_FLAG = 0x80000000
ENDMARK = 0x00000000

# Frame header size bounds (magic + FLG + BD + optional fields + HC byte)
LZ4F_HEADER_SIZE_MIN = 7
LZ4F_HEADER_SIZE_MAX = 19

# ------------------------------------------------------------------- HC levels
LZ4HC_CLEVEL_MIN = 2
LZ4HC_CLEVEL_DEFAULT = 9
LZ4HC_CLEVEL_OPT_MIN = 10
LZ4HC_CLEVEL_MAX = 12

ACCELERATION_DEFAULT = 1
ACCELERATION_MAX = 65537


def optimal_block_size_id(content_size: int) -> int:
    """Pick the smallest standard block size >= content (one-block frames),
    behavioral parity with LZ4F_optimalBSID (lz4frame.c:359-371)."""
    for bsid in (4, 5, 6, 7):
        if content_size <= BLOCK_SIZES[bsid]:
            return bsid
    return 7
