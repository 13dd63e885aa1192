/* LZ4F frame-body pump: decode a run of complete blocks in ONE native
 * call (GIL released by ctypes).
 *
 * The Python frame reader (lz4_tpu_torch/frame/reader.py) is a resumable
 * byte-granular state machine — correct everywhere, but its per-block
 * Python work (header unpack, bytearray copies, checksum calls)
 * dominates end-to-end CLI decode wall time once the block codec itself
 * is the native C tier. This walker is the engine-shaped analog of the
 * reference CLI's decode loop (programs/lz4io.c:1942-2203): the host
 * frame walk runs at memcpy speed in C, Python keeps only header
 * parsing, magic dispatch and frame-level orchestration.
 *
 * Contract (mirrors LZ4F_decompress stages dstage_getBlockHeader..
 * dstage_flushOut, lib/lz4frame.c:1724-1957):
 *   - src points just past the frame header at a block boundary (or at
 *     the stored continuation point); the pump consumes as many
 *     COMPLETE blocks as fit in `out`, never a partial one.
 *   - Optional per-block XXH32 verify (lz4frame.c:1851-1858 analog),
 *     streaming content-XXH32 accumulation (lz4frame.c:1871), linked-
 *     mode 64 KB rolling history maintained inside the state
 *     (LZ4F_updateDict analog, lz4frame.c:1527-1592).
 *   - Returns 1 once the endmark (+ content checksum, when flagged) is
 *     consumed and verified; 0 when it stopped for more input/output;
 *     negative error codes otherwise.
 */
#include <stdint.h>
#include <string.h>

/* from blockcodec.c */
long lz4t_decompress_block(const uint8_t *comp, long clen, uint8_t *dst,
                           long cap, const uint8_t *dict, long dict_len);
/* from xxh.c */
uint32_t lz4t_xxh32(const uint8_t *data, size_t len, uint32_t seed);

/* ---- streaming XXH32 (public xxHash algorithm; the 4-accumulator
 * round structure is algorithm-defined). Matches lz4_tpu_torch/xxh32.py's
 * XXH32State semantics. ---- */

#define PRIME1 2654435761U
#define PRIME2 2246822519U
#define PRIME3 3266489917U
#define PRIME4 668265263U
#define PRIME5 374761393U

static inline uint32_t fw_rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}
static inline uint32_t fw_read32(const uint8_t *p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}
static inline uint32_t fw_round(uint32_t acc, uint32_t lane) {
    return fw_rotl(acc + lane * PRIME2, 13) * PRIME1;
}

typedef struct {
    uint32_t acc[4];
    uint64_t total;
    uint32_t buf_used;
    uint8_t buf[16];
} fw_xxh32;

static void fw_xxh_init(fw_xxh32 *s, uint32_t seed) {
    s->acc[0] = seed + PRIME1 + PRIME2;
    s->acc[1] = seed + PRIME2;
    s->acc[2] = seed;
    s->acc[3] = seed - PRIME1;
    s->total = 0;
    s->buf_used = 0;
}

static void fw_xxh_update(fw_xxh32 *s, const uint8_t *p, size_t n) {
    s->total += n;
    if (s->buf_used) {
        size_t fill = 16 - s->buf_used;
        if (fill > n) fill = n;
        memcpy(s->buf + s->buf_used, p, fill);
        s->buf_used += (uint32_t)fill;
        p += fill;
        n -= fill;
        if (s->buf_used < 16) return;
        s->acc[0] = fw_round(s->acc[0], fw_read32(s->buf));
        s->acc[1] = fw_round(s->acc[1], fw_read32(s->buf + 4));
        s->acc[2] = fw_round(s->acc[2], fw_read32(s->buf + 8));
        s->acc[3] = fw_round(s->acc[3], fw_read32(s->buf + 12));
        s->buf_used = 0;
    }
    while (n >= 16) {
        s->acc[0] = fw_round(s->acc[0], fw_read32(p));
        s->acc[1] = fw_round(s->acc[1], fw_read32(p + 4));
        s->acc[2] = fw_round(s->acc[2], fw_read32(p + 8));
        s->acc[3] = fw_round(s->acc[3], fw_read32(p + 12));
        p += 16;
        n -= 16;
    }
    if (n) {
        memcpy(s->buf, p, n);
        s->buf_used = (uint32_t)n;
    }
}

static uint32_t fw_xxh_digest(const fw_xxh32 *s) {
    uint32_t h;
    const uint8_t *p = s->buf, *end = s->buf + s->buf_used;
    if (s->total >= 16) {
        h = fw_rotl(s->acc[0], 1) + fw_rotl(s->acc[1], 7) +
            fw_rotl(s->acc[2], 12) + fw_rotl(s->acc[3], 18);
    } else {
        h = s->acc[2] + PRIME5;   /* acc[2] == seed */
    }
    h += (uint32_t)s->total;
    while (p + 4 <= end) {
        h = fw_rotl(h + fw_read32(p) * PRIME3, 17) * PRIME4;
        p += 4;
    }
    while (p < end) {
        h = fw_rotl(h + (*p) * PRIME5, 11) * PRIME1;
        p++;
    }
    h ^= h >> 15; h *= PRIME2;
    h ^= h >> 13; h *= PRIME3;
    h ^= h >> 16;
    return h;
}

/* ---- pump state ---- */

#define FW_WINDOW 65536

enum {
    FW_FLAG_BLOCK_CHECKSUM = 1,
    FW_FLAG_INDEPENDENT = 2,
    FW_FLAG_CONTENT_CHECKSUM = 4,
    FW_FLAG_VERIFY = 8,
};

enum {
    FW_STAGE_BLOCKS = 0,
    FW_STAGE_CONTENT_CHECKSUM = 1,
};

typedef struct {
    uint32_t flags;
    uint32_t block_max;
    uint32_t stage;
    uint32_t hist_len;
    fw_xxh32 xxh;
    uint8_t hist[FW_WINDOW];
    uint8_t tmp[2 * FW_WINDOW];   /* scratch: hist + early-out dict */
} fw_state;

long lz4t_frame_state_size(void) { return (long)sizeof(fw_state); }

/* 0 = expecting block headers, 1 = expecting the content checksum —
 * lets the Python driver size its next read without re-deriving the
 * stage from consumed bytes. */
long lz4t_frame_stage(void *stv) {
    return (long)((fw_state *)stv)->stage;
}

void lz4t_frame_state_init(void *stv, uint32_t flags, uint32_t block_max,
                           const uint8_t *dict, long dict_len) {
    fw_state *st = (fw_state *)stv;
    st->flags = flags;
    st->block_max = block_max;
    st->stage = FW_STAGE_BLOCKS;
    fw_xxh_init(&st->xxh, 0);
    if (dict_len > FW_WINDOW) {
        dict += dict_len - FW_WINDOW;
        dict_len = FW_WINDOW;
    }
    if (dict_len > 0) memcpy(st->hist, dict, (size_t)dict_len);
    st->hist_len = (uint32_t)(dict_len > 0 ? dict_len : 0);
}

/* Roll `produced` output bytes into the linked-mode history window. */
static void fw_save_history(fw_state *st, const uint8_t *out, long produced) {
    if (produced >= FW_WINDOW) {
        memcpy(st->hist, out + produced - FW_WINDOW, FW_WINDOW);
        st->hist_len = FW_WINDOW;
    } else if (produced > 0) {
        uint32_t keep = FW_WINDOW - (uint32_t)produced;
        if (st->hist_len > keep) {
            memmove(st->hist, st->hist + st->hist_len - keep, keep);
            st->hist_len = keep;
        }
        memcpy(st->hist + st->hist_len, out, (size_t)produced);
        st->hist_len += (uint32_t)produced;
    }
}

long lz4t_frame_pump(void *stv, const uint8_t *src, long n,
                     uint8_t *out, long out_cap,
                     long *consumed, long *produced) {
    fw_state *st = (fw_state *)stv;
    const uint8_t *ip = src, *iend = src + n;
    uint8_t *op = out, *oend = out + out_cap;
    int independent = (st->flags & FW_FLAG_INDEPENDENT) != 0;
    int bsum = (st->flags & FW_FLAG_BLOCK_CHECKSUM) != 0;
    int csum = (st->flags & FW_FLAG_CONTENT_CHECKSUM) != 0;
    int verify = (st->flags & FW_FLAG_VERIFY) != 0;
    long status = 0;

    *consumed = 0;
    *produced = 0;

    if (st->stage == FW_STAGE_CONTENT_CHECKSUM) goto content_checksum;

    for (;;) {
        uint32_t word, size, raw;
        long dec;
        const uint8_t *payload;
        const uint8_t *dict;
        long dict_len;

        if (iend - ip < 4) break;               /* need a block header */
        word = fw_read32(ip);
        if (word == 0) {                        /* endmark */
            ip += 4;
            if (csum) {
                st->stage = FW_STAGE_CONTENT_CHECKSUM;
                goto content_checksum;
            }
            status = 1;
            break;
        }
        raw = word & 0x80000000u;
        size = word & 0x7FFFFFFFu;
        if (size > st->block_max) { status = -4; break; }
        if (iend - ip < 4 + (long)size + (bsum ? 4 : 0))
            break;                              /* incomplete block */
        if (oend - op < (long)st->block_max)
            break;                              /* out space low: flush */
        payload = ip + 4;
        if (bsum && verify) {
            uint32_t want = fw_read32(payload + size);
            if (lz4t_xxh32(payload, size, 0) != want) {
                status = -2;
                break;
            }
        }
        if (raw) {
            memcpy(op, payload, size);
            dec = (long)size;
        } else {
            /* linked/dict history: prefer a zero-copy window inside
             * `out` itself; fall back to the scratch assembly only
             * while fewer than 64 KB have been produced this call */
            if (independent && st->hist_len == 0) {
                dict = 0;
                dict_len = 0;
            } else if (!independent && (op - out) >= FW_WINDOW) {
                dict = op - FW_WINDOW;
                dict_len = FW_WINDOW;
            } else {
                long have = op - out;             /* < FW_WINDOW here,
                                                     or independent+dict */
                long h_take = independent
                    ? (long)st->hist_len
                    : (long)FW_WINDOW - have;
                if (h_take > (long)st->hist_len)
                    h_take = (long)st->hist_len;
                if (independent) have = 0;
                memcpy(st->tmp, st->hist + st->hist_len - h_take,
                       (size_t)h_take);
                if (have)
                    memcpy(st->tmp + h_take, out, (size_t)have);
                dict = st->tmp;
                dict_len = h_take + have;
            }
            dec = lz4t_decompress_block(payload, (long)size, op,
                                        (long)st->block_max,
                                        dict, dict_len);
            if (dec < 0) { status = -5; break; }
        }
        if (csum) fw_xxh_update(&st->xxh, op, (size_t)dec);
        op += dec;
        ip += 4 + size + (bsum ? 4 : 0);
    }
    goto done;

content_checksum:
    if (iend - ip >= 4) {
        uint32_t want = fw_read32(ip);
        ip += 4;
        if (verify && fw_xxh_digest(&st->xxh) != want) {
            status = -3;
        } else {
            status = 1;
            st->stage = FW_STAGE_BLOCKS;
        }
    }

done:
    *consumed = (long)(ip - src);
    *produced = (long)(op - out);
    if (!independent && *produced > 0)
        fw_save_history(st, out, *produced);
    return status;
}
