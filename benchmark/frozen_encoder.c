/* Frozen copy of the level-1 host C block encoder of lz4_tpu_torch
 * (`lz4_tpu_torch/native/blockcodec.c`: the greedy single-pass matcher,
 * its one-block entry and its batch entry), kept here so that the
 * benchmark's decompress streams and its control do not move when the
 * program's encoders change. Only the exported names differ
 * (`bench_` in place of `lz4t_`). Built at first use with `cc` into the
 * git-ignored `benchmark/_build/`.
 *
 * Original notes: written against the normative block format
 * (lz4 doc/lz4_Block_format.md): token = (litlen<<4)|matlen
 * nibbles with 255-chained extensions, 2-byte LE offset (0 invalid),
 * minmatch 4, last 5 bytes literal, last match >= 12 bytes before end.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define MINMATCH 4
#define MFLIMIT 12
#define LASTLITERALS 5
#define WINDOW 65535
#define HASH_LOG 16
#define HASH_SIZE (1u << HASH_LOG)

static inline uint32_t read32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

/* length of common prefix of a and b, both bounded by limit */
static inline size_t match_len(const uint8_t *a, const uint8_t *b,
                               const uint8_t *limit) {
    const uint8_t *start = a;
    while (a + 8 <= limit) {
        uint64_t xa, xb;
        memcpy(&xa, a, 8);
        memcpy(&xb, b, 8);
        if (xa != xb) {
            uint64_t x = xa ^ xb;
#if defined(__GNUC__)
            return (size_t)(a - start) + (__builtin_ctzll(x) >> 3);
#else
            size_t n = 0;
            while (((x >> (8 * n)) & 0xFF) == 0) n++;
            return (size_t)(a - start) + n;
#endif
        }
        a += 8;
        b += 8;
    }
    while (a < limit && *a == *b) { a++; b++; }
    return (size_t)(a - start);
}

static uint8_t *emit_length(uint8_t *op, size_t len) {
    len -= 15;
    while (len >= 255) { *op++ = 255; len -= 255; }
    *op++ = (uint8_t)len;
    return op;
}

/* Compress src[0..n) given `dict_len` bytes of history immediately
 * before src (contiguous, usingDict prefix semantics). Returns the
 * compressed size, or 0 if dst_cap too small. */
static long bench__compress_impl(const uint8_t *src, long n, uint8_t *dst,
                                long dst_cap, long dict_len, int accel,
                                long maxd) {
    uint32_t htab[HASH_SIZE];
    const uint8_t *base = src - dict_len;   /* position 0 in table coords */
    const uint8_t *ip = src, *anchor = src;
    const uint8_t *iend = src + n;
    const uint8_t *mflimit = iend - MFLIMIT;
    const uint8_t *matchlimit = iend - LASTLITERALS;
    uint8_t *op = dst, *oend = dst + dst_cap;
    int step_base = accel > 0 ? accel : 1;

    if (n == 0) {
        if (dst_cap < 1) return 0;
        *op++ = 0;
        return 1;
    }
    memset(htab, 0xFF, sizeof(htab));
    /* seed the table with dictionary positions (stride 3 like a fast
     * dict load; exactness is not required, only validity) */
    if (dict_len >= MINMATCH) {
        for (long p = 0; p + MINMATCH <= dict_len; p += 3)
            htab[hash4(read32(base + p))] = (uint32_t)p;
    }

    if (n >= MFLIMIT + 1) {
        unsigned searchN = (unsigned)step_base << 6;
        while (ip <= mflimit) {
            uint32_t h = hash4(read32(ip));
            uint32_t cpos = htab[h];
            const uint8_t *cand = base + cpos;
            htab[h] = (uint32_t)(ip - base);
            if (cpos != 0xFFFFFFFFu && cand < ip &&
                (long)(ip - cand) <= maxd && read32(cand) == read32(ip)) {
                /* match: extend forward and backward */
                size_t ml = MINMATCH +
                    match_len(ip + MINMATCH, cand + MINMATCH, matchlimit);
                while (ip > anchor && cand > base && ip[-1] == cand[-1]) {
                    ip--; cand--; ml++;
                }
                {
                    size_t lit = (size_t)(ip - anchor);
                    size_t off = (size_t)(ip - cand);
                    size_t mlc = ml - MINMATCH;
                    /* worst-case space check */
                    if (op + 1 + lit + lit / 255 + 2 + 1 + mlc / 255 + 16
                        > oend)
                        return 0;
                    uint8_t *tok = op++;
                    if (lit >= 15) { *tok = 15 << 4; op = emit_length(op, lit); }
                    else *tok = (uint8_t)(lit << 4);
                    memcpy(op, anchor, lit);
                    op += lit;
                    *op++ = (uint8_t)(off & 0xFF);
                    *op++ = (uint8_t)(off >> 8);
                    if (mlc >= 15) { *tok |= 15; op = emit_length(op, mlc); }
                    else *tok |= (uint8_t)mlc;
                }
                ip += ml;
                anchor = ip;
                searchN = (unsigned)step_base << 6;
            } else {
                /* skip accelerator: stride grows with consecutive misses,
                 * scaled by `accel` (searchN starts at accel<<6 so the
                 * stride is always >= accel >= 1) */
                ip += searchN++ >> 6;
            }
        }
    }
    /* final literals */
    {
        size_t lit = (size_t)(iend - anchor);
        if (op + 1 + lit + lit / 255 + 1 > oend) return 0;
        if (lit >= 15) { *op++ = 15 << 4; op = emit_length(op, lit); }
        else *op++ = (uint8_t)(lit << 4);
        memcpy(op, anchor, lit);
        op += lit;
    }
    return (long)(op - dst);
}

long bench_compress_block(const uint8_t *src, long n, uint8_t *dst,
                         long dst_cap, long dict_len, int accel) {
    return bench__compress_impl(src, n, dst, dst_cap, dict_len, accel,
                               WINDOW);
}

/* Batch compression: nblocks independent blocks handed as a pointer
 * array (zero-copy from Python — each entry points straight at a bytes
 * object), outputs written at dst + i*dst_stride with sizes in
 * sizes[i]. Removes the per-block Python/ctypes marshalling and buffer
 * copies of the one-shot path. Reference analog: the CLI compresses
 * whole chunks through one cctx (lz4io.c:1130-1160) rather than
 * per-block API calls. Returns 0 on success, -(i+1) if block i failed
 * (dst_stride too small). */
long bench_compress_batch(const uint8_t **srcs, const int32_t *lens,
                         long nblocks, uint8_t *dst, long dst_stride,
                         int32_t *sizes, int accel) {
    uint32_t htab[HASH_SIZE];
    long i;
    for (i = 0; i < nblocks; i++) {
        /* fresh table per block: stale cross-block entries DO pass the
         * content check (self-similar corpora alias constantly) and
         * flood the parse with 4-byte pseudo-matches that defeat the
         * skip accelerator — measured 3x slower on python source. The
         * clear is ~4% of a 64 KB block's compress time. */
        memset(htab, 0xFF, sizeof(htab));
        const uint8_t *src = srcs[i];
        long n = lens[i];
        const uint8_t *ip = src, *anchor = src;
        const uint8_t *iend = src + n;
        const uint8_t *mflimit = iend - MFLIMIT;
        const uint8_t *matchlimit = iend - LASTLITERALS;
        uint8_t *op = dst + i * dst_stride;
        uint8_t *oend = op + dst_stride;
        uint8_t *dst0 = op;
        int step_base = accel > 0 ? accel : 1;

        if (n == 0) {
            if (dst_stride < 1) return -(i + 1);
            *op = 0;
            sizes[i] = 1;
            continue;
        }
        if (n >= MFLIMIT + 1) {
            unsigned searchN = (unsigned)step_base << 6;
            while (ip <= mflimit) {
                uint32_t h = hash4(read32(ip));
                uint32_t cpos = htab[h];
                const uint8_t *cand = src + cpos;
                htab[h] = (uint32_t)(ip - src);
                if (cand < ip && (long)(ip - cand) <= WINDOW &&
                    read32(cand) == read32(ip)) {
                    size_t ml = MINMATCH +
                        match_len(ip + MINMATCH, cand + MINMATCH,
                                  matchlimit);
                    while (ip > anchor && cand > src &&
                           ip[-1] == cand[-1]) {
                        ip--; cand--; ml++;
                    }
                    {
                        size_t lit = (size_t)(ip - anchor);
                        size_t off = (size_t)(ip - cand);
                        size_t mlc = ml - MINMATCH;
                        if (op + 1 + lit + lit / 255 + 2 + 1 + mlc / 255
                            + 18 > oend)
                            return -(i + 1);
                        {
                            uint8_t *tok = op++;
                            if (lit >= 15) {
                                *tok = 15 << 4;
                                op = emit_length(op, lit);
                            } else
                                *tok = (uint8_t)(lit << 4);
                            /* fixed-size wildcopy for short literals
                             * (junk tail overwritten by the next
                             * bytes); guarded against reading past the
                             * source block — inputs are zero-copy
                             * Python buffers with no slack */
                            if (lit <= 16 && anchor + 16 <= iend)
                                memcpy(op, anchor, 16);
                            else
                                memcpy(op, anchor, lit);
                            op += lit;
                            *op++ = (uint8_t)(off & 0xFF);
                            *op++ = (uint8_t)(off >> 8);
                            if (mlc >= 15) {
                                *tok |= 15;
                                op = emit_length(op, mlc);
                            } else
                                *tok |= (uint8_t)mlc;
                        }
                    }
                    ip += ml;
                    anchor = ip;
                    searchN = (unsigned)step_base << 6;
                    /* keep the table warm across the skipped span */
                    if (ip - 2 >= src && ip <= mflimit)
                        htab[hash4(read32(ip - 2))] =
                            (uint32_t)(ip - 2 - src);
                } else {
                    ip += searchN++ >> 6;
                }
            }
        }
        {
            size_t lit = (size_t)(iend - anchor);
            if (op + 1 + lit + lit / 255 + 1 > oend) return -(i + 1);
            if (lit >= 15) {
                *op++ = 15 << 4;
                op = emit_length(op, lit);
            } else
                *op++ = (uint8_t)(lit << 4);
            memcpy(op, anchor, lit);
            op += lit;
        }
        sizes[i] = (int32_t)(op - dst0);
    }
    return 0;
}
