/* Host-side LZ4 block codec (C) — the native runtime fallback used for
 * small inputs and CLI pass-through paths where a device dispatch is not
 * worth the latency.
 *
 * Original implementation written against the normative block format
 * (lz4 doc/lz4_Block_format.md): token = (litlen<<4)|matlen
 * nibbles with 255-chained extensions, 2-byte LE offset (0 invalid),
 * minmatch 4, last 5 bytes literal, last match >= 12 bytes before end.
 * The compressor is a single-pass hash-table greedy matcher in the
 * spirit of the format's design; the decoder is a bounds-checked
 * sequence interpreter (never reads/writes out of bounds).
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
static long lz4t__compress_impl(const uint8_t *src, long n, uint8_t *dst,
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

long lz4t_compress_block(const uint8_t *src, long n, uint8_t *dst,
                         long dst_cap, long dict_len, int accel) {
    return lz4t__compress_impl(src, n, dst, dst_cap, dict_len, accel,
                               WINDOW);
}

/* Distance-capped fast compression: identical format/parse, but match
 * offsets are bounded by max_dist. Streams stay fully standard; a
 * <= 2 KB cap keeps every match inside the wavefront decoder's cheap
 * near window (the favor-dec-speed trade taken to its TPU conclusion
 * — see decode_wave.py and the far-law note in tpu_perf_notes.md;
 * reference precedent lz4hc.c:926-928). */
long lz4t_compress_block_maxd(const uint8_t *src, long n, uint8_t *dst,
                              long dst_cap, long dict_len, int accel,
                              long max_dist) {
    if (max_dist < 1) max_dist = 1;
    if (max_dist > WINDOW) max_dist = WINDOW;
    return lz4t__compress_impl(src, n, dst, dst_cap, dict_len, accel,
                               max_dist);
}

/* Batch compression: nblocks independent blocks handed as a pointer
 * array (zero-copy from Python — each entry points straight at a bytes
 * object), outputs written at dst + i*dst_stride with sizes in
 * sizes[i]. Removes the per-block Python/ctypes marshalling and buffer
 * copies of the one-shot path. Reference analog: the CLI compresses
 * whole chunks through one cctx (lz4io.c:1130-1160) rather than
 * per-block API calls. Returns 0 on success, -(i+1) if block i failed
 * (dst_stride too small). */
long lz4t_compress_batch(const uint8_t **srcs, const int32_t *lens,
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

/* Fill-output compression (LZ4_compress_destSize behavioural analog,
 * lz4.h:589-681): compress as much of src as fits into exactly
 * dst_cap output bytes. Returns the compressed size; *consumed gets the
 * number of src bytes packed. */
long lz4t_compress_destsize(const uint8_t *src, long n, uint8_t *dst,
                            long dst_cap, long *consumed) {
    uint32_t htab[HASH_SIZE];
    const uint8_t *ip = src, *anchor = src;
    const uint8_t *iend = src + n;
    const uint8_t *mflimit = iend - MFLIMIT;
    const uint8_t *matchlimit = iend - LASTLITERALS;
    uint8_t *op = dst, *oend = dst + dst_cap;
    *consumed = 0;
    if (n == 0 || dst_cap < 1) {
        if (dst_cap >= 1) { *dst = 0; return 1; }
        return 0;
    }
    memset(htab, 0xFF, sizeof(htab));
    if (n >= MFLIMIT + 1) {
        while (ip <= mflimit) {
            uint32_t h = hash4(read32(ip));
            uint32_t cpos = htab[h];
            const uint8_t *cand = src + cpos;
            htab[h] = (uint32_t)(ip - src);
            if (cpos != 0xFFFFFFFFu && cand < ip &&
                (long)(ip - cand) <= WINDOW &&
                read32(cand) == read32(ip)) {
                size_t ml = MINMATCH +
                    match_len(ip + MINMATCH, cand + MINMATCH, matchlimit);
                while (ip > anchor && cand > src && ip[-1] == cand[-1]) {
                    ip--; cand--; ml++;
                }
                {
                    size_t lit = (size_t)(ip - anchor);
                    size_t off = (size_t)(ip - cand);
                    size_t mlc = ml - MINMATCH;
                    /* exact budget: this sequence + a closing token with
                     * enough literals to satisfy the end-of-block rules
                     * (last 5 bytes literal; last match >= 12 bytes
                     * before the end: ml >= 4 so 8 literals suffice) */
                    size_t need = 1 + lit + lit / 255 + 2
                        + (mlc >= 15 ? 1 + (mlc - 15) / 255 + 1 : 0) + 9;
                    if (op + need > oend)
                        break;        /* stop before this sequence */
                    {
                        uint8_t *tok = op++;
                        if (lit >= 15) { *tok = 15 << 4;
                            op = emit_length(op, lit); }
                        else *tok = (uint8_t)(lit << 4);
                        memcpy(op, anchor, lit); op += lit;
                        *op++ = (uint8_t)(off & 0xFF);
                        *op++ = (uint8_t)(off >> 8);
                        if (mlc >= 15) { *tok |= 15;
                            op = emit_length(op, mlc); }
                        else *tok |= (uint8_t)mlc;
                    }
                }
                ip += ml; anchor = ip;
            } else {
                ip++;
            }
        }
    }
    /* closing literals: as many as fit */
    {
        size_t avail = (size_t)(oend - op);
        size_t lit = (size_t)(iend - anchor);
        size_t fit;
        if (avail == 0) { *consumed = (long)(anchor - src);
            return (long)(op - dst); }
        /* solve lit header + lit <= avail */
        fit = lit;
        while (1 + (fit >= 15 ? 1 + (fit - 15) / 255 : 0) + fit > avail) {
            if (fit == 0) break;
            fit--;
        }
        if (fit >= 15) { *op++ = 15 << 4; op = emit_length(op, fit); }
        else *op++ = (uint8_t)(fit << 4);
        memcpy(op, anchor, fit); op += fit;
        anchor += fit;
    }
    *consumed = (long)(anchor - src);
    return (long)(op - dst);
}

/* Safe decode of comp[0..clen) into dst[0..cap); `dict`/`dict_len` is
 * the history window logically preceding dst. Returns the decoded size
 * or -1 on malformed input. Never reads/writes out of bounds. */
long lz4t_decompress_block(const uint8_t *comp, long clen, uint8_t *dst,
                           long cap, const uint8_t *dict, long dict_len) {
    const uint8_t *ip = comp, *iend = comp + clen;
    uint8_t *op = dst, *oend = dst + cap;

    if (clen <= 0) return -1;
    /* ---- fast loop: 16-byte wildcopies while both cursors are far
     * from their buffer ends (margins make every overrunning copy land
     * inside the buffers); drops to the exact loop below for the tail.
     * Structure follows the reference decoder's fastloop idea
     * (lz4.c:2075-2209); the code is written against the block format. */
    if (cap > 96 && clen > 32) {
        uint8_t *oend_fast = oend - 64;
        const uint8_t *iend_fast = iend - 32;
        while (op <= oend_fast && ip <= iend_fast) {
            /* bail points rewind to the sequence start: the exact loop
             * below must resume at a token boundary (literal re-copies
             * are idempotent) */
            const uint8_t *tok_ptr = ip;
            uint8_t *op_save = op;
            uint32_t token = *ip++;
            size_t lit = token >> 4;
            size_t mlen, off;
            if (lit < 15) {
                /* lit <= 14: one 16-byte wildcopy covers it; the junk
                 * tail is overwritten by the next copy */
                memcpy(op, ip, 16);
                op += lit; ip += lit;
            } else {
                uint8_t b;
                do {
                    if (ip >= iend) return -1;
                    b = *ip++;
                    lit += b;
                    if (lit > (size_t)cap + 65536u) return -1;
                } while (b == 255);
                if ((size_t)(iend - ip) < lit) return -1;
                if ((size_t)(oend - op) < lit) return -1;
                if (op + lit <= oend_fast && ip + lit <= iend_fast) {
                    const uint8_t *e = ip + lit;
                    uint8_t *o2 = op;
                    const uint8_t *i2 = ip;
                    do { memcpy(o2, i2, 32); o2 += 32; i2 += 32; }
                    while (i2 < e);
                    op += lit; ip = e;
                } else {
                    /* near an end: hand the whole sequence to the
                     * exact loop */
                    ip = tok_ptr; op = op_save;
                    goto fast_done;
                }
            }
            if ((size_t)(iend - ip) < 2 + 1 + LASTLITERALS ||
                (size_t)(oend - op) < MFLIMIT) {
                ip = tok_ptr; op = op_save;
                goto fast_done;
            }
            off = (size_t)ip[0] | ((size_t)ip[1] << 8);
            ip += 2;
            if (off == 0) return -1;
            mlen = token & 15;
            /* shortcut: nibble-sized match (<= 18 B) sourcing wholly
             * inside already-written output with no overlap hazard —
             * one 18-byte copy, no length/dict arbitration (reference
             * analog: the 16/18-byte shortcut of lz4.c:2213-2258) */
            if (mlen != 15 && off >= 18 && off <= (size_t)(op - dst)) {
                memcpy(op, op - off, 18);
                op += mlen + MINMATCH;
                continue;
            }
            if (mlen == 15) {
                uint8_t b;
                do {
                    if (ip >= iend) return -1;
                    b = *ip++;
                    mlen += b;
                    if (mlen > (size_t)cap + 65536u) return -1;
                } while (b == 255);
            }
            mlen += MINMATCH;
            if ((size_t)(oend - op) < mlen) return -1;
            {
                size_t pos = (size_t)(op - dst);
                if (off <= pos && op + mlen + 32 <= oend) {
                    const uint8_t *s2 = op - off;
                    uint8_t *e = op + mlen;
                    if (off >= 32) {
                        uint8_t *o2 = op;
                        do { memcpy(o2, s2, 32); o2 += 32; s2 += 32; }
                        while (o2 < e);
                        op = e;
                    } else if (off >= 16) {
                        uint8_t *o2 = op;
                        do { memcpy(o2, s2, 16); o2 += 16; s2 += 16; }
                        while (o2 < e);
                        op = e;
                    } else if (off == 1) {
                        memset(op, s2[0], mlen + 8);
                        op = e;
                    } else {
                        /* overlapping: stamp a 16-byte pattern with an
                         * off-aligned stride (overrun lands in-bounds);
                         * the pattern extends by self-repetition — no
                         * per-byte modulo */
                        uint8_t pat[16];
                        size_t i, stride = (16 / off) * off;
                        /* build by self-repetition: only s2[0..off) is
                         * decoded yet, everything past it is the very
                         * region being written */
                        memcpy(pat, s2, off);
                        for (i = off; i < 16; i++) pat[i] = pat[i - off];
                        {
                            uint8_t *o2 = op;
                            do { memcpy(o2, pat, 16); o2 += stride; }
                            while (o2 < e);
                        }
                        op = e;
                    }
                } else if (off > pos) {
                    if (off > pos + (size_t)dict_len) return -1;
                    {   /* dict-resident prefix: exact */
                        size_t dpos = (size_t)dict_len - (off - pos);
                        size_t take = off - pos;
                        if (take > mlen) take = mlen;
                        memcpy(op, dict + dpos, take);
                        op += take;
                        mlen -= take;
                        if (mlen) {
                            const uint8_t *s2 = op - off;
                            size_t i;
                            for (i = 0; i < mlen; i++) op[i] = s2[i];
                            op += mlen;
                        }
                    }
                } else {
                    const uint8_t *s2 = op - off;
                    size_t i;
                    if (off >= mlen) {
                        memcpy(op, s2, mlen);
                    } else {
                        for (i = 0; i < mlen; i++) op[i] = s2[i];
                    }
                    op += mlen;
                }
            }
        }
    fast_done:;
        /* fall through to the exact loop with ip at a sequence start */
    }
    for (;;) {
        size_t lit, mlen, off;
        uint32_t token;
        if (ip >= iend) return -1;
        token = *ip++;
        lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
                if (lit > (size_t)cap + 65536u) return -1;
            } while (b == 255);
        }
        if (lit) {
            if ((size_t)(iend - ip) < lit) return -1;
            if ((size_t)(oend - op) < lit) return -1;
            memcpy(op, ip, lit);
            ip += lit;
            op += lit;
        }
        if (ip == iend) break;            /* last sequence: literals only */
        /* parsing restrictions, enforced like the reference decoder
         * (lz4.c:2279-2318): a match sequence's literals must end at
         * least 2+1+LASTLITERALS bytes before the input end and MFLIMIT
         * bytes before the output end — otherwise the stream should
         * have terminated here and is invalid. */
        if ((size_t)(iend - ip) < 2 + 1 + LASTLITERALS) return -1;
        if ((size_t)(oend - op) < MFLIMIT) return -1;
        if (iend - ip < 2) return -1;
        off = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (off == 0) return -1;
        mlen = token & 15;
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
                if (mlen > (size_t)cap + 65536u) return -1;
            } while (b == 255);
        }
        mlen += MINMATCH;
        if ((size_t)(oend - op) < mlen) return -1;
        {
            size_t pos = (size_t)(op - dst);
            if (off > pos + (size_t)dict_len) return -1;
            if (off > pos) {              /* starts inside the dict */
                size_t dpos = (size_t)dict_len - (off - pos);
                size_t take = off - pos;
                if (take > mlen) take = mlen;
                memcpy(op, dict + dpos, take);
                op += take;
                mlen -= take;
            }
            if (mlen) {                   /* in-output part, may overlap */
                const uint8_t *src2 = op - off;
                size_t i;
                if (off >= mlen) {
                    memcpy(op, src2, mlen);
                    op += mlen;
                } else {
                    for (i = 0; i < mlen; i++) op[i] = src2[i];
                    op += mlen;
                }
            }
        }
    }
    return (long)(op - dst);
}

/* Batch decode: nblocks independent blocks via a pointer array
 * (zero-copy from Python), outputs at dst + i*dst_stride, decoded
 * lengths in out_lens[i]. Removes the per-block Python/ctypes
 * marshalling of the one-shot path. Returns 0 on success, -(i+1) if
 * block i is malformed. */
long lz4t_decompress_batch(const uint8_t **srcs, const int32_t *clens,
                           long nblocks, uint8_t *dst, long dst_stride,
                           const int32_t *max_outs, int32_t *out_lens) {
    long i;
    for (i = 0; i < nblocks; i++) {
        long cap = max_outs[i];
        long r;
        if (cap > dst_stride) cap = dst_stride;
        r = lz4t_decompress_block(srcs[i], clens[i], dst + i * dst_stride,
                                  cap, (const uint8_t *)0, 0);
        if (r < 0) return -(i + 1);
        out_lens[i] = (int32_t)r;
    }
    return 0;
}

/* ---- stream splitter for the device big-block decode path ----------
 *
 * Rewrites one LZ4 sequence stream into consecutive "pieces", each
 * decoding to at most out_limit bytes, each itself a valid sequence
 * stream whose matches may reach up to 64 KB back into the previous
 * pieces' output (the device decodes pieces as a linked chain with the
 * 64 KB rolling-history dict mode). Sequences crossing a piece
 * boundary are split: literal runs become two runs; matches become
 * two match sequences with the same offset (both halves >= MINMATCH,
 * the cut moves left when needed). A piece may end directly after a
 * match with a bare 0x00 token tail — the device kernel decodes
 * pieces in "loose" mode, which drops the end-of-block MFLIMIT checks
 * that only hold for whole blocks (lz4.c:242-249).
 *
 * dst is an arena of max_pieces rows with stride piece_cap.
 * Returns the piece count, -1 on malformed input, -2 on capacity. */

static uint8_t *lz4t__wr_lits(uint8_t *op, const uint8_t *lp, long L,
                              int matnib) {
    if (L < 15) {
        *op++ = (uint8_t)((L << 4) | matnib);
    } else {
        long rem = L - 15;
        *op++ = (uint8_t)(0xF0 | matnib);
        while (rem >= 255) { *op++ = 255; rem -= 255; }
        *op++ = (uint8_t)rem;
    }
    if (L > 0) { memcpy(op, lp, (size_t)L); op += L; }
    return op;
}

long lz4t_split_stream(const uint8_t *src, long n, uint8_t *dst,
                       long piece_cap, long max_pieces, long out_limit,
                       long out_cap, int32_t *piece_lens,
                       int32_t *piece_outs) {
    const uint8_t *ip = src, *iend = src + n;
    long pi = 0;
    uint8_t *pstart = dst, *op = dst;
    long opos = 0;
    long og = 0;              /* whole-block output position */
    int tail_is_lits = 0;     /* current piece already ends in literals */

    if (max_pieces < 1 || out_limit < 16) return -2;
    if (n <= 0) return -1;    /* empty streams are invalid LZ4 */

#define LZ4T_CLOSE_PIECE() do {                                        \
        if (!tail_is_lits) *op++ = 0x00;                               \
        piece_lens[pi] = (int32_t)(op - pstart);                       \
        piece_outs[pi] = (int32_t)opos;                                \
        pi++;                                                          \
        if (pi >= max_pieces) return -2;                               \
        pstart = dst + pi * piece_cap;                                 \
        op = pstart; opos = 0; tail_is_lits = 0;                       \
    } while (0)

    while (ip < iend) {
        long tok, L, ML, off, lrem, mrem, first;
        const uint8_t *lp;
        tok = *ip++;
        L = tok >> 4;
        if (L == 15) {
            unsigned b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                L += b;
            } while (b == 255);
        }
        if (iend - ip < L) return -1;
        lp = ip;
        ip += L;
        if (ip >= iend) {           /* final literal-only sequence */
            ML = 0; off = 0;
        } else {
            /* whole-block parsing restrictions (lz4.c:2279-2318): the
             * pieces decode in loose mode, so the splitter must hold
             * the strict contract the per-tier decoders enforce —
             * non-final literals end >= 2+1+LASTLITERALS before the
             * input end, matches start >= MFLIMIT and end >=
             * LASTLITERALS before the output cap */
            if (iend - ip < 2 + 1 + 5) return -1;
            if (og + L > out_cap - 12) return -1;
            off = ip[0] | ((long)ip[1] << 8);
            ip += 2;
            if (off == 0) return -1;
            ML = (tok & 15);
            if (ML == 15) {
                unsigned b;
                do {
                    if (ip >= iend) return -1;
                    b = *ip++;
                    ML += b;
                } while (b == 255);
            }
            ML += 4;
            if (og + L + ML > out_cap - 5) return -1;
        }
        if (og + L > out_cap) return -1;
        og += L + ML;

        /* literal chunks that do not fit become literal tails */
        lrem = L;
        while (lrem > out_limit - opos) {
            long t = out_limit - opos;
            if (op + t + 300 > pstart + piece_cap) return -2;
            op = lz4t__wr_lits(op, lp, t, 0);
            opos += t; lp += t; lrem -= t;
            tail_is_lits = 1;
            LZ4T_CLOSE_PIECE();
        }

        if (ML == 0) {              /* block tail: flush and finish */
            if (op + lrem + 300 > pstart + piece_cap) return -2;
            op = lz4t__wr_lits(op, lp, lrem, 0);
            opos += lrem;
            tail_is_lits = 1;
            break;
        }

        /* one or more match sequences, splitting at piece boundaries */
        first = 1;
        mrem = ML;
        while (mrem > 0) {
            long lits_here = first ? lrem : 0;
            long space = out_limit - opos - lits_here;
            long m, m4;
            if (space < 4) {
                if (lits_here) {
                    if (op + lits_here + 300 > pstart + piece_cap)
                        return -2;
                    op = lz4t__wr_lits(op, lp, lits_here, 0);
                    opos += lits_here;
                    tail_is_lits = 1;
                    first = 0;
                }
                LZ4T_CLOSE_PIECE();
                continue;
            }
            m = mrem <= space ? mrem : space;
            if (m < mrem && mrem - m < 4) m = mrem - 4;
            if (m < 4) { /* can't carve >=4 here: close, retry fresh */
                if (lits_here) {
                    if (op + lits_here + 300 > pstart + piece_cap)
                        return -2;
                    op = lz4t__wr_lits(op, lp, lits_here, 0);
                    opos += lits_here;
                    tail_is_lits = 1;
                    first = 0;
                }
                LZ4T_CLOSE_PIECE();
                continue;
            }
            m4 = m - 4;
            if (op + lits_here + 300 > pstart + piece_cap) return -2;
            op = lz4t__wr_lits(op, lp, lits_here,
                               (int)(m4 < 15 ? m4 : 15));
            opos += lits_here;
            *op++ = (uint8_t)(off & 255);
            *op++ = (uint8_t)(off >> 8);
            if (m4 >= 15) {
                long rem = m4 - 15;
                while (rem >= 255) { *op++ = 255; rem -= 255; }
                *op++ = (uint8_t)rem;
            }
            opos += m;
            mrem -= m;
            first = 0;
            tail_is_lits = 0;
        }
    }
    /* final piece */
    piece_lens[pi] = (int32_t)(op - pstart);
    piece_outs[pi] = (int32_t)opos;
    return pi + 1;
#undef LZ4T_CLOSE_PIECE
}

/* ---- wave splitter for the 128-lane lockstep decode kernel ---------
 *
 * Re-lays one LZ4 sequence stream (lz4.c:2022-2445 grammar) into the
 * kernel-internal WAVE format: fixed-address pieces of EXACTLY
 * LZ4T_WAVE_OUT decoded bytes each (the final piece may be shorter),
 * piece k's compressed bytes at dst[k*LZ4T_WAVE_CAP ...]. The fixed
 * output-proportional placement is what lets 128 independent lanes
 * share one deterministic sliding comp window on the TPU (no per-lane
 * windows, no scatters): at output row q every lane's cursor lives in
 * piece q/(LZ4T_WAVE_OUT/4)'s fixed slot.
 *
 * WAVE sequence grammar (all lengths capped, NO 255-chains):
 *   token: hi-nibble lit_nib, lo-nibble m_nib
 *   +1 ext byte iff lit_nib == 15:  litlen = 15 + ext   (<= 255)
 *   litlen literal bytes
 *   if m_nib > 0: 2-byte LE offset;
 *     +1 ext byte iff m_nib == 15:  mlen = 15 + ext     (<= 255)
 *   else mlen = 0 (literal-only sequence, no offset bytes)
 *   mlen is the RAW copy length (no +MINMATCH): boundary fragments of
 *   1..3 bytes are legal — sequences never cross a piece boundary
 *   (matches split into same-offset parts, literal runs into chunks).
 *
 * Invariants the kernel's branch-free 2-parse-slot row loop relies on
 * (verified by tests/test_wave.py::test_row_start_invariant):
 *   - any 4-byte output row contains <= 2 sequence starts (chunk
 *     smoothing keeps cap-forced remainders >= 4; tiny fragments only
 *     at piece edges / the block tail, always preceded and followed by
 *     >= 4-byte sequences);
 *   - per-row comp consumption <= 2 headers (5B each) + 4 literal
 *     bytes = 14, so a 5-word (20B) lookahead window from the cursor
 *     covers any row at any alignment;
 *   - a piece slot never exceeds LZ4T_WAVE_CAP bytes (worst case is
 *     all-literal: 1024 + 5 headers ~ 1035).
 *
 * The splitter VALIDATES the stream completely (the strict whole-block
 * rules of lz4.c:2279-2318 plus offset-vs-history) — the device kernel
 * itself runs checkless; malformed streams return -1 here and the
 * caller falls back to the strict host decoder for the real error.
 *
 * Returns the piece count (>0), -1 malformed, -2 capacity. *out_len
 * gets the total decoded size. hist_len is the linked/dict history
 * available before output position 0 (0 for independent blocks). */

#define LZ4T_WAVE_OUT 1024L
#define LZ4T_WAVE_CAP 1088L

static uint8_t *lz4t__wave_emit(uint8_t *op, const uint8_t *lp, long L,
                                long off, long M) {
    long ln = L < 15 ? L : 15, mn = M < 15 ? M : 15;
    *op++ = (uint8_t)((ln << 4) | mn);
    if (ln == 15) *op++ = (uint8_t)(L - 15);
    if (L > 0) { memcpy(op, lp, (size_t)L); op += L; }
    if (M > 0) {
        *op++ = (uint8_t)(off & 255);
        *op++ = (uint8_t)(off >> 8);
        if (mn == 15) *op++ = (uint8_t)(M - 15);
    }
    return op;
}

long lz4t_wave_split(const uint8_t *src, long n, uint8_t *dst,
                     long max_pieces, long out_cap, long hist_len,
                     int32_t *out_len) {
    const uint8_t *ip = src, *iend = src + n;
    long og = 0;
    uint8_t *op = dst;
    long slot = 0;
    int ended = 0;   /* saw the final literal-only sequence */

    if (n <= 0 || max_pieces < 1) return -1;

#define LZ4T_WAVE_ADVANCE() do {                                       \
        long s_ = og / LZ4T_WAVE_OUT;                                  \
        if (s_ != slot && og < out_cap) {                              \
            if (s_ >= max_pieces) return -2;                           \
            slot = s_;                                                 \
            op = dst + slot * LZ4T_WAVE_CAP;                           \
        }                                                              \
    } while (0)

#define LZ4T_WAVE_ROOM(sz_) do {                                       \
        if (op + (sz_) > dst + slot * LZ4T_WAVE_CAP + LZ4T_WAVE_CAP)   \
            return -2;                                                 \
    } while (0)

    while (ip < iend) {
        long tok, L, ML, off = 0, mrem, first;
        const uint8_t *lp;
        tok = *ip++;
        L = tok >> 4;
        if (L == 15) {
            unsigned b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                L += b;
            } while (b == 255);
        }
        if (iend - ip < L) return -1;
        lp = ip;
        ip += L;
        if (ip >= iend) {
            ML = 0;                       /* final literal-only seq */
        } else {
            /* strict whole-block rules (lz4.c:2279-2318) */
            if (iend - ip < 2 + 1 + 5) return -1;
            if (og + L > out_cap - 12) return -1;
            off = ip[0] | ((long)ip[1] << 8);
            ip += 2;
            if (off == 0) return -1;
            if (off > og + L + hist_len) return -1;
            ML = (tok & 15);
            if (ML == 15) {
                unsigned b;
                do {
                    if (ip >= iend) return -1;
                    b = *ip++;
                    ML += b;
                } while (b == 255);
            }
            ML += 4;
            if (og + L + ML > out_cap - 5) return -1;
        }
        if (og + L + ML > out_cap) return -1;

        /* literal chunks until the remainder can ride the match seq */
        while (L > 0) {
            long space = LZ4T_WAVE_OUT - (og % LZ4T_WAVE_OUT);
            long l;
            if (ML > 0 && L <= 255 && L < space) break;
            l = L;
            if (l > 255) l = 255;
            if (l > space) l = space;
            LZ4T_WAVE_ROOM(2 + l);
            op = lz4t__wave_emit(op, lp, l, 0, 0);
            lp += l; L -= l; og += l;
            LZ4T_WAVE_ADVANCE();
        }
        if (ML == 0) { ended = 1; break; } /* block tail emitted above */

        mrem = ML;
        first = 1;
        while (mrem > 0) {
            long space = LZ4T_WAVE_OUT - (og % LZ4T_WAVE_OUT);
            long lh = first ? L : 0;
            long m = mrem;
            if (m > 255) m = 255;
            if (m > space - lh) m = space - lh;
            /* smoothing: a cap-forced split must not leave a 1..3-byte
             * remainder mid-piece (the <=2-starts-per-row invariant) */
            if (m == 255 && mrem - m > 0 && mrem - m < 4) m = mrem - 4;
            LZ4T_WAVE_ROOM(5 + lh);
            op = lz4t__wave_emit(op, lp, lh, off, m);
            og += lh + m;
            mrem -= m;
            if (first) { lp += L; L = 0; first = 0; }
            LZ4T_WAVE_ADVANCE();
        }
    }
    /* the format requires the LAST sequence to be literal-only
     * (doc/lz4_Block_format.md:110-129): a stream that ends right
     * after a match never took the tail branch above */
    if (!ended) return -1;
    *out_len = (int32_t)og;
    return og ? (og + LZ4T_WAVE_OUT - 1) / LZ4T_WAVE_OUT : -1;
#undef LZ4T_WAVE_ADVANCE
#undef LZ4T_WAVE_ROOM
}

/* Batch wave re-layout: n streams into one arena array (n slots of
 * max_pieces*LZ4T_WAVE_CAP bytes each, caller-zeroed). One C call per
 * batch (the GIL is released for the whole pass). Returns 0, or
 * -(i+1) when stream i is malformed/overflows. */
long lz4t_wave_split_batch(const uint8_t **srcs, const int32_t *lens,
                           long n, uint8_t *arenas, long max_pieces,
                           const int32_t *out_caps, int32_t *out_lens) {
    long i;
    long stride = max_pieces * LZ4T_WAVE_CAP;
    for (i = 0; i < n; i++) {
        long r = lz4t_wave_split(srcs[i], lens[i], arenas + i * stride,
                                 max_pieces, out_caps[i], 0,
                                 out_lens + i);
        if (r < 0) return -(i + 1);
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Wave-encode emission: dense per-row match DECISIONS from the
 * 128-lane lockstep match finder (block/encode_wave.py) -> standard
 * LZ4 sequence bytes. Decision word (one per 4 input bytes):
 * off(16b) | end_sub(2b) | (mlen-4)(14b); zero = no match ends in the
 * row. The kernel finds matches, this pass serializes them at memcpy
 * speed and applies the host-side catch-up (back-extension over
 * preceding literals, the lz4.c:1104-1109 behaviour) plus the
 * end-of-block legality re-checks (MFLIMIT/LASTLITERALS,
 * lz4.c:242-249). */
static long lz4t__emit_decisions_one(const uint8_t *src, long n,
                                     const int32_t *dec, long n_rows,
                                     uint8_t *dst, long cap) {
    uint8_t *op = dst, *oend = dst + cap;
    long anchor = 0;
    long r;
    long rows = (n + 3) >> 2;
    if (rows > n_rows) rows = n_rows;
    for (r = 0; r < rows; r++) {
        uint32_t d = (uint32_t)dec[r];
        long off, sub, mlen, q, a, lit, ml;
        if (!d) continue;
        off = (long)(d & 0xFFFFu);
        sub = (long)((d >> 16) & 3u);
        mlen = (long)(d >> 18) + 4;
        q = 4 * r + sub;
        a = q - mlen;
        if (a < anchor || a > n - 12 || q > n - 5 || off < 1) continue;
        /* catch-up: extend backward over pending literals */
        while (a > anchor && a > off && src[a - 1] == src[a - 1 - off]) {
            a--;
            mlen++;
        }
        lit = a - anchor;
        ml = mlen - 4;
        if (op + 1 + lit + (lit / 255 + 1) + 2 + (ml / 255 + 1) > oend)
            return -1;
        *op++ = (uint8_t)(((lit < 15 ? lit : 15) << 4)
                          | (ml < 15 ? ml : 15));
        if (lit >= 15) op = emit_length(op, (size_t)lit);
        memcpy(op, src + anchor, (size_t)lit);
        op += lit;
        *op++ = (uint8_t)(off & 255);
        *op++ = (uint8_t)(off >> 8);
        if (ml >= 15) op = emit_length(op, (size_t)ml);
        anchor = q;
    }
    {
        long lit = n - anchor;
        if (op + 1 + lit + (lit / 255 + 1) > oend) return -1;
        *op++ = (uint8_t)((lit < 15 ? lit : 15) << 4);
        if (lit >= 15) op = emit_length(op, (size_t)lit);
        memcpy(op, src + anchor, (size_t)lit);
        op += lit;
    }
    return (long)(op - dst);
}

/* Batch form: decisions transposed to (lane, n_rows) int32; outputs at
 * dst + i*dst_stride. Returns 0, or -(i+1) when block i overflows its
 * capacity. */
long lz4t_wave_emit_decisions(const uint8_t **srcs, const int32_t *lens,
                              long nblocks, const int32_t *dec,
                              long n_rows, uint8_t *dst, long dst_stride,
                              int32_t *out_sizes) {
    long i;
    for (i = 0; i < nblocks; i++) {
        long r = lz4t__emit_decisions_one(srcs[i], lens[i],
                                          dec + i * n_rows, n_rows,
                                          dst + i * dst_stride,
                                          dst_stride);
        if (r < 0) return -(i + 1);
        out_sizes[i] = (int32_t)r;
    }
    return 0;
}
