/* Clean-room XXH32 (public xxHash32 algorithm) — native host backend for
 * lz4_tpu frame checksums. Compiled on demand by lz4_tpu/native/__init__.py.
 *
 * Behavioural spec: xxHash spec (the reference vendors an implementation at
 * lib/xxhash.c; this file is an original implementation of the published
 * algorithm).
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define P1 2654435761u
#define P2 2246822519u
#define P3 3266489917u
#define P4  668265263u
#define P5  374761393u

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static inline uint32_t round32(uint32_t acc, uint32_t lane) {
    acc += lane * P2;
    acc = rotl32(acc, 13);
    acc *= P1;
    return acc;
}

static inline uint32_t read32le(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ == __ORDER_BIG_ENDIAN__)
    v = __builtin_bswap32(v);
#endif
    return v;
}

uint32_t lz4t_xxh32(const uint8_t *data, size_t len, uint32_t seed) {
    const uint8_t *p = data;
    const uint8_t *end = data + len;
    uint32_t h;

    if (len >= 16) {
        uint32_t a1 = seed + P1 + P2;
        uint32_t a2 = seed + P2;
        uint32_t a3 = seed;
        uint32_t a4 = seed - P1;
        const uint8_t *limit = end - 16;
        do {
            a1 = round32(a1, read32le(p));      p += 4;
            a2 = round32(a2, read32le(p));      p += 4;
            a3 = round32(a3, read32le(p));      p += 4;
            a4 = round32(a4, read32le(p));      p += 4;
        } while (p <= limit);
        h = rotl32(a1, 1) + rotl32(a2, 7) + rotl32(a3, 12) + rotl32(a4, 18);
    } else {
        h = seed + P5;
    }

    h += (uint32_t)len;
    while (p + 4 <= end) {
        h += read32le(p) * P3;
        h = rotl32(h, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h += (*p) * P5;
        h = rotl32(h, 11) * P1;
        p++;
    }

    h ^= h >> 15;  h *= P2;
    h ^= h >> 13;  h *= P3;
    h ^= h >> 16;
    return h;
}

/* Streaming helper: run the 4-lane stripe rounds over a whole-stripe buffer
 * (len must be a multiple of 16), updating accs in place. */
void lz4t_xxh32_rounds(const uint8_t *data, size_t len, uint32_t *accs) {
    const uint8_t *p = data;
    const uint8_t *end = data + len;
    uint32_t a1 = accs[0], a2 = accs[1], a3 = accs[2], a4 = accs[3];
    while (p + 16 <= end) {
        a1 = round32(a1, read32le(p));      p += 4;
        a2 = round32(a2, read32le(p));      p += 4;
        a3 = round32(a3, read32le(p));      p += 4;
        a4 = round32(a4, read32le(p));      p += 4;
    }
    accs[0] = a1; accs[1] = a2; accs[2] = a3; accs[3] = a4;
}

/* Batch: checksum nblocks blocks laid out contiguously with stride `cap`,
 * each of length lengths[i]. */
void lz4t_xxh32_batch(const uint8_t *blocks, size_t cap, size_t nblocks,
                      const uint32_t *lengths, uint32_t seed, uint32_t *out) {
    size_t i;
    for (i = 0; i < nblocks; i++) {
        out[i] = lz4t_xxh32(blocks + i * cap, lengths[i], seed);
    }
}

/* ---------------- XXH64 (public algorithm spec) ---------------------- */

#define P64_1 11400714785074694791ULL
#define P64_2 14029467366897019727ULL
#define P64_3 1609587929392839161ULL
#define P64_4 9650029242287828579ULL
#define P64_5 2870177450012600261ULL

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}
static inline uint64_t read64(const uint8_t *p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}
static inline uint64_t x64_round(uint64_t acc, uint64_t input) {
    acc += input * P64_2;
    acc = rotl64(acc, 31);
    return acc * P64_1;
}
static inline uint64_t x64_merge(uint64_t acc, uint64_t val) {
    acc ^= x64_round(0, val);
    return acc * P64_1 + P64_4;
}

uint64_t lz4t_xxh64(const uint8_t *p, size_t len, uint64_t seed) {
    const uint8_t *end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P64_1 + P64_2;
        uint64_t v2 = seed + P64_2;
        uint64_t v3 = seed;
        uint64_t v4 = seed - P64_1;
        const uint8_t *limit = end - 32;
        do {
            v1 = x64_round(v1, read64(p)); p += 8;
            v2 = x64_round(v2, read64(p)); p += 8;
            v3 = x64_round(v3, read64(p)); p += 8;
            v4 = x64_round(v4, read64(p)); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12)
            + rotl64(v4, 18);
        h = x64_merge(h, v1);
        h = x64_merge(h, v2);
        h = x64_merge(h, v3);
        h = x64_merge(h, v4);
    } else {
        h = seed + P64_5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= x64_round(0, read64(p));
        h = rotl64(h, 27) * P64_1 + P64_4;
        p += 8;
    }
    if (p + 4 <= end) {
        uint32_t w; memcpy(&w, p, 4);
        h ^= (uint64_t)w * P64_1;
        h = rotl64(h, 23) * P64_2 + P64_3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P64_5;
        h = rotl64(h, 11) * P64_1;
        p++;
    }
    h ^= h >> 33;
    h *= P64_2;
    h ^= h >> 29;
    h *= P64_3;
    h ^= h >> 32;
    return h;
}
