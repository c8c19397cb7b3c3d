/* Minimal LZ4 block codec + XXH32, for the CLI's --format=lz4
 * passthrough (role of zstd's lz4 glue, programs/fileio.c:1213-1445,
 * which links liblz4; this ~200-line codec stands in for it so the format
 * works without a system dependency).
 *
 * Copy of native/lz4.c.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 *
 * Block format per the public LZ4 spec: token (hi nibble literal run,
 * lo nibble match length - 4, 15 = extended with 255-chains), literals,
 * 2-byte LE offset, match extension. End rules: the block ends with a
 * literals-only token, the last 5 bytes are literals, and no match
 * starts within 12 bytes of the end. Compressor is a greedy hash-4
 * matcher (own design; same class as the reference lz4 fast path).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

static inline uint32_t z4_rd32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}

static inline uint64_t z4_rd64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

static inline int64_t z4_ext(const uint8_t* a, const uint8_t* b,
                             const uint8_t* alim) {
    const uint8_t* a0 = a;
    while (a + 8 <= alim) {
        uint64_t x = z4_rd64(a) ^ z4_rd64(b);
        if (x) return (a - a0) + (__builtin_ctzll(x) >> 3);
        a += 8; b += 8;
    }
    while (a < alim && *a == *b) { a++; b++; }
    return a - a0;
}

#define Z4_HLOG 16
static inline uint32_t z4_hash(uint32_t v) {
    return (v * 2654435761u) >> (32 - Z4_HLOG);
}

/* compress one block; returns compressed size, or 0 if not compressible
 * within cap (caller emits the block raw) */
int64_t zt_lz4_block_compress(const uint8_t* src, int64_t n,
                              uint8_t* dst, int64_t cap) {
    if (n <= 0 || n > (int64_t)1 << 30) return 0;
    int32_t htab[1 << Z4_HLOG];
    memset(htab, -1, sizeof(htab));
    int64_t ip = 0, anchor = 0, op = 0;
    int64_t mflimit = n - 12;       /* no match may start past here */
    int64_t matchlimit = n - 5;     /* matches stop here: last 5 literal */

    while (ip < mflimit) {
        uint32_t h = z4_hash(z4_rd32(src + ip));
        int64_t cand = htab[h];
        htab[h] = (int32_t)ip;
        if (cand < 0 || ip - cand > 65535
            || z4_rd32(src + cand) != z4_rd32(src + ip)) {
            ip += 1 + ((ip - anchor) >> 9);
            continue;
        }
        int64_t ml = 4 + z4_ext(src + ip + 4, src + cand + 4,
                                src + matchlimit);
        /* backward extension into pending literals */
        while (ip > anchor && cand > 0 && src[ip - 1] == src[cand - 1]) {
            ip--; cand--; ml++;
        }
        int64_t lit = ip - anchor;
        int64_t off = ip - cand;
        /* worst-case emit: token + lit ext + lit + 2 + ml ext */
        if (op + 1 + lit / 255 + 1 + lit + 2 + ml / 255 + 1 + 16 > cap)
            return 0;
        uint8_t* tok = dst + op++;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t r = lit - 15;
            while (r >= 255) { dst[op++] = 255; r -= 255; }
            dst[op++] = (uint8_t)r;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        memcpy(dst + op, src + anchor, lit);
        op += lit;
        dst[op++] = (uint8_t)off;
        dst[op++] = (uint8_t)(off >> 8);
        int64_t mlx = ml - 4;
        if (mlx >= 15) {
            *tok |= 15;
            int64_t r = mlx - 15;
            while (r >= 255) { dst[op++] = 255; r -= 255; }
            dst[op++] = (uint8_t)r;
        } else {
            *tok |= (uint8_t)mlx;
        }
        /* index interior positions sparsely (every other) */
        int64_t next = ip + ml;
        for (int64_t j = ip + 2; j + 4 <= next && j < mflimit; j += 2)
            htab[z4_hash(z4_rd32(src + j))] = (int32_t)j;
        ip = next;
        anchor = next;
    }
    /* trailing literals-only token */
    {
        int64_t lit = n - anchor;
        if (op + 1 + lit / 255 + 1 + lit > cap) return 0;
        if (lit >= 15) {
            dst[op++] = 15 << 4;
            int64_t r = lit - 15;
            while (r >= 255) { dst[op++] = 255; r -= 255; }
            dst[op++] = (uint8_t)r;
        } else {
            dst[op++] = (uint8_t)(lit << 4);
        }
        memcpy(dst + op, src + anchor, lit);
        op += lit;
    }
    return op;
}

/* decompress one block appended at dst+start (bytes [0, start) are the
 * already-decoded history — block-LINKED frames match into it); returns
 * bytes produced or -1 on corruption */
int64_t zt_lz4_block_decompress(const uint8_t* src, int64_t n,
                                uint8_t* dst, int64_t cap, int64_t start) {
    int64_t ip = 0, op = start;
    while (ip < n) {
        uint8_t tok = src[ip++];
        int64_t lit = tok >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > n || op + lit > cap) return -1;
        memcpy(dst + op, src + ip, lit);
        ip += lit;
        op += lit;
        if (ip == n) break;          /* literals-only final token */
        if (ip + 2 > n) return -1;
        int64_t off = src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (off == 0 || off > op) return -1;
        int64_t ml = (tok & 15) + 4;
        if ((tok & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                ml += b;
            } while (b == 255);
        }
        if (op + ml > cap) return -1;
        const uint8_t* mp = dst + op - off;
        if (off >= 8) {
            for (int64_t c = 0; c < ml; c += 8) {
                if (op + c + 8 <= cap) memcpy(dst + op + c, mp + c, 8);
                else memcpy(dst + op + c, mp + c, ml - c);
            }
        } else {
            for (int64_t c = 0; c < ml; c++)
                dst[op + c] = mp[c];
        }
        op += ml;
    }
    return op - start;
}

/* ---- XXH32 (public spec; frame header + content checksums) ---- */
#define P32_1 2654435761u
#define P32_2 2246822519u
#define P32_3 3266489917u
#define P32_4 668265263u
#define P32_5 374761393u

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static inline uint32_t x32_round(uint32_t acc, uint32_t input) {
    acc += input * P32_2;
    return rotl32(acc, 13) * P32_1;
}

uint32_t zt_xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P32_1 + P32_2;
        uint32_t v2 = seed + P32_2;
        uint32_t v3 = seed;
        uint32_t v4 = seed - P32_1;
        const uint8_t* lim = end - 16;
        do {
            v1 = x32_round(v1, z4_rd32(p)); p += 4;
            v2 = x32_round(v2, z4_rd32(p)); p += 4;
            v3 = x32_round(v3, z4_rd32(p)); p += 4;
            v4 = x32_round(v4, z4_rd32(p)); p += 4;
        } while (p <= lim);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P32_5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h += z4_rd32(p) * P32_3;
        h = rotl32(h, 17) * P32_4;
        p += 4;
    }
    while (p < end) {
        h += (*p++) * P32_5;
        h = rotl32(h, 11) * P32_1;
    }
    h ^= h >> 15;
    h *= P32_2;
    h ^= h >> 13;
    h *= P32_3;
    h ^= h >> 16;
    return h;
}
