/* XXH64 one-shot hash, implemented clean-room from the published xxHash
 * algorithm specification (https://github.com/Cyan4973/xxHash/blob/dev/doc/xxhash_spec.md).
 * Used for the zstd frame Content_Checksum (low 32 bits of XXH64(data, seed=0)),
 * matching the behavior the reference gets from its vendored xxhash
 * (zstd's lib/common/xxhash.h).
 *
 * Copy of native/xxh64.c.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define P1 11400714785074694791ULL
#define P2 14029467366897019727ULL
#define P3 1609587929392839161ULL
#define P4 9650029242287828579ULL
#define P5 2870177450012600261ULL

static inline uint64_t rotl64(uint64_t v, int r) { return (v << r) | (v >> (64 - r)); }

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v; /* little-endian hosts only */
}
static inline uint32_t read32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}

static inline uint64_t round64(uint64_t acc, uint64_t lane) {
    acc += lane * P2;
    acc = rotl64(acc, 31);
    return acc * P1;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
    acc ^= round64(0, val);
    return acc * P1 + P4;
}

uint64_t zt_xxh64(const uint8_t* input, size_t len, uint64_t seed) {
    const uint8_t* p = input;
    const uint8_t* const end = input + len;
    uint64_t h;

    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2;
        uint64_t v2 = seed + P2;
        uint64_t v3 = seed;
        uint64_t v4 = seed - P1;
        const uint8_t* const limit = end - 32;
        do {
            v1 = round64(v1, read64(p));      p += 8;
            v2 = round64(v2, read64(p));      p += 8;
            v3 = round64(v3, read64(p));      p += 8;
            v4 = round64(v4, read64(p));      p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = merge_round(h, v1);
        h = merge_round(h, v2);
        h = merge_round(h, v3);
        h = merge_round(h, v4);
    } else {
        h = seed + P5;
    }

    h += (uint64_t)len;

    while (p + 8 <= end) {
        h ^= round64(0, read64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }

    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ---- streaming state (reset/update/digest), same algorithm ---- */

typedef struct {
    uint64_t v1, v2, v3, v4;
    uint64_t total_len;
    uint64_t seed;
    uint8_t  mem[32];
    uint32_t memsize;
} zt_xxh64_state;

void zt_xxh64_reset(zt_xxh64_state* s, uint64_t seed) {
    s->v1 = seed + P1 + P2;
    s->v2 = seed + P2;
    s->v3 = seed;
    s->v4 = seed - P1;
    s->total_len = 0;
    s->seed = seed;
    s->memsize = 0;
}

void zt_xxh64_update(zt_xxh64_state* s, const uint8_t* input, size_t len) {
    const uint8_t* p = input;
    const uint8_t* const end = input + len;
    s->total_len += len;
    if (s->memsize + len < 32) {
        memcpy(s->mem + s->memsize, input, len);
        s->memsize += (uint32_t)len;
        return;
    }
    if (s->memsize) {
        uint32_t fill = 32 - s->memsize;
        memcpy(s->mem + s->memsize, p, fill);
        s->v1 = round64(s->v1, read64(s->mem));
        s->v2 = round64(s->v2, read64(s->mem + 8));
        s->v3 = round64(s->v3, read64(s->mem + 16));
        s->v4 = round64(s->v4, read64(s->mem + 24));
        p += fill;
        s->memsize = 0;
    }
    if (p + 32 <= end) {
        const uint8_t* const limit = end - 32;
        uint64_t v1 = s->v1, v2 = s->v2, v3 = s->v3, v4 = s->v4;
        do {
            v1 = round64(v1, read64(p));      p += 8;
            v2 = round64(v2, read64(p));      p += 8;
            v3 = round64(v3, read64(p));      p += 8;
            v4 = round64(v4, read64(p));      p += 8;
        } while (p <= limit);
        s->v1 = v1; s->v2 = v2; s->v3 = v3; s->v4 = v4;
    }
    if (p < end) {
        memcpy(s->mem, p, (size_t)(end - p));
        s->memsize = (uint32_t)(end - p);
    }
}

uint64_t zt_xxh64_digest(const zt_xxh64_state* s) {
    uint64_t h;
    const uint8_t* p = s->mem;
    const uint8_t* const end = s->mem + s->memsize;
    if (s->total_len >= 32) {
        h = rotl64(s->v1, 1) + rotl64(s->v2, 7) + rotl64(s->v3, 12)
          + rotl64(s->v4, 18);
        h = merge_round(h, s->v1);
        h = merge_round(h, s->v2);
        h = merge_round(h, s->v3);
        h = merge_round(h, s->v4);
    } else {
        h = s->seed + P5;
    }
    h += s->total_len;
    while (p + 8 <= end) {
        h ^= round64(0, read64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

size_t zt_xxh64_state_size(void) { return sizeof(zt_xxh64_state); }
