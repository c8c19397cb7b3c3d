/* Native block decoder: the host-runtime hot decode loop.
 *
 * Same role as the reference's decoder core (zstd_decompress_block.c
 * ZSTD_decompressBlock_internal, huf_decompress.c 4-stream loops, and the
 * hand-scheduled huf_decompress_amd64.S — the hot serial loop done native)
 * implemented from the RFC 8878 semantics mirrored by our Python oracle
 * (zstd_tpu/format/{literals,sequences,fse,huffman,block}.py).
 *
 * Context carries entropy state across blocks of one frame (repeat-mode
 * Huffman table and FSE tables, repcodes). The Python frame walker parses
 * frame/block headers and calls zt_decompress_block per compressed block.
 *
 * Copy of native/decode.c, with the offset-code value tables (OF_BASEV,
 * OF_BITSV) initialised at compile time: native/decode.c fills them on
 * first use behind a check of OF_BASEV[1], which is written before
 * entries 2-31, so a second thread could read zeros.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_BLOCK (128 * 1024)

/* ---- sequence code tables (RFC 8878) ---- */
static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* predefined distributions (RFC 8878 / zstd_internal.h) */
static const int16_t LL_DEF[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEF[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEF[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
#define LL_DEFLOG 6
#define ML_DEFLOG 6
#define OF_DEFLOG 5

/* ---- backward bit reader ---- */
typedef struct {
    const uint8_t* start;
    int64_t size;
    int64_t bit_pos;      /* bits remaining below the sentinel */
    int err;
} BitRd;

static int bitrd_init(BitRd* b, const uint8_t* src, int64_t size) {
    b->start = src;
    b->size = size;
    b->err = 0;
    if (size <= 0 || src[size - 1] == 0) { b->err = 1; return -1; }
    uint8_t last = src[size - 1];
    int high = 31 - __builtin_clz((uint32_t)last);
    b->bit_pos = (size - 1) * 8 + high;
    return 0;
}

static inline uint32_t bits_at(const BitRd* b, int64_t p, int nbits) {
    /* value of bits [p, p+nbits); caller guarantees p >= 0 */
    int64_t byte = p >> 3;
    int off = (int)(p & 7);
    uint64_t v;
    if (byte + 8 <= b->size) {
        memcpy(&v, b->start + byte, 8);          /* one unaligned load */
    } else {
        v = 0;
        for (int k = 0; byte + k < b->size && k < 8; k++)
            v |= (uint64_t)b->start[byte + k] << (8 * k);
    }
    return (uint32_t)((v >> off) & ((nbits >= 32) ? 0xFFFFFFFFu
                                                  : ((1u << nbits) - 1)));
}

static inline uint32_t bitrd_read(BitRd* b, int nbits) {
    if (nbits == 0) return 0;
    b->bit_pos -= nbits;
    if (b->bit_pos < 0) { b->err = 1; return 0; }
    return bits_at(b, b->bit_pos, nbits);
}

static inline int bitrd_done(const BitRd* b) { return b->bit_pos == 0 && !b->err; }

/* ---- FSE decode tables ---- */
typedef struct {
    uint8_t sym[1 << 9];
    uint8_t nb[1 << 9];
    uint16_t next[1 << 9];   /* baseline state */
    uint32_t base[1 << 9];   /* fused per-state value base (seq tables) */
    uint8_t xbits[1 << 9];   /* fused per-state extra-bit count */
    int log;
    int rle;                 /* rle mode: sym[0] repeated, 0 bits */
} FseDT;

static inline uint32_t highbit_u32(uint32_t v) { return 31 - __builtin_clz(v); }

static int fse_build_dtable(FseDT* t, const int16_t* counts, int n_sym,
                            int tlog) {
    int size = 1 << tlog;
    t->log = tlog;
    t->rle = 0;
    uint16_t symbol_next[256];
    int high = size - 1;
    /* low-prob symbols at the end */
    for (int s = 0; s < n_sym; s++) {
        if (counts[s] == -1) {
            t->sym[high--] = (uint8_t)s;
            symbol_next[s] = 1;
        } else {
            symbol_next[s] = (uint16_t)counts[s];
        }
    }
    /* spread */
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < n_sym; s++) {
        for (int i = 0; i < counts[s]; i++) {
            t->sym[pos] = (uint8_t)s;
            do { pos = (pos + step) & mask; } while (pos > high);
        }
    }
    if (pos != 0) return -1;
    for (int c = 0; c < size; c++) {
        uint8_t s = t->sym[c];
        uint16_t nxt = symbol_next[s]++;
        uint8_t nb = (uint8_t)(tlog - highbit_u32(nxt));
        t->nb[c] = nb;
        t->next[c] = (uint16_t)((nxt << nb) - size);
    }
    return 0;
}

/* variable-bit normalized-count header parse; exact mirror of the oracle
 * (zstd_tpu/format/fse.py read_ncount:256 — shrinking threshold scheme) */
static inline uint32_t nc_peek(const uint8_t* src, int64_t size,
                               int64_t bitpos, int nb) {
    uint64_t v = 0;
    int got = 0;
    int off = (int)(bitpos & 7);
    int64_t byte = bitpos >> 3;
    while (got < nb + off && got < 64) {
        uint8_t b = (byte + (got >> 3) < size) ? src[byte + (got >> 3)] : 0;
        v |= (uint64_t)b << got;
        got += 8;
    }
    return (uint32_t)((v >> off) & ((nb >= 32) ? 0xFFFFFFFFu
                                               : ((1u << nb) - 1)));
}

static int fse_read_ncount(const uint8_t* src, int64_t size, int16_t* counts,
                           int* n_sym_out, int* tlog_out, int max_sym) {
    if (size < 1) return -1;
    int64_t bitpos = 0;
    int tlog = (int)nc_peek(src, size, bitpos, 4) + 5;
    bitpos += 4;
    if (tlog > 9) return -1;
    int threshold = 1 << tlog;
    int nb_bits = tlog + 1;
    int remaining = threshold + 1;
    int charnum = 0;
    int prev0 = 0;
    for (int s = 0; s <= max_sym; s++) counts[s] = 0;
    while (remaining > 1 && charnum <= max_sym) {
        if (prev0) {
            while (1) {
                uint32_t rep = nc_peek(src, size, bitpos, 2);
                bitpos += 2;
                charnum += (int)rep;
                if (rep < 3) break;
            }
            if (charnum > max_sym) return -1;
        }
        int mx = (2 * threshold - 1) - remaining;
        uint32_t low = nc_peek(src, size, bitpos, nb_bits - 1)
                       & (uint32_t)(threshold - 1);
        int value;
        if ((int)low < mx) {
            value = (int)low;
            bitpos += nb_bits - 1;
        } else {
            uint32_t full = nc_peek(src, size, bitpos, nb_bits)
                            & (uint32_t)(2 * threshold - 1);
            bitpos += nb_bits;
            value = (int)full;
            if (value >= threshold) value -= mx;
        }
        int proba = value - 1;
        if (proba == -1) {
            remaining -= 1;
            counts[charnum] = -1;
        } else {
            remaining -= proba;
            counts[charnum] = (int16_t)proba;
        }
        charnum++;
        prev0 = (proba == 0);
        if (remaining < 1) return -1;
        while (remaining < threshold) { nb_bits--; threshold >>= 1; }
        if ((bitpos + 7) / 8 > size) return -1;
    }
    if (remaining != 1 || charnum < 2) return -1;
    *n_sym_out = charnum;
    *tlog_out = tlog;
    return (int)((bitpos + 7) / 8);
}

/* ---- Huffman ----
 * Double-symbol ("X2") decode table alongside the single-symbol arrays:
 * x2[idx] packs (sym0, sym1, nbBits, nSyms) for the top-`log` window so one
 * lookup emits up to two symbols (role of huf_decompress.c's
 * HUF_decompress4X2 tables; derivation is our own: a second X1 probe at the
 * shifted index determines whether the follow-up symbol is fully contained
 * in the window). Total consumed bits per entry never exceed `log`. */
typedef struct {
    uint8_t sym[1 << 11];
    uint8_t nb[1 << 11];
    uint32_t x2[1 << 11];    /* sym0 | sym1<<8 | nbBits<<16 | nSyms<<24 */
    int log;
    int valid;
} HufDT;

static int huf_build_dtable(HufDT* t, const uint8_t* weights, int n_sym) {
    /* weights (w>=0), last symbol's weight implied by completion */
    uint32_t wsum = 0;
    int maxw = 0;
    for (int s = 0; s < n_sym; s++) {
        if (weights[s] > 11) return -1;
        if (weights[s]) wsum += 1u << (weights[s] - 1);
        if (weights[s] > maxw) maxw = weights[s];
    }
    if (wsum == 0) return -1;
    int tlog = (int)highbit_u32(wsum) + 1;
    if (tlog > 11) return -1;
    uint32_t total = 1u << tlog;
    uint32_t rest = total - wsum;
    /* rest must be a power of two: the implied last weight */
    if (rest == 0 || (rest & (rest - 1))) return -1;
    int last_w = (int)highbit_u32(rest) + 1;
    /* rank count per weight */
    uint32_t rank_count[13] = {0};
    for (int s = 0; s < n_sym; s++) rank_count[weights[s]]++;
    rank_count[last_w]++;
    /* fill: ascending weight order -> canonical layout */
    uint32_t rank_start[14];
    uint32_t cur = 0;
    for (int w = 1; w <= 12; w++) {
        rank_start[w] = cur;
        cur += rank_count[w] << (w - 1);
    }
    if (cur != total) return -1;
    t->log = tlog;
    for (int s = 0; s <= n_sym; s++) {
        int w = (s == n_sym) ? last_w : weights[s];
        if (w == 0) continue;
        uint32_t len = 1u << (w - 1);
        uint8_t nb = (uint8_t)(tlog + 1 - w);
        for (uint32_t i = 0; i < len; i++) {
            t->sym[rank_start[w] + i] = (uint8_t)s;
            t->nb[rank_start[w] + i] = nb;
        }
        rank_start[w] += len;
    }
    /* derive the double-symbol table from the canonical single-symbol fill */
    {
        uint32_t size2 = 1u << tlog;
        uint32_t m = size2 - 1;
        for (uint32_t i = 0; i < size2; i++) {
            uint8_t nb1 = t->nb[i];
            uint8_t s0 = t->sym[i];
            uint32_t e = (uint32_t)s0 | ((uint32_t)s0 << 8)
                         | ((uint32_t)nb1 << 16) | (1u << 24);
            if (nb1 < tlog) {
                uint32_t j = (i << nb1) & m;
                uint8_t nb2 = t->nb[j];
                if (nb2 <= tlog - nb1)
                    e = (uint32_t)s0 | ((uint32_t)t->sym[j] << 8)
                        | ((uint32_t)(nb1 + nb2) << 16) | (2u << 24);
            }
            t->x2[i] = e;
        }
    }
    t->valid = 1;
    return 0;
}

/* Huffman tree description -> weights (direct or FSE-compressed) */
static int huf_read_weights(const uint8_t* src, int64_t size,
                            uint8_t* weights, int* n_sym_out) {
    if (size < 1) return -1;
    int hdr = src[0];
    if (hdr >= 128) {
        int n = hdr - 127;
        int nbytes = (n + 1) / 2;
        if (1 + nbytes > size) return -1;
        for (int i = 0; i < n; i++) {
            uint8_t b = src[1 + i / 2];
            weights[i] = (i & 1) ? (b & 0xF) : (b >> 4);
        }
        *n_sym_out = n;
        return 1 + nbytes;
    }
    /* FSE-compressed weights: hdr = compressed size */
    int csize = hdr;
    if (1 + csize > size) return -1;
    int16_t counts[256];
    int n_sym, tlog;
    int hsz = fse_read_ncount(src + 1, csize, counts, &n_sym, &tlog, 255);
    if (hsz < 0 || tlog > 6) return -1;
    FseDT dt;
    if (fse_build_dtable(&dt, counts, n_sym, tlog) < 0) return -1;
    BitRd br;
    if (bitrd_init(&br, src + 1 + hsz, csize - hsz) < 0) return -1;
    uint32_t s1 = bitrd_read(&br, tlog);
    uint32_t s2 = bitrd_read(&br, tlog);
    int n = 0;
    /* two interleaved states until the stream is exhausted */
    while (1) {
        if (br.err) return -1;
        weights[n++] = dt.sym[s1];
        if (br.bit_pos < dt.nb[s1]) {   /* s1 ends: flush both */
            if (n > 255) return -1;
            weights[n++] = dt.sym[s2];
            break;
        }
        s1 = dt.next[s1] + bitrd_read(&br, dt.nb[s1]);
        weights[n++] = dt.sym[s2];
        if (br.bit_pos < dt.nb[s2]) {
            if (n > 255) return -1;
            weights[n++] = dt.sym[s1];
            break;
        }
        s2 = dt.next[s2] + bitrd_read(&br, dt.nb[s2]);
        if (n > 254) return -1;
    }
    *n_sym_out = n;
    return 1 + csize;
}

/* continue decoding one stream whose BitRd is already positioned; starts at
 * dst[i0]. X2 fast loop (two symbols per table probe, up to five probes per
 * 64-bit reload), then a strict scalar tail. */
static int64_t huf_stream_continue(const HufDT* t, BitRd* br, uint8_t* dst,
                                   int64_t i0, int64_t n_out) {
    int tlog = t->log;
    uint32_t mask = (1u << tlog) - 1;
    int64_t i = i0;
    int64_t size = br->size;
    while (i + 10 <= n_out && br->bit_pos >= 57) {
        int64_t byte = (br->bit_pos - 57) >> 3;
        if (byte + 8 > size) break;
        uint64_t v;
        memcpy(&v, br->start + byte, 8);
        int64_t bb = byte << 3;
        /* each probe consumes <= tlog bits: 5 probes stay inside the load */
        for (int k = 0; k < 5; k++) {
            uint32_t e = t->x2[(uint32_t)((v >> (br->bit_pos - tlog - bb))
                                          & mask)];
            dst[i] = (uint8_t)e;
            dst[i + 1] = (uint8_t)(e >> 8);
            i += e >> 24;
            br->bit_pos -= (e >> 16) & 0xFF;
        }
    }
    return i;
}

/* decode one Huffman stream */
static int huf_decode_stream(const HufDT* t, const uint8_t* src, int64_t size,
                             uint8_t* dst, int64_t n_out) {
    BitRd br;
    if (bitrd_init(&br, src, size) < 0) return -1;
    int tlog = t->log;
    int64_t i = huf_stream_continue(t, &br, dst, 0, n_out);
    if (br.bit_pos < 0) return -1;
    for (; i < n_out; i++) {
        int64_t p = br.bit_pos - tlog;
        uint32_t idx;
        if (p >= 0) {
            idx = bits_at(&br, p, tlog);
        } else {
            /* fewer than tlog bits left: pad with zeros below */
            uint32_t have = (uint32_t)br.bit_pos;
            if ((int64_t)have <= 0) return -1;
            uint64_t v = 0;
            int got = 0;
            while (got < (int)have && got < 64) {
                v |= (uint64_t)br.start[got >> 3] << got;
                got += 8;
            }
            uint32_t bits = (uint32_t)(v & ((1u << have) - 1));
            idx = bits << (tlog - have);
        }
        dst[i] = t->sym[idx];
        br.bit_pos -= t->nb[idx];
        if (br.bit_pos < 0) return -1;
    }
    return bitrd_done(&br) ? 0 : -1;
}

/* decode the 4 jump-table streams of one literals section in lockstep:
 * four independent bit-reader chains give the out-of-order core ~4x ILP on
 * the serial lookup->shift->lookup dependency (role of the reference's
 * hand-scheduled 4-stream loop, huf_decompress_amd64.S). */
static int huf_decode_4streams(const HufDT* t, const uint8_t* srcs[4],
                               const int64_t sizes[4], uint8_t* dsts[4],
                               const int64_t n_outs[4]) {
    BitRd br[4];
    int64_t i[4];
    int tlog = t->log;
    uint32_t mask = (1u << tlog) - 1;
    for (int s = 0; s < 4; s++) {
        if (bitrd_init(&br[s], srcs[s], sizes[s]) < 0) return -1;
        i[s] = 0;
    }
    {
        /* hot rounds with all per-stream state in locals: the compiler
         * keeps shifts/counters in registers instead of reloading the
         * br[]/i[] arrays after every aliasing store (the role the
         * reference fills with hand-allocated registers in
         * huf_decompress_amd64.S) */
        const uint32_t* const x2 = t->x2;
        uint8_t* d0 = dsts[0]; uint8_t* d1 = dsts[1];
        uint8_t* d2 = dsts[2]; uint8_t* d3 = dsts[3];
        int64_t i0 = i[0], i1 = i[1], i2 = i[2], i3 = i[3];
        for (;;) {
            /* a full round: 5 probes/stream, <= 55 bits, <= 10 symbols */
            int ok = (i0 + 10 <= n_outs[0]) & (br[0].bit_pos >= 57)
                   & (((br[0].bit_pos - 57) >> 3) + 8 <= br[0].size)
                   & (i1 + 10 <= n_outs[1]) & (br[1].bit_pos >= 57)
                   & (((br[1].bit_pos - 57) >> 3) + 8 <= br[1].size)
                   & (i2 + 10 <= n_outs[2]) & (br[2].bit_pos >= 57)
                   & (((br[2].bit_pos - 57) >> 3) + 8 <= br[2].size)
                   & (i3 + 10 <= n_outs[3]) & (br[3].bit_pos >= 57)
                   & (((br[3].bit_pos - 57) >> 3) + 8 <= br[3].size);
            if (!ok) break;
            uint64_t v0, v1, v2, v3;
            int64_t byte0 = (br[0].bit_pos - 57) >> 3;
            int64_t byte1 = (br[1].bit_pos - 57) >> 3;
            int64_t byte2 = (br[2].bit_pos - 57) >> 3;
            int64_t byte3 = (br[3].bit_pos - 57) >> 3;
            memcpy(&v0, br[0].start + byte0, 8);
            memcpy(&v1, br[1].start + byte1, 8);
            memcpy(&v2, br[2].start + byte2, 8);
            memcpy(&v3, br[3].start + byte3, 8);
            /* shift cursors relative to the loaded word */
            int sh0 = (int)(br[0].bit_pos - (byte0 << 3)) - tlog;
            int sh1 = (int)(br[1].bit_pos - (byte1 << 3)) - tlog;
            int sh2 = (int)(br[2].bit_pos - (byte2 << 3)) - tlog;
            int sh3 = (int)(br[3].bit_pos - (byte3 << 3)) - tlog;
            for (int k = 0; k < 5; k++) {
                uint32_t e0 = x2[(uint32_t)((v0 >> sh0) & mask)];
                uint32_t e1 = x2[(uint32_t)((v1 >> sh1) & mask)];
                uint32_t e2 = x2[(uint32_t)((v2 >> sh2) & mask)];
                uint32_t e3 = x2[(uint32_t)((v3 >> sh3) & mask)];
                memcpy(d0 + i0, &e0, 2);
                memcpy(d1 + i1, &e1, 2);
                memcpy(d2 + i2, &e2, 2);
                memcpy(d3 + i3, &e3, 2);
                i0 += e0 >> 24; sh0 -= (e0 >> 16) & 0xFF;
                i1 += e1 >> 24; sh1 -= (e1 >> 16) & 0xFF;
                i2 += e2 >> 24; sh2 -= (e2 >> 16) & 0xFF;
                i3 += e3 >> 24; sh3 -= (e3 >> 16) & 0xFF;
            }
            br[0].bit_pos = (byte0 << 3) + sh0 + tlog;
            br[1].bit_pos = (byte1 << 3) + sh1 + tlog;
            br[2].bit_pos = (byte2 << 3) + sh2 + tlog;
            br[3].bit_pos = (byte3 << 3) + sh3 + tlog;
        }
        i[0] = i0; i[1] = i1; i[2] = i2; i[3] = i3;
    }
    /* drain each stream independently (X2 fast loop + strict scalar tail) */
    for (int s = 0; s < 4; s++) {
        int64_t n_out = n_outs[s];
        uint8_t* dst = dsts[s];
        BitRd* b = &br[s];
        int64_t j = huf_stream_continue(t, b, dst, i[s], n_out);
        for (; j < n_out; j++) {
            int64_t p = b->bit_pos - tlog;
            uint32_t idx;
            if (p >= 0) {
                idx = bits_at(b, p, tlog);
            } else {
                uint32_t have = (uint32_t)b->bit_pos;
                if ((int64_t)have <= 0) return -1;
                uint64_t v2 = 0;
                int got = 0;
                while (got < (int)have && got < 64) {
                    v2 |= (uint64_t)b->start[got >> 3] << got;
                    got += 8;
                }
                uint32_t bits = (uint32_t)(v2 & ((1u << have) - 1));
                idx = bits << (tlog - have);
            }
            dst[j] = t->sym[idx];
            b->bit_pos -= t->nb[idx];
            if (b->bit_pos < 0) return -1;
        }
        if (!bitrd_done(b)) return -1;
    }
    return 0;
}

/* ---- decoder context ---- */
typedef struct {
    HufDT huf;
    FseDT ll, of, ml;
    int seq_valid;
    uint32_t rep[3];
    uint8_t lits[MAX_BLOCK + 32];
} ZtDCtx;

void* zt_dctx_new(void) {
    ZtDCtx* c = calloc(1, sizeof(ZtDCtx));
    if (c) { c->rep[0] = 1; c->rep[1] = 4; c->rep[2] = 8; }
    return c;
}

void zt_dctx_free(void* c) { free(c); }

/* fold the symbol->(value base, extra bits) mapping into the state table so
 * the hot loop skips the code indirection (role of the reference's
 * seq_symbol tables, zstd_decompress_block.c ZSTD_buildFSETable) */
/* offset-code value tables: value = (1<<code) + extra (codes 0..31) */
static const uint32_t OF_BASEV[32] = {
    1u << 0, 1u << 1, 1u << 2, 1u << 3, 1u << 4, 1u << 5, 1u << 6, 1u << 7,
    1u << 8, 1u << 9, 1u << 10, 1u << 11, 1u << 12, 1u << 13, 1u << 14, 1u << 15,
    1u << 16, 1u << 17, 1u << 18, 1u << 19, 1u << 20, 1u << 21, 1u << 22, 1u << 23,
    1u << 24, 1u << 25, 1u << 26, 1u << 27, 1u << 28, 1u << 29, 1u << 30, 1u << 31,
};
static const uint8_t OF_BITSV[32] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
};

static int fuse_seq_table(FseDT* t, const uint32_t* bases,
                          const uint8_t* xbits, int n_codes) {
    int size = 1 << t->log;
    for (int c = 0; c < size; c++) {
        uint8_t s = t->sym[c];
        if (s >= n_codes) return -1;
        t->base[c] = bases[s];
        t->xbits[c] = xbits[s];
    }
    return 0;
}

static int build_seq_table(FseDT* t, const uint8_t** srcp, const uint8_t* end,
                           int mode, const int16_t* defaults, int n_def,
                           int n_codes, int deflog, int maxlog,
                           int valid_prev,
                           const uint32_t* bases, const uint8_t* xbits) {
    const uint8_t* src = *srcp;
    int r;
    if (mode == 0) {                       /* predefined */
        r = fse_build_dtable(t, defaults, n_def, deflog);
    } else if (mode == 1) {                /* RLE: a single-state 0-bit table
                                              (uniform with the FSE path so
                                              the hot loop stays branchless) */
        if (src >= end) return -1;
        t->rle = 0;
        t->sym[0] = *src;
        t->nb[0] = 0;
        t->next[0] = 0;
        t->log = 0;
        *srcp = src + 1;
        r = 0;
    } else if (mode == 2) {                /* FSE description */
        int16_t counts[64];
        int n_sym, tlog;
        int hsz = fse_read_ncount(src, end - src, counts, &n_sym, &tlog,
                                  n_codes - 1);
        if (hsz < 0 || tlog > maxlog) return -1;
        *srcp = src + hsz;
        r = fse_build_dtable(t, counts, n_sym, tlog);
    } else {
        return valid_prev ? 0 : -1;        /* repeat: keep fused table */
    }
    if (r < 0) return r;
    return fuse_seq_table(t, bases, xbits, n_codes);
}

/* execute one (ll, ml, offset) sequence: overshooting copies when the
 * destination has slack (dst buffers carry a block of headroom),
 * byte-exact fallbacks otherwise. The common shape on text-like data is
 * ll <= 16 and ml <= 16, so both copies are ONE 16-byte load/store pair
 * with loops only on the long tail (role of ZSTD_execSequence's copy16 +
 * wildcopy split, zstd_decompress_block.c:~1001, done with our own
 * small-offset stride table). */
/* long-match copy by exponential period doubling: once [0, done) of the
 * match is written with done a multiple of the offset (the pattern
 * period), op[done + i] == op[i], so each memcpy doubles the finished
 * region — a 100 KB match at offset 46 runs at libc-memcpy speed instead
 * of one stalled 16-byte overlap copy per step (the regime where the
 * reference's high-ratio frames decode at multi-GB/s). Caller guarantees
 * ml > prefix, bytes [0, prefix) already written, prefix >= 8. */
static inline void copy_match_doubling(uint8_t* op, int64_t ml,
                                       uint32_t offset, int64_t prefix) {
    if ((int64_t)offset >= ml) {
        memcpy(op + prefix, op - offset + prefix, ml - prefix);
        return;
    }
    int64_t done;
    if ((int64_t)offset <= prefix) {
        done = prefix - (prefix % offset);
    } else {
        /* fill the first full period; source is all before the match */
        memcpy(op + prefix, op - offset + prefix, offset - prefix);
        done = offset;
    }
    while (done < ml) {
        int64_t chunk = done < ml - done ? done : ml - done;
        memcpy(op + done, op, chunk);
        done += chunk;
    }
}

static inline __attribute__((always_inline)) int
exec_seq(uint8_t* dstBase, int64_t* io_out, const uint8_t* lits,
         int64_t* io_litpos, int64_t nlit, uint32_t ll, uint32_t ml,
         uint32_t offset, int64_t dstCap, int64_t windowLow) {
    int64_t out = *io_out;
    int64_t lit_pos = *io_litpos;
    if (lit_pos + ll > nlit) return -1;
    if (out + ll + ml > dstCap) return -1;
    /* single-branch fast path: the common sequence shape (short literals,
     * short match, non-overlapping offset, headroom) runs with NO further
     * branches — two 16B copies and the window check */
    if (((ll <= 16) & (ml <= 16) & (offset >= 8)
         & (out + ll + ml + 64 <= dstCap))
        && out - (int64_t)offset + ll >= windowLow) {
        uint8_t* op = dstBase + out;
        memcpy(op, lits + lit_pos, 16);
        op += ll;
        const uint8_t* mp = op - offset;
        memcpy(op, mp, 8);
        memcpy(op + 8, mp + 8, 8);
        *io_out = out + ll + ml;
        *io_litpos = lit_pos + ll;
        return 0;
    }
    if (out + ll + ml + 64 <= dstCap) {
        uint8_t* op = dstBase + out;
        const uint8_t* lp = lits + lit_pos;
        memcpy(op, lp, 16);
        if (ll > 16)
            for (int64_t c = 16; c < ll; c += 16)
                memcpy(op + c, lp + c, 16);
        lit_pos += ll;
        out += ll;
        op += ll;
        if (out - (int64_t)offset < windowLow) return -1;
        const uint8_t* mp = op - offset;
        if (offset >= 8) {
            /* one class for all non-overlapping-within-8 offsets: two 8B
             * copies cover ml <= 16 (the common case) without a second
             * offset-class branch to mispredict on mixed-offset data */
            memcpy(op, mp, 8);
            memcpy(op + 8, mp + 8, 8);
            if (ml > 16) {
                if (ml > 64) {
                    copy_match_doubling(op, ml, offset, 16);
                } else if (offset >= 16) {
                    for (int64_t c = 16; c < ml; c += 16)
                        memcpy(op + c, mp + c, 16);
                } else {
                    for (int64_t c = 16; c < ml; c += 8)
                        memcpy(op + c, mp + c, 8);
                }
            }
        } else {
            /* pattern period < 8: seed 8 bytes byte-wise, then jump the
             * source back by the smallest multiple of the period that is
             * >= 8 so 8-byte chunks never overlap their own output.
             * back8[o] = o * ceil(8/o); the re-read window (op - 6 at
             * worst) is inside the already-decoded output because
             * offset < 8 bytes precede the match start. */
            static const int8_t back8[8] = {0, 8, 8, 9, 8, 10, 12, 14};
            op[0] = mp[0]; op[1] = mp[1]; op[2] = mp[2]; op[3] = mp[3];
            op[4] = mp[4]; op[5] = mp[5]; op[6] = mp[6]; op[7] = mp[7];
            if (ml > 64) {
                copy_match_doubling(op, ml, offset, 8);
            } else if (ml > 8) {
                const uint8_t* ms = op + 8 - back8[offset];
                for (int64_t c = 8; c < ml; c += 8)
                    memcpy(op + c, ms + (c - 8), 8);
            }
        }
        out += ml;
    } else {
        memcpy(dstBase + out, lits + lit_pos, ll);
        lit_pos += ll;
        out += ll;
        if (out - (int64_t)offset < windowLow) return -1;
        /* overlap-safe doubling copy */
        int64_t from = out - offset;
        int64_t rem = ml;
        while (rem > 0) {
            int64_t chunk = out - from;      /* distinct bytes available */
            if (chunk > rem) chunk = rem;
            memcpy(dstBase + out, dstBase + from, chunk);
            out += chunk;
            rem -= chunk;
        }
    }
    *io_out = out;
    *io_litpos = lit_pos;
    return 0;
}

/* returns bytes written at dstBase+dstPos, or -1 */
int64_t zt_decompress_block(void* vctx, const uint8_t* src, int64_t srcSize,
                            uint8_t* dstBase, int64_t dstPos, int64_t dstCap,
                            int64_t windowLow, int64_t blockMax) {
    ZtDCtx* ctx = (ZtDCtx*)vctx;
    const uint8_t* p = src;
    const uint8_t* end = src + srcSize;
    if (srcSize < 2) return -1;

    /* ---- literals section ---- */
    int lbt = p[0] & 3;
    int64_t nlit, lsize;
    const uint8_t* lit;
    int rle_byte = -1;
    if (lbt == 0 || lbt == 1) {            /* raw / rle */
        int sf = (p[0] >> 2) & 3;
        if (sf == 0 || sf == 2) { nlit = p[0] >> 3; p += 1; }
        else if (sf == 1) {
            if (p + 2 > end) return -1;
            nlit = (p[0] >> 4) | ((int64_t)p[1] << 4); p += 2;
        } else {
            if (p + 3 > end) return -1;
            nlit = (p[0] >> 4) | ((int64_t)p[1] << 4) | ((int64_t)p[2] << 12);
            p += 3;
        }
        if (nlit > MAX_BLOCK) return -1;
        if (lbt == 0) {
            if (p + nlit > end) return -1;
            memcpy(ctx->lits, p, nlit);
            p += nlit;
        } else {
            if (p + 1 > end) return -1;
            rle_byte = *p++;
            memset(ctx->lits, rle_byte, nlit);
        }
    } else {                                /* compressed / treeless */
        int sf = (p[0] >> 2) & 3;
        int lh;
        if (sf == 0 || sf == 1) {
            if (p + 3 > end) return -1;
            uint32_t v = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16);
            nlit = (v >> 4) & 0x3FF;
            lsize = (v >> 14) & 0x3FF;
            lh = 3;
        } else if (sf == 2) {
            if (p + 4 > end) return -1;
            uint32_t v = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16)
                         | ((uint32_t)p[3] << 24);
            nlit = (v >> 4) & 0x3FFF;
            lsize = (v >> 18);
            lh = 4;
        } else {
            if (p + 5 > end) return -1;
            uint64_t v = (uint64_t)p[0] | ((uint64_t)p[1] << 8)
                         | ((uint64_t)p[2] << 16) | ((uint64_t)p[3] << 24)
                         | ((uint64_t)p[4] << 32);
            nlit = (v >> 4) & 0x3FFFF;
            lsize = (v >> 22) & 0x3FFFF;
            lh = 5;
        }
        int single = (sf == 0);
        p += lh;
        if (p + lsize > end || nlit > MAX_BLOCK) return -1;
        lit = p;
        const uint8_t* lend = p + lsize;
        if (lbt == 2) {                     /* fresh tree */
            uint8_t weights[256];
            int n_sym;
            int consumed = huf_read_weights(lit, lsize, weights, &n_sym);
            if (consumed < 0) return -1;
            /* n_sym = explicit weights; huf_build_dtable adds the implied
               last symbol itself */
            if (huf_build_dtable(&ctx->huf, weights, n_sym) < 0) return -1;
            lit += consumed;
        } else if (!ctx->huf.valid) {
            return -1;                      /* treeless without prior tree */
        }
        if (single) {
            if (huf_decode_stream(&ctx->huf, lit, lend - lit, ctx->lits,
                                  nlit) < 0) return -1;
        } else {
            if (lend - lit < 6) return -1;
            int64_t s1 = lit[0] | (lit[1] << 8);
            int64_t s2 = lit[2] | (lit[3] << 8);
            int64_t s3 = lit[4] | (lit[5] << 8);
            const uint8_t* q = lit + 6;
            int64_t s4 = (lend - q) - s1 - s2 - s3;
            if (s4 <= 0) return -1;
            int64_t seg = (nlit + 3) / 4;
            int64_t n4 = nlit - 3 * seg;
            if (n4 < 0) return -1;
            {
                const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2,
                                          q + s1 + s2 + s3};
                const int64_t szs[4] = {s1, s2, s3, s4};
                uint8_t* dsts[4] = {ctx->lits, ctx->lits + seg,
                                    ctx->lits + 2 * seg, ctx->lits + 3 * seg};
                const int64_t nos[4] = {seg, seg, seg, n4};
                if (huf_decode_4streams(&ctx->huf, srcs, szs, dsts, nos) < 0)
                    return -1;
            }
        }
        p = lend;
    }

    /* ---- sequences section ---- */
    if (p >= end) return -1;
    int64_t nbseq;
    if (p[0] < 128) { nbseq = *p++; }
    else if (p[0] < 255) {
        if (p + 2 > end) return -1;
        nbseq = (((int64_t)p[0] - 128) << 8) + p[1];
        p += 2;
    } else {
        if (p + 3 > end) return -1;
        nbseq = p[1] + ((int64_t)p[2] << 8) + 0x7F00;
        p += 3;
    }
    if (nbseq == 0) {
        if (p != end) return -1;
        if (dstPos + nlit > dstCap || nlit > blockMax) return -1;
        memcpy(dstBase + dstPos, ctx->lits, nlit);
        return nlit;
    }
    if (p >= end) return -1;
    int scm = *p++;
    if (scm & 3) return -1;                 /* reserved bits */
    int ll_mode = (scm >> 6) & 3, of_mode = (scm >> 4) & 3,
        ml_mode = (scm >> 2) & 3;
    FseDT nll = ctx->ll, nof = ctx->of, nml = ctx->ml;
    if (build_seq_table(&nll, &p, end, ll_mode, LL_DEF, 36, 36, LL_DEFLOG, 9,
                        ctx->seq_valid, LL_BASE, LL_BITS) < 0) return -1;
    if (build_seq_table(&nof, &p, end, of_mode, OF_DEF, 29, 32, OF_DEFLOG, 8,
                        ctx->seq_valid, OF_BASEV, OF_BITSV) < 0) return -1;
    if (build_seq_table(&nml, &p, end, ml_mode, ML_DEF, 53, 53, ML_DEFLOG, 9,
                        ctx->seq_valid, ML_BASE, ML_BITS) < 0) return -1;

    BitRd br;
    if (bitrd_init(&br, p, end - p) < 0) return -1;
    uint32_t sll = bitrd_read(&br, nll.log);
    uint32_t sof = bitrd_read(&br, nof.log);
    uint32_t sml = bitrd_read(&br, nml.log);

    int64_t out = dstPos;
    int64_t lit_pos = 0;
    int64_t produced = 0;
    uint32_t rep0 = ctx->rep[0], rep1 = ctx->rep[1], rep2 = ctx->rep[2];

/* decode ONE sequence's (ll, ml, offset), advancing the FSE / bit /
 * repcode state. Fused tables: state -> (base, extra bits) directly.
 * Fast path: ONE 64-bit load carries this sequence's value bits AND the
 * three next-state bits (typical total <= 45 bits; layout from low bit:
 * of/ml/ll states, then ll/ml/of values) — halves the loads and the
 * bit_pos dependency chain. has_next gates the state refill (the last
 * sequence of a block carries no refill bits). */
#define ZT_DECODE_ONE(llv, mlv, offs, has_next)                               \
    do {                                                                      \
        int ofb = nof.xbits[sof], mlb = nml.xbits[sml],                       \
            llb = nll.xbits[sll];                                             \
        int tot = ofb + mlb + llb;                                            \
        uint64_t offv, mlx, llx;                                              \
        uint32_t ml_, ll_;                                                    \
        int done_ = 0;                                                        \
        if (has_next) {                                                       \
            int nbl = nll.nb[sll], nbm = nml.nb[sml], nbo = nof.nb[sof];      \
            int stot = nbl + nbm + nbo;        /* <= 9+9+8 = 26 bits */       \
            int64_t q_of = br.bit_pos - tot - stot;                           \
            if (q_of < 0) return -1;                                          \
            int64_t byte = q_of >> 3;                                         \
            int sh = (int)(q_of & 7);                                         \
            if (byte + 8 <= br.size && tot + stot + sh <= 64) {               \
                uint64_t w;                                                   \
                memcpy(&w, br.start + byte, 8);                               \
                w >>= sh;                                                     \
                uint32_t nsof = nof.next[sof]                                 \
                                + (uint32_t)(w & ((1u << nbo) - 1));          \
                w >>= nbo;                                                    \
                uint32_t nsml = nml.next[sml]                                 \
                                + (uint32_t)(w & ((1u << nbm) - 1));          \
                w >>= nbm;                                                    \
                uint32_t nsll = nll.next[sll]                                 \
                                + (uint32_t)(w & ((1u << nbl) - 1));          \
                w >>= nbl;                                                    \
                llx = w & ((llb >= 32) ? 0xFFFFFFFFu : ((1u << llb) - 1));    \
                w >>= llb;                                                    \
                mlx = w & ((1u << mlb) - 1);                                  \
                w >>= mlb;                                                    \
                offv = (w & (((uint64_t)1 << ofb) - 1)) + nof.base[sof];      \
                ml_ = nml.base[sml] + (uint32_t)mlx;                          \
                ll_ = nll.base[sll] + (uint32_t)llx;                          \
                sof = nsof; sml = nsml; sll = nsll;                           \
                br.bit_pos = q_of;                                            \
                done_ = 1;                                                    \
            }                                                                 \
        }                                                                     \
        if (!done_) {                                                         \
            int64_t p_ll = br.bit_pos - tot;                                  \
            if (p_ll < 0) return -1;                                          \
            int64_t byte = p_ll >> 3;                                         \
            int sh = (int)(p_ll & 7);                                         \
            if (byte + 8 <= br.size && tot + sh <= 64) {                      \
                uint64_t w;                                                   \
                memcpy(&w, br.start + byte, 8);                               \
                w >>= sh;                                                     \
                llx = w & ((llb >= 32) ? 0xFFFFFFFFu : ((1u << llb) - 1));    \
                w >>= llb;                                                    \
                mlx = w & ((1u << mlb) - 1);                                  \
                w >>= mlb;                                                    \
                offv = w & (((uint64_t)1 << ofb) - 1);                        \
            } else {                                                          \
                offv = bits_at(&br, p_ll + llb + mlb, ofb);                   \
                mlx = bits_at(&br, p_ll + llb, mlb);                          \
                llx = bits_at(&br, p_ll, llb);                                \
            }                                                                 \
            offv += nof.base[sof];                                            \
            ml_ = nml.base[sml] + (uint32_t)mlx;                              \
            ll_ = nll.base[sll] + (uint32_t)llx;                              \
            br.bit_pos = p_ll;                                                \
            if (has_next) {                                                   \
                int nbl = nll.nb[sll];                                        \
                int nbm = nml.nb[sml];                                        \
                int nbo = nof.nb[sof];                                        \
                int64_t q_of = br.bit_pos - (nbl + nbm + nbo);                \
                if (q_of < 0) return -1;                                      \
                sll = nll.next[sll] + bits_at(&br, q_of + nbo + nbm, nbl);    \
                sml = nml.next[sml] + bits_at(&br, q_of + nbo, nbm);          \
                sof = nof.next[sof] + bits_at(&br, q_of, nbo);                \
                br.bit_pos = q_of;                                            \
            }                                                                 \
        }                                                                     \
        /* repcode resolution (spec Repeat offsets; ofc==0 => offv==1).
         * Two branches: new-offset vs repeat, then rep0 vs the rest; the
         * rest resolves with selects so mixed rep1/rep2/rep0-1 traffic
         * doesn't mispredict a 3-deep chain. */                              \
        uint32_t off_;                                                        \
        if (offv > 3) {                                                       \
            off_ = (uint32_t)(offv - 3);                                      \
            rep2 = rep1; rep1 = rep0; rep0 = off_;                            \
        } else {                                                              \
            uint32_t idx = (uint32_t)offv + (ll_ == 0 ? 1 : 0);               \
            if (idx == 1) off_ = rep0;                                        \
            else {                                                            \
                off_ = idx == 2 ? rep1 : (idx == 3 ? rep2 : rep0 - 1);        \
                if (off_ == 0) return -1;                                     \
                rep2 = idx == 2 ? rep2 : rep1;                                \
                rep1 = rep0;                                                  \
                rep0 = off_;                                                  \
            }                                                                 \
        }                                                                     \
        if (off_ == 0) return -1;                                             \
        (llv) = ll_; (mlv) = ml_; (offs) = off_;                              \
    } while (0)

    /* decode-ahead software pipeline: sequence i+ZT_ADV's fields decode
     * (and its match source prefetches) while sequence i executes, so
     * cache misses on far match sources overlap the FSE chain instead of
     * serializing with it (role of ZSTD_decompressSequencesLong's
     * STORED_SEQS ring, zstd_decompress_block.c:1715). Only worth the
     * ring overhead when the OF table says offsets reach past L2: share
     * of decode states with >= 23 extra offset bits (the reference's
     * ZSTD_getLongOffsetsShare gate). */
    int long_offsets = 0;
    {
        int of_size = 1 << nof.log;
        int big = 0;
        for (int c = 0; c < of_size; c++)
            big += (nof.xbits[c] >= 23);
        long_offsets = (big * 8 >= of_size);     /* >= 12.5% share */
    }
    enum { ZT_ADV = 4 };
    if (long_offsets && nbseq > ZT_ADV) {
        uint32_t rll[ZT_ADV], rml[ZT_ADV], rof[ZT_ADV];
        int64_t vout = out;              /* virtual out pos for prefetch */
        for (int64_t j = 0; j < ZT_ADV; j++) {
            uint32_t ll, ml, off;
            ZT_DECODE_ONE(ll, ml, off, 1);
            rll[j] = ll; rml[j] = ml; rof[j] = off;
            vout += (int64_t)ll + ml;
            __builtin_prefetch(dstBase + vout - ml - off, 0, 2);
        }
        for (int64_t i = 0; i < nbseq; i++) {
            int k = (int)(i & (ZT_ADV - 1));
            uint32_t ll = rll[k], ml = rml[k], offset = rof[k];
            int64_t j = i + ZT_ADV;
            if (j < nbseq) {
                uint32_t ll2, ml2, off2;
                if (j + 1 < nbseq) { ZT_DECODE_ONE(ll2, ml2, off2, 1); }
                else               { ZT_DECODE_ONE(ll2, ml2, off2, 0); }
                rll[k] = ll2; rml[k] = ml2; rof[k] = off2;
                vout += (int64_t)ll2 + ml2;
                __builtin_prefetch(dstBase + vout - ml2 - off2, 0, 2);
            }
            if (exec_seq(dstBase, &out, ctx->lits, &lit_pos, nlit, ll, ml,
                         offset, dstCap, windowLow) < 0) return -1;
            produced += (int64_t)ll + ml;
            if (produced > blockMax) return -1;
        }
    } else {
        for (int64_t i = 0; i < nbseq; i++) {
            uint32_t ll, ml, offset;
            if (i + 1 < nbseq) { ZT_DECODE_ONE(ll, ml, offset, 1); }
            else               { ZT_DECODE_ONE(ll, ml, offset, 0); }
            if (exec_seq(dstBase, &out, ctx->lits, &lit_pos, nlit, ll, ml,
                         offset, dstCap, windowLow) < 0) return -1;
            produced += (int64_t)ll + ml;
            if (produced > blockMax) return -1;
        }
    }
#undef ZT_DECODE_ONE
    /* trailing literals */
    {
        int64_t rest = nlit - lit_pos;
        if (rest < 0 || out + rest > dstCap) return -1;
        memcpy(dstBase + out, ctx->lits + lit_pos, rest);
        out += rest;
        produced += rest;
        if (produced > blockMax) return -1;
    }
    if (!bitrd_done(&br)) return -1;

    ctx->ll = nll; ctx->of = nof; ctx->ml = nml;
    ctx->seq_valid = 1;
    ctx->rep[0] = rep0; ctx->rep[1] = rep1; ctx->rep[2] = rep2;
    return out - dstPos;
}

/* walk all blocks of one frame in C (headers + dispatch; role of
 * ZSTD_decompressFrame's block loop, zstd_decompress.c:951). Python parses
 * the frame header and allocates the output buffer; this runs the rest.
 * Returns total bytes produced, sets *consumed to src bytes eaten, or -1
 * (caller falls back to the per-block / Python path). */
int64_t zt_decompress_blocks(void* vctx, const uint8_t* src, int64_t srcSize,
                             uint8_t* dstBase, int64_t dstPos, int64_t dstCap,
                             int64_t windowSize, int64_t blockMax,
                             int64_t* consumed) {
    const uint8_t* p = src;
    const uint8_t* end = src + srcSize;
    int64_t out = dstPos;
    int last = 0;
    while (!last) {
        if (p + 3 > end) return -1;
        uint32_t bh = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
                      | ((uint32_t)p[2] << 16);
        p += 3;
        last = bh & 1;
        int btype = (bh >> 1) & 3;
        int64_t bsize = bh >> 3;
        if (btype == 0) {                  /* raw */
            if (bsize > blockMax || p + bsize > end
                || out + bsize > dstCap) return -1;
            memcpy(dstBase + out, p, bsize);
            out += bsize;
            p += bsize;
        } else if (btype == 1) {           /* rle */
            if (bsize > blockMax || p + 1 > end
                || out + bsize > dstCap) return -1;
            memset(dstBase + out, *p, bsize);
            out += bsize;
            p += 1;
        } else if (btype == 2) {           /* compressed */
            if (bsize > blockMax || p + bsize > end) return -1;
            int64_t wlow = out - windowSize;
            if (wlow < 0) wlow = 0;
            int64_t r = zt_decompress_block(vctx, p, bsize, dstBase, out,
                                            dstCap, wlow, blockMax);
            if (r < 0) return -1;
            out += r;
            p += bsize;
        } else {
            return -1;                     /* reserved */
        }
    }
    *consumed = p - src;
    return out - dstPos;
}

/* decode a block's sequences section WITHOUT executing it: emits per-
 * sequence (litLen, matchLen, absolute offset) with repcodes resolved,
 * carrying FSE/repcode state across blocks in the ctx. Feeds the device
 * executor through zt_parse_frame so the host side of the device decode
 * path stays native-speed (role of the seqStore half of
 * zstd_decompress_block.c ZSTD_decompressSequences split out).
 * src points at the sequences section. Returns nbseq (>=0), -1 on a corrupt
 * section, or SEQ_NO_ROOM where nbseq > cap (ctx untouched, nothing
 * written). */
#define SEQ_NO_ROOM (-2)
#define MAX_NBSEQ (0x7F00 + 0xFFFF)   /* the spec's largest nbSeq */

static int64_t seq_section(ZtDCtx* ctx, const uint8_t* src, int64_t srcSize,
                           int64_t* out_ll, int64_t* out_ml,
                           int64_t* out_off, int64_t cap) {
    const uint8_t* p = src;
    const uint8_t* end = src + srcSize;
    if (p >= end) return -1;
    int64_t nbseq;
    if (p[0] < 128) { nbseq = *p++; }
    else if (p[0] < 255) {
        if (p + 2 > end) return -1;
        nbseq = (((int64_t)p[0] - 128) << 8) + p[1];
        p += 2;
    } else {
        if (p + 3 > end) return -1;
        nbseq = p[1] + ((int64_t)p[2] << 8) + 0x7F00;
        p += 3;
    }
    if (nbseq == 0) return (p == end) ? 0 : -1;
    if (nbseq > cap) return SEQ_NO_ROOM;
    if (p >= end) return -1;
    int scm = *p++;
    if (scm & 3) return -1;
    int ll_mode = (scm >> 6) & 3, of_mode = (scm >> 4) & 3,
        ml_mode = (scm >> 2) & 3;
    FseDT nll = ctx->ll, nof = ctx->of, nml = ctx->ml;
    if (build_seq_table(&nll, &p, end, ll_mode, LL_DEF, 36, 36, LL_DEFLOG, 9,
                        ctx->seq_valid, LL_BASE, LL_BITS) < 0) return -1;
    if (build_seq_table(&nof, &p, end, of_mode, OF_DEF, 29, 32, OF_DEFLOG, 8,
                        ctx->seq_valid, OF_BASEV, OF_BITSV) < 0) return -1;
    if (build_seq_table(&nml, &p, end, ml_mode, ML_DEF, 53, 53, ML_DEFLOG, 9,
                        ctx->seq_valid, ML_BASE, ML_BITS) < 0) return -1;

    BitRd br;
    if (bitrd_init(&br, p, end - p) < 0) return -1;
    uint32_t sll = bitrd_read(&br, nll.log);
    uint32_t sof = bitrd_read(&br, nof.log);
    uint32_t sml = bitrd_read(&br, nml.log);
    uint32_t rep0 = ctx->rep[0], rep1 = ctx->rep[1], rep2 = ctx->rep[2];

    for (int64_t i = 0; i < nbseq; i++) {
        int ofb = nof.xbits[sof], mlb = nml.xbits[sml], llb = nll.xbits[sll];
        int64_t p_of = br.bit_pos - ofb;
        int64_t p_ml = p_of - mlb;
        int64_t p_ll = p_ml - llb;
        if (p_ll < 0) return -1;
        uint64_t offv = nof.base[sof] + bits_at(&br, p_of, ofb);
        uint32_t ml = nml.base[sml] + bits_at(&br, p_ml, mlb);
        uint32_t ll = nll.base[sll] + bits_at(&br, p_ll, llb);
        br.bit_pos = p_ll;

        uint32_t offset;
        if (offv > 3) {
            offset = (uint32_t)(offv - 3);
            rep2 = rep1; rep1 = rep0; rep0 = offset;
        } else {
            uint32_t idx = (uint32_t)offv + (ll == 0 ? 1 : 0);
            if (idx == 1) offset = rep0;
            else if (idx == 2) { offset = rep1; rep1 = rep0; rep0 = offset; }
            else if (idx == 3) { offset = rep2; rep2 = rep1; rep1 = rep0;
                                 rep0 = offset; }
            else { offset = rep0 - 1; if (offset == 0) return -1;
                   rep2 = rep1; rep1 = rep0; rep0 = offset; }
        }
        if (offset == 0) return -1;

        if (i + 1 < nbseq) {
            int nbl = nll.nb[sll], nbm = nml.nb[sml], nbo = nof.nb[sof];
            int64_t q_ll = br.bit_pos - nbl;
            int64_t q_ml = q_ll - nbm;
            int64_t q_of = q_ml - nbo;
            if (q_of < 0) return -1;
            sll = nll.next[sll] + bits_at(&br, q_ll, nbl);
            sml = nml.next[sml] + bits_at(&br, q_ml, nbm);
            sof = nof.next[sof] + bits_at(&br, q_of, nbo);
            br.bit_pos = q_of;
        }
        out_ll[i] = ll;
        out_ml[i] = ml;
        out_off[i] = offset;
    }
    if (!bitrd_done(&br)) return -1;
    ctx->ll = nll; ctx->of = nof; ctx->ml = nml;
    ctx->seq_valid = 1;
    ctx->rep[0] = rep0; ctx->rep[1] = rep1; ctx->rep[2] = rep2;
    return nbseq;
}

/* ---- the device decode's host parse ----
 * One frame's blocks walked in one call, as device_decoder._parse_blocks
 * (the plain version) walks them, without decoding a literal stream: what
 * the device decode takes, in caller-allocated arrays.
 *
 *   lanes  int64[laneCap][4]: a Huffman stream's start and end in src, its
 *          symbol count, its table (a treeless section takes the previous
 *          tree's)
 *   lutSym, lutLen  uint8[tableCap][1 << LUT_LOG]: each tree's decode table
 *          spread over the device's fixed window
 *   segs   int64[segCap][4]: a literal-pool segment's start in the pool, its
 *          lane, its start in the host pool, whether the device decodes it
 *   pool   uint8[poolCap]: the host pool (raw and RLE blocks and literals)
 *   ll, ml, off  int64[seqCap]: the frame-global sequences, with a zero-match
 *          pseudo-sequence (offset 1) for each raw or RLE block and for each
 *          block's trailing literals
 *   totals int64[PT_COUNT]: the counts and sizes below
 *
 * src starts at the frame's first block header. Returns 0, or a PF_ code: a
 * refusal at the point of the walk where the plain version raises, or
 * PF_ROOM where some array was short (totals then hold what each needs;
 * the walk ran to its end, so a call with that much room succeeds). */
#define LUT_LOG 11        /* ops/decode_dev.MAX_TLOG */

enum {
    PF_BLOCK_HEADER = -1, PF_RAW_BLOCK = -2, PF_RLE_BLOCK = -3,
    PF_EMPTY_PAYLOAD = -4, PF_LIT_HEADER = -5, PF_RAW_LITERALS = -6,
    PF_RLE_LITERAL = -7, PF_HUF_HEADER = -8, PF_HUF_SECTION = -9,
    PF_TREE = -10, PF_TREELESS = -11, PF_JUMP_MISSING = -12,
    PF_JUMP_BAD = -13, PF_STREAM_SIZE = -14, PF_SENTINEL = -15,
    PF_STREAM_CAP = -16, PF_SEQUENCES = -17, PF_OVERRUN = -18,
    PF_RESERVED = -19, PF_OFFSET = -20, PF_ROOM = -21, PF_NO_MEMORY = -22,
};
enum { PT_N, PT_POOL_LEN, PT_END, PT_LANES, PT_TABLES, PT_SEGS, PT_SEQS,
       PT_HOST_LEN, PT_COUNT };

typedef struct {
    int64_t *lanes, *segs, *ll, *ml, *off;
    uint8_t *lut_sym, *lut_len, *pool;
    int64_t lane_cap, table_cap, seg_cap, pool_cap, seq_cap;
    int64_t n_lanes, n_tables, n_segs, n_seqs, host_len, pool_len;
    int64_t pos;          /* content so far: the sum of ll + ml */
    int64_t window;
    int bad_offset;       /* refused after the walk, as the plain version */
    int64_t* scratch;     /* a block's sequences where seqCap is short */
} PfOut;

static void pf_seg(PfOut* o, int64_t lane, int64_t host, int is_dev) {
    if (o->n_segs < o->seg_cap) {
        int64_t* s = o->segs + 4 * o->n_segs;
        s[0] = o->pool_len; s[1] = lane; s[2] = host; s[3] = is_dev;
    }
    o->n_segs++;
}

/* n literal bytes for the host pool: copied from src, or rle repeated */
static void pf_host(PfOut* o, const uint8_t* src, int rle, int64_t n) {
    if (n == 0) return;
    pf_seg(o, 0, o->host_len, 0);
    if (o->host_len + n <= o->pool_cap) {
        if (src) memcpy(o->pool + o->host_len, src, n);
        else memset(o->pool + o->host_len, rle, n);
    }
    o->host_len += n;
    o->pool_len += n;
}

/* a literal-only span: a pseudo-sequence of n literals and no match */
static void pf_literals(PfOut* o, int64_t n) {
    if (n == 0) return;
    if (o->n_seqs < o->seq_cap) {
        o->ll[o->n_seqs] = n; o->ml[o->n_seqs] = 0; o->off[o->n_seqs] = 1;
    }
    o->n_seqs++;
    o->pos += n;
}

/* the sequences section of a block with lit_count literals */
static int64_t pf_sequences(PfOut* o, ZtDCtx* ctx, const uint8_t* src,
                            int64_t size, int64_t lit_count) {
    int64_t room = o->seq_cap - o->n_seqs;
    int64_t *ll = o->ll, *ml = o->ml, *off = o->off;
    if (room > 0) { ll += o->n_seqs; ml += o->n_seqs; off += o->n_seqs; }
    else room = 0;
    int64_t nb = seq_section(ctx, src, size, ll, ml, off, room);
    if (nb == SEQ_NO_ROOM) {
        if (!o->scratch) {
            o->scratch = malloc(3 * (size_t)MAX_NBSEQ * sizeof(int64_t));
            if (!o->scratch) return PF_NO_MEMORY;
        }
        ll = o->scratch; ml = ll + MAX_NBSEQ; off = ml + MAX_NBSEQ;
        nb = seq_section(ctx, src, size, ll, ml, off, MAX_NBSEQ);
    }
    if (nb < 0) return PF_SEQUENCES;
    int64_t lits = 0, pos = o->pos;
    for (int64_t i = 0; i < nb; i++) {
        lits += ll[i];
        int64_t match_start = pos + ll[i];
        if (ml[i] > 0 && (off[i] > match_start || off[i] > o->window))
            o->bad_offset = 1;
        pos = match_start + ml[i];
    }
    /* the executor takes literal lengths within the block's literals */
    if (lits > lit_count) return PF_OVERRUN;
    o->n_seqs += nb;
    o->pos = pos;
    pf_literals(o, lit_count - lits);
    return 0;
}

/* the decode table spread over the device window: entry i of a 2^tlog
 * table covers [i << shift, (i + 1) << shift) */
static void pf_table(PfOut* o, const HufDT* t) {
    int64_t k = o->n_tables++;
    if (k >= o->table_cap) return;
    uint8_t* sym = o->lut_sym + (k << LUT_LOG);
    uint8_t* len = o->lut_len + (k << LUT_LOG);
    int shift = LUT_LOG - t->log;
    for (int i = 0; i < (1 << LUT_LOG); i++) {
        sym[i] = t->sym[i >> shift];
        len[i] = t->nb[i >> shift];
    }
}

/* a compressed block's literals section and sequences: q holds plen bytes
 * of the block (fewer than its size where src ends first) */
static int64_t pf_block(PfOut* o, ZtDCtx* ctx, const uint8_t* src,
                        int64_t q, int64_t plen, int64_t stream_cap,
                        int64_t* table) {
    if (plen == 0) return PF_EMPTY_PAYLOAD;
    const uint8_t* b = src + q;
    int lbt = b[0] & 3, sf = (b[0] >> 2) & 3;
    int64_t regen, used;
    if (lbt == 0 || lbt == 1) {            /* raw / RLE literals */
        int lh;
        if (sf == 0 || sf == 2) { regen = b[0] >> 3; lh = 1; }
        else if (sf == 1) {
            if (plen < 2) return PF_LIT_HEADER;
            regen = (b[0] >> 4) + ((int64_t)b[1] << 4); lh = 2;
        } else {
            if (plen < 3) return PF_LIT_HEADER;
            regen = (b[0] >> 4) + ((int64_t)b[1] << 4)
                    + ((int64_t)b[2] << 12);
            lh = 3;
        }
        if (lbt == 0) {
            if (plen < lh + regen) return PF_RAW_LITERALS;
            pf_host(o, b + lh, 0, regen);
            used = lh + regen;
        } else {
            if (plen < lh + 1) return PF_RLE_LITERAL;
            pf_host(o, NULL, b[lh], regen);
            used = lh + 1;
        }
    } else {                                /* compressed / treeless */
        int lh = sf <= 1 ? 3 : sf + 2;
        if (sf <= 1 && plen < 3) return PF_HUF_HEADER;
        uint64_t v = 0;                     /* zero past the block's end */
        for (int k = 0; k < lh && k < plen; k++)
            v |= (uint64_t)b[k] << (8 * k);
        int64_t csize;
        if (sf <= 1) {
            regen = (v >> 4) & 0x3FF; csize = (v >> 14) & 0x3FF;
        } else if (sf == 2) {
            regen = (v >> 4) & 0x3FFF; csize = (v >> 18) & 0x3FFF;
        } else {
            regen = (v >> 4) & 0x3FFFF; csize = (v >> 22) & 0x3FFFF;
        }
        if ((plen > lh ? plen - lh : 0) < csize) return PF_HUF_SECTION;
        int64_t body = q + lh, body_len = csize;
        if (lbt == 2) {                     /* fresh tree */
            uint8_t weights[256];
            int n_sym;
            int consumed = huf_read_weights(src + body, body_len, weights,
                                            &n_sym);
            if (consumed < 0 || huf_build_dtable(&ctx->huf, weights,
                                                 n_sym) < 0)
                return PF_TREE;
            *table = o->n_tables;
            pf_table(o, &ctx->huf);
            body += consumed;
            body_len -= consumed;
        } else if (*table < 0) {
            return PF_TREELESS;
        }
        int64_t start[4], size[4], nsym[4];
        int ns;
        if (sf == 0) {                      /* one stream */
            ns = 1;
            start[0] = body; size[0] = body_len; nsym[0] = regen;
        } else {                            /* four, after a jump table */
            if (body_len < 6) return PF_JUMP_MISSING;
            const uint8_t* j = src + body;
            size[0] = j[0] | (j[1] << 8);
            size[1] = j[2] | (j[3] << 8);
            size[2] = j[4] | (j[5] << 8);
            size[3] = body_len - 6 - size[0] - size[1] - size[2];
            if (size[3] <= 0) return PF_JUMP_BAD;
            int64_t seg = (regen + 3) / 4, rem = regen, at = body + 6;
            ns = 4;
            for (int t = 0; t < 4; t++) {
                nsym[t] = (t < 3 && seg < rem) ? seg : rem;
                rem -= nsym[t];
                start[t] = at;
                at += size[t];
            }
        }
        for (int t = 0; t < ns; t++) {
            if (size[t] == 0) return PF_STREAM_SIZE;
            if (src[start[t] + size[t] - 1] == 0) return PF_SENTINEL;
            if (size[t] > stream_cap || nsym[t] > stream_cap)
                return PF_STREAM_CAP;
            if (nsym[t]) {
                pf_seg(o, o->n_lanes, 0, 1);
                o->pool_len += nsym[t];
            }
            if (o->n_lanes < o->lane_cap) {
                int64_t* l = o->lanes + 4 * o->n_lanes;
                l[0] = start[t]; l[1] = start[t] + size[t];
                l[2] = nsym[t]; l[3] = *table;
            }
            o->n_lanes++;
        }
        used = lh + csize;
    }
    return pf_sequences(o, ctx, b + used, plen - used, regen);
}

static int64_t pf_walk(PfOut* o, ZtDCtx* ctx, const uint8_t* src,
                       int64_t srcSize, int64_t stream_cap, int64_t* end) {
    int64_t p = 0, table = -1;
    int last = 0;
    while (!last) {
        if (p + 3 > srcSize) return PF_BLOCK_HEADER;
        uint32_t bh = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8)
                      | ((uint32_t)src[p + 2] << 16);
        p += 3;
        last = bh & 1;
        int btype = (bh >> 1) & 3;
        int64_t bsize = bh >> 3;
        if (btype == 0) {                  /* raw */
            if (p + bsize > srcSize) return PF_RAW_BLOCK;
            pf_host(o, src + p, 0, bsize);
            pf_literals(o, bsize);
            p += bsize;
        } else if (btype == 1) {           /* RLE */
            if (p >= srcSize) return PF_RLE_BLOCK;
            pf_host(o, NULL, src[p], bsize);
            pf_literals(o, bsize);
            p += 1;
        } else if (btype == 2) {           /* compressed */
            int64_t plen = p + bsize <= srcSize ? bsize : srcSize - p;
            int64_t r = pf_block(o, ctx, src, p, plen, stream_cap, &table);
            if (r < 0) return r;
            p += bsize;
        } else {
            return PF_RESERVED;
        }
    }
    *end = p;
    return o->bad_offset ? PF_OFFSET : 0;
}

int64_t zt_parse_frame(const uint8_t* src, int64_t srcSize, int64_t window,
                       int64_t streamCap,
                       int64_t* lanes, int64_t laneCap,
                       uint8_t* lutSym, uint8_t* lutLen, int64_t tableCap,
                       int64_t* segs, int64_t segCap,
                       uint8_t* pool, int64_t poolCap,
                       int64_t* ll, int64_t* ml, int64_t* off, int64_t seqCap,
                       int64_t* totals) {
    PfOut o = {lanes, segs, ll, ml, off, lutSym, lutLen, pool,
               laneCap, tableCap, segCap, poolCap, seqCap,
               0, 0, 0, 0, 0, 0, 0, window, 0, NULL};
    ZtDCtx* ctx = zt_dctx_new();
    if (!ctx) return PF_NO_MEMORY;
    int64_t end = 0;
    int64_t r = pf_walk(&o, ctx, src, srcSize, streamCap, &end);
    free(o.scratch);
    zt_dctx_free(ctx);
    if (r < 0) return r;
    totals[PT_N] = o.pos;
    totals[PT_POOL_LEN] = o.pool_len;
    totals[PT_END] = end;
    totals[PT_LANES] = o.n_lanes;
    totals[PT_TABLES] = o.n_tables;
    totals[PT_SEGS] = o.n_segs;
    totals[PT_SEQS] = o.n_seqs;
    totals[PT_HOST_LEN] = o.host_len;
    if (o.n_lanes > laneCap || o.n_tables > tableCap || o.n_segs > segCap
        || o.host_len > poolCap || o.n_seqs > seqCap)
        return PF_ROOM;
    return 0;
}
