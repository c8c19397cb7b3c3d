/* Host-side encode hot loops.
 *
 * zt_encode_sequences: the interleaved 3-state FSE sequence bitstream
 * (role of ZSTD_encodeSequences_body,
 * zstd's lib/compress/zstd_compress_sequences.c:291 — the exact
 * schedule: init ML,OF,LL states from the last sequence, then per
 * remaining sequence encode OF,ML,LL symbols and add LL,ML,OF extra
 * bits). Table building, normalization and mode selection stay in
 * Python (format/fse.py); this is only the per-sequence bit loop, which
 * dominates host encode time at every level.
 *
 * Copy of native/encode.c.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stddef.h>

#include <string.h>

typedef struct {
    uint64_t acc;
    int nbits;          /* bits resident in acc; kept < 40 */
    uint8_t* p;
    uint8_t* end;
    int ovf;            /* output buffer exhausted (caller reports -1) */
} BW;

static inline void bw_flush(BW* b) {
    int bytes = b->nbits >> 3;
    if (b->p + 8 <= b->end) {
        /* one unaligned 8-byte store instead of a per-byte loop; the
           store is little-endian-exact for this forward LE layout and
           any over-written scratch is re-covered by the next flush */
        memcpy(b->p, &b->acc, 8);
        b->p += bytes;
        b->acc >>= (bytes << 3);
        b->nbits -= bytes << 3;
        return;
    }
    while (b->nbits >= 8) {
        if (b->p >= b->end) { b->ovf = 1; return; }
        *b->p++ = (uint8_t)b->acc;
        b->acc >>= 8;
        b->nbits -= 8;
    }
}

static inline void bw_add(BW* b, uint64_t v, int nb) {
    if (b->nbits > 56) { b->ovf = 1; return; }  /* flush failed earlier */
    b->acc |= (v & (((uint64_t)1 << nb) - 1)) << b->nbits;
    b->nbits += nb;
    if (b->nbits >= 32) bw_flush(b);
}

static inline int64_t bw_close(BW* b, const uint8_t* out0) {
    if (b->ovf) return -1;
    b->acc |= (uint64_t)1 << b->nbits;      /* sentinel bit */
    b->nbits += 1;
    while (b->nbits > 0) {
        if (b->p >= b->end) return -1;
        *b->p++ = (uint8_t)b->acc;
        b->acc >>= 8;
        b->nbits -= 8;
    }
    return (int64_t)(b->p - out0);
}

typedef struct {
    int64_t value;
    int tlog;
    const int32_t* st;
    const int64_t* dnb;
    const int64_t* dfs;
} CSt;

static inline void cs_init(CSt* c, int sym) {
    int64_t d = c->dnb[sym];
    int nb = (int)((d + (1 << 15)) >> 16);
    int64_t v = ((int64_t)nb << 16) - d;
    c->value = c->st[(v >> nb) + c->dfs[sym]];
}

static inline void cs_encode(CSt* c, BW* b, int sym) {
    int nb = (int)((c->value + c->dnb[sym]) >> 16);
    bw_add(b, (uint64_t)c->value, nb);
    c->value = c->st[(c->value >> nb) + c->dfs[sym]];
}

int64_t zt_encode_sequences(
    int64_t n,
    const int32_t* ll, const int32_t* ob, const int32_t* mb,
    const int32_t* llc, const int32_t* ofc, const int32_t* mlc,
    const int32_t* ll_bits, const int32_t* ml_bits,
    int ll_tlog, const int32_t* ll_st, const int64_t* ll_dnb,
    const int64_t* ll_dfs,
    int of_tlog, const int32_t* of_st, const int64_t* of_dnb,
    const int64_t* of_dfs,
    int ml_tlog, const int32_t* ml_st, const int64_t* ml_dnb,
    const int64_t* ml_dfs,
    uint8_t* out, int64_t out_cap)
{
    if (n <= 0) return -1;
    BW b = {0, 0, out, out + out_cap, 0};
    CSt sll = {0, ll_tlog, ll_st, ll_dnb, ll_dfs};
    CSt sof = {0, of_tlog, of_st, of_dnb, of_dfs};
    CSt sml = {0, ml_tlog, ml_st, ml_dnb, ml_dfs};
    int64_t last = n - 1;
    cs_init(&sml, mlc[last]);
    cs_init(&sof, ofc[last]);
    cs_init(&sll, llc[last]);
    bw_add(&b, (uint64_t)(uint32_t)ll[last], ll_bits[llc[last]]);
    bw_add(&b, (uint64_t)(uint32_t)mb[last], ml_bits[mlc[last]]);
    bw_add(&b, (uint64_t)(uint32_t)ob[last], ofc[last]);
    for (int64_t i = n - 2; i >= 0; i--) {
        cs_encode(&sof, &b, ofc[i]);
        cs_encode(&sml, &b, mlc[i]);
        cs_encode(&sll, &b, llc[i]);
        bw_add(&b, (uint64_t)(uint32_t)ll[i], ll_bits[llc[i]]);
        bw_add(&b, (uint64_t)(uint32_t)mb[i], ml_bits[mlc[i]]);
        bw_add(&b, (uint64_t)(uint32_t)ob[i], ofc[i]);
        if (b.p >= b.end) return -1;
    }
    bw_add(&b, (uint64_t)sml.value, sml.tlog);
    bw_add(&b, (uint64_t)sof.value, sof.tlog);
    bw_add(&b, (uint64_t)sll.value, sll.tlog);
    return bw_close(&b, out);
}

/* Huffman literal bitstream (HUF_compress1X_usingCTable role): symbols
 * encoded last-to-first through the same backward bit writer. nb/val are
 * the canonical code table (nbBits, value) per symbol. */
int64_t zt_huf_encode(const uint8_t* data, int64_t n,
                      const int32_t* nb, const int32_t* val,
                      uint8_t* out, int64_t out_cap)
{
    BW b = {0, 0, out, out + out_cap, 0};
    int64_t i = n - 1;
    /* head: bring the remaining count to a multiple of 4 */
    while (i >= 0 && (i & 3) != 3) {
        int s = data[i--];
        bw_add(&b, (uint64_t)(uint32_t)val[s], nb[s]);
    }
    /* 4 symbols per flush: canonical codes are <=12 bits, so 4 codes +
       a <8-bit residue fit the 64-bit accumulator (HUF 4-at-a-time
       unroll role, huf_compress.c:1074). The head peel can leave up to
       31 resident bits (bw_add only flushes at >=32) — flush once so
       the <8-bit invariant holds for the first packed group too. */
    if (b.nbits >= 8) bw_flush(&b);
    for (; i >= 3; i -= 4) {
        if (b.ovf) return -1;
        int s0 = data[i], s1 = data[i - 1], s2 = data[i - 2],
            s3 = data[i - 3];
        uint64_t a = b.acc;
        int k = b.nbits;
        a |= (uint64_t)(uint32_t)val[s0] << k; k += nb[s0];
        a |= (uint64_t)(uint32_t)val[s1] << k; k += nb[s1];
        a |= (uint64_t)(uint32_t)val[s2] << k; k += nb[s2];
        a |= (uint64_t)(uint32_t)val[s3] << k; k += nb[s3];
        b.acc = a;
        b.nbits = k;
        bw_flush(&b);
    }
    if (b.ovf) return -1;
    return bw_close(&b, out);
}

/* FSE compression-table construction (FSE_buildCTable role). Replicates
 * the Python build exactly (format/fse.py build_ctable + _spread_symbols:
 * low-prob symbols at the highest states, 5/8*size+3 spread step) so the
 * resulting bitstream is byte-identical whichever side builds the table.
 * Returns 0, or -1 when the spread does not close (invalid norm). */
int64_t zt_fse_build_ctable(const int32_t* norm, int max_symbol,
                            int table_log,
                            int32_t* state_table,   /* [1<<table_log] */
                            int64_t* delta_nb,      /* [max_symbol+1] */
                            int64_t* delta_fs)      /* [max_symbol+1] */
{
    int table_size = 1 << table_log;
    int table_mask = table_size - 1;
    int step = (table_size >> 1) + (table_size >> 3) + 3;
    int32_t spread[1 << 12];
    if (table_log > 12) return -1;
    int high_threshold = table_size - 1;
    for (int s = 0; s <= max_symbol; s++)
        if (norm[s] == -1) spread[high_threshold--] = s;
    {
        int position = 0;
        for (int s = 0; s <= max_symbol; s++) {
            for (int c = 0; c < norm[s]; c++) {
                spread[position] = s;
                position = (position + step) & table_mask;
                while (position > high_threshold)
                    position = (position + step) & table_mask;
            }
        }
        if (position != 0) return -1;
    }
    {
        int64_t cumul[260];
        cumul[0] = 0;
        for (int u = 1; u <= max_symbol + 1; u++) {
            int prev = norm[u - 1];
            cumul[u] = cumul[u - 1] + (prev == -1 ? 1 : prev);
        }
        cumul[max_symbol + 1] = table_size + 1;
        for (int u = 0; u < table_size; u++) {
            int s = spread[u];
            state_table[cumul[s]++] = (int32_t)(table_size + u);
        }
    }
    {
        int64_t total = 0;
        for (int s = 0; s <= max_symbol; s++) {
            int p = norm[s];
            if (p == 0) {
                delta_nb[s] = ((int64_t)(table_log + 1) << 16) - table_size;
                delta_fs[s] = 0;
            } else if (p == -1 || p == 1) {
                delta_nb[s] = ((int64_t)table_log << 16) - table_size;
                delta_fs[s] = total - 1;
                total += 1;
            } else {
                int hb = 31 - __builtin_clz((uint32_t)(p - 1));
                int max_bits_out = table_log - hb;
                int64_t min_state_plus = (int64_t)p << max_bits_out;
                delta_nb[s] = ((int64_t)max_bits_out << 16) - min_state_plus;
                delta_fs[s] = total - p;
                total += p;
            }
        }
    }
    return 0;
}

/* 2-state alternating FSE byte stream (FSE_compress_usingCTable role;
 * format/fse.py fse_compress_2state mirror — used for Huffman weight
 * compression). Returns stream length, 0 for "not compressible here"
 * (n <= 2), -1 on buffer overflow. */
int64_t zt_fse_compress_2state(const uint8_t* data, int64_t n,
                               int table_log, const int32_t* st,
                               const int64_t* dnb, const int64_t* dfs,
                               uint8_t* out, int64_t out_cap)
{
    if (n <= 2) return 0;
    BW b = {0, 0, out, out + out_cap, 0};
    CSt c1 = {0, table_log, st, dnb, dfs};
    CSt c2 = {0, table_log, st, dnb, dfs};
    int64_t ip = n;
    if (n & 1) {
        cs_init(&c1, data[--ip]);
        cs_init(&c2, data[--ip]);
        cs_encode(&c1, &b, data[--ip]);
    } else {
        cs_init(&c2, data[--ip]);
        cs_init(&c1, data[--ip]);
    }
    while (ip > 0) {
        cs_encode(&c2, &b, data[--ip]);
        cs_encode(&c1, &b, data[--ip]);
    }
    bw_add(&b, (uint64_t)c2.value, table_log);
    bw_add(&b, (uint64_t)c1.value, table_log);
    return bw_close(&b, out);
}

/* Entropy-divergence pre-split inside one block (format/frame.py
 * _split_points mirror in exact integer arithmetic: the float condition
 * sum|seg/segn/chunk - cur/chunk|/2 > 0.35 is evaluated as
 * 10*sum|seg - segn*cur| > 7*segn*chunk). Returns number of interior
 * split offsets written to out (absolute positions). */
int64_t zt_split_points(const uint8_t* base, int64_t bs, int64_t be,
                        int64_t chunk, int64_t min_seg,
                        int64_t* out, int64_t out_cap)
{
    int64_t n = be - bs;
    if (n < 2 * min_seg) return 0;
    int64_t nch = n / chunk;
    if (nch < 2) return 0;
    int64_t seg[64], cur[64];
    int64_t segn = 0, k = 0;
    for (int i = 0; i < 64; i++) seg[i] = 0;
    for (int64_t c = 0; c < nch; c++) {
        const uint8_t* p = base + bs + c * chunk;
        /* exact counts (sampling changed split decisions for +0.7%
         * size); four sub-histograms break the increment dependency
         * chain so the scan runs ~4 bytes/cycle instead of 1 */
        int64_t h0[64] = {0}, h1[64] = {0}, h2[64] = {0}, h3[64] = {0};
        for (int64_t j = 0; j + 4 <= chunk; j += 4) {
            h0[p[j] >> 2]++;
            h1[p[j + 1] >> 2]++;
            h2[p[j + 2] >> 2]++;
            h3[p[j + 3] >> 2]++;
        }
        for (int64_t j = chunk & ~(int64_t)3; j < chunk; j++)
            h0[p[j] >> 2]++;
        for (int i = 0; i < 64; i++)
            cur[i] = h0[i] + h1[i] + h2[i] + h3[i];
        if (c == 0) {
            for (int i = 0; i < 64; i++) seg[i] = cur[i];
            segn = 1;
            continue;
        }
        int64_t div = 0;
        for (int i = 0; i < 64; i++) {
            int64_t d = seg[i] - segn * cur[i];
            div += d < 0 ? -d : d;
        }
        int64_t off = c * chunk;
        if (10 * div > 7 * segn * chunk && off >= min_seg
            && n - off >= min_seg && k < out_cap) {
            out[k++] = bs + off;
            for (int i = 0; i < 64; i++) seg[i] = cur[i];
            segn = 1;
        } else {
            for (int i = 0; i < 64; i++) seg[i] += cur[i];
            segn++;
        }
    }
    return k;
}

/* 4-stream Huffman literal section body (HUF_compress4X_usingCTable
 * role): 6-byte jump table + 4 streams in one call. Returns total
 * length, -1 when any stream overflows caps or format limits (caller
 * falls back to 1-stream / raw). */
int64_t zt_huf_encode4(const uint8_t* data, int64_t n,
                       const int32_t* nb, const int32_t* val,
                       uint8_t* out, int64_t out_cap)
{
    if (n < 12) return -1;
    int64_t seg = (n + 3) / 4;
    int64_t sizes[4];
    uint8_t* p = out + 6;
    for (int s = 0; s < 4; s++) {
        int64_t lo = s * seg;
        int64_t hi = lo + seg < n ? lo + seg : n;
        int64_t cap_left = (out + out_cap) - p;
        int64_t len = zt_huf_encode(data + lo, hi - lo, nb, val, p, cap_left);
        if (len <= 0 || (s < 3 && len > 65535)) return -1;
        sizes[s] = len;
        p += len;
    }
    for (int s = 0; s < 3; s++) {
        out[2 * s] = (uint8_t)(sizes[s] & 0xFF);
        out[2 * s + 1] = (uint8_t)((sizes[s] >> 8) & 0xFF);
    }
    return (int64_t)(p - out);
}
