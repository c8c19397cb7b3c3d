/* Entropy planning of the device encode, a batch of blocks in one call.
 *
 * zt_plan_batch plans every block of a batch from its stats vector (stage
 * A's histograms, pipeline.py's _STATS_* layout): the sequences header
 * with a fresh entropy state (ZSTD_selectEncodingType on both of its
 * branches, then ZSTD_buildCTable with the last code's count decremented:
 * zstd's lib/compress/zstd_compress_sequences.c and
 * ZSTD_buildSequencesStatistics in zstd_compress.c), the FSE tables padded
 * into the plan row, the estimate of the block's device pieces
 * (ZSTD_fseBitCost and the extra-bit totals) and the literal plan (the
 * gates of ZSTD_compressLiterals, HUF_optimalTableLog, the Huffman table
 * and its tree description, the 1- and 4-stream sizes). The rules are
 * format/sequences.py's build_sequences_header_from_hists and the literal
 * planning that TorchCompressor._build_plans did per block in Python,
 * exactly: the same plan rows, headers and trees.
 *
 * The FSE and Huffman pieces are those of huf.c and encode.c
 * (zt_fse_optimal_table_log, zt_fse_normalize, zt_fse_write_ncount,
 * zt_fse_build_ctable, zt_huf_build_write); the format's constant tables
 * come from the caller (constants.py, sequences.K_INV_PROB_LOG256).
 *
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ---- primitives from the sibling objects ---- */
int zt_fse_optimal_table_log(int max_table_log, int64_t src_size,
                             int max_symbol, int minus);
int64_t zt_fse_normalize(const int64_t*, int, int64_t, int, int, int32_t*);
int64_t zt_fse_write_ncount(const int32_t*, int, int, uint8_t*, int64_t);
int64_t zt_fse_build_ctable(const int32_t*, int, int, int32_t*, int64_t*,
                            int64_t*);
int64_t zt_huf_build_write(const int64_t*, int, int, int32_t*, int32_t*,
                           uint8_t*, int64_t, int64_t*);

/* stats row (pipeline.py _STATS_*) */
#define ST_LL 1024
#define ST_ML 1060
#define ST_OF 1113
#define ST_TAIL 1145
#define STATS_LEN 1152

/* plan row (pipeline.py _PB_*; STATE_TABLE_PAD and SYM_PAD of
 * ops/fse_enc.py) */
#define STATE_TABLE_PAD 512
#define SYM_PAD 64
#define PB_ST 0
#define PB_DN (PB_ST + 3 * STATE_TABLE_PAD)
#define PB_DF (PB_DN + 3 * SYM_PAD)
#define PB_TL (PB_DF + 3 * SYM_PAD)
#define PB_NBL (PB_TL + 3)
#define PB_VAL (PB_NBL + 256)
#define PB_SINGLE (PB_VAL + 256)
#define PB_LITRAW (PB_SINGLE + 1)
#define PB_HUFUSED (PB_LITRAW + 1)
#define PB_BLEN (PB_HUFUSED + 1)
#define PLAN_LEN (PB_BLEN + 1)

/* the record of one block (native.py PLAN_FIELDS, in this order) */
enum { R_KIND, R_SINGLE, R_SIZE0, R_C_SIZE = R_SIZE0 + 4, R_EST,
       R_LAST_COUNT, R_NB_SEQ, R_NB_LIT, R_ALL_SAME, R_FIRST_LIT,
       R_HDR_OFF, R_HDR_LEN, R_TREE_OFF, R_TREE_LEN, R_HUF_LOG,
       R_HUF_MAX_SYMBOL, REC_LEN };

enum { MODE_PREDEFINED = 0, MODE_RLE = 1, MODE_FSE = 2 };
enum { LIT_RAW = 0, LIT_RLE = 1, LIT_HUF = 2 };

#define LL_FSE_LOG 9
#define OF_FSE_LOG 8
#define ML_FSE_LOG 9
#define LL_DEFAULT_LOG 6
#define OF_DEFAULT_LOG 5
#define ML_DEFAULT_LOG 6
#define DEFAULT_MAX_OFF 28
#define HUF_TABLELOG_DEFAULT 11
#define TREE_CAP 260        /* zt_huf_build_write's least tree buffer */

typedef struct {
    int tlog, max_symbol;
    int32_t st[STATE_TABLE_PAD];
    int64_t dnb[SYM_PAD], dfs[SYM_PAD];
} CTab;

/* one channel's counts: n codes, the largest code present, the top count */
typedef struct {
    int64_t count[SYM_PAD];
    int n, mx;
    int64_t most;
} Hist;

static int hist_of(const int32_t* row, int n, Hist* h) {
    h->n = n;
    h->mx = -1;
    h->most = 0;
    for (int s = 0; s < n; s++) {
        h->count[s] = row[s];
        if (row[s]) h->mx = s;
        if (row[s] > h->most) h->most = row[s];
    }
    return h->mx < 0 ? -1 : 0;
}

/* ZSTD_crossEntropyCost (sequences.py _cross_entropy_cost) */
static int64_t cross_entropy_cost(const int32_t* norm, int acc_log,
                                  const Hist* h, const int64_t* K) {
    int shift = 8 - acc_log;
    int64_t cost = 0;
    for (int s = 0; s <= h->mx; s++) {
        int64_t p = norm[s] == -1 ? 1 : norm[s];
        cost += h->count[s] * K[p << shift];
    }
    return cost >> 8;
}

/* ZSTD_entropyCost (sequences.py _entropy_cost); -1 where a count passes
 * the total */
static int entropy_cost(const Hist* h, int64_t total, const int64_t* K,
                        int64_t* out) {
    int64_t cost = 0;
    for (int s = 0; s <= h->mx; s++) {
        int64_t c = h->count[s];
        int64_t p = (256 * c) / total;
        if (c && !p) p = 1;
        if (p > 255) return -1;
        cost += c * K[p];
    }
    *out = cost >> 8;
    return 0;
}

/* ZSTD_fseBitCost (sequences.py _fse_bit_cost): 0 and the cost in *out,
 * or -1 where the table cannot represent the counts */
static int fse_bit_cost(const CTab* ct, const Hist* h, int64_t* out) {
    const int acc = 8;
    int tlog = ct->tlog;
    if (ct->max_symbol < h->mx) return -1;
    int64_t table_size = (int64_t)1 << tlog;
    int64_t cost = 0;
    for (int s = 0; s <= h->mx; s++) {
        if (!h->count[s]) continue;
        int64_t d = ct->dnb[s];
        int64_t min_nb = d >> 16;
        if (min_nb + 1 > tlog) return -1;
        int64_t threshold = (min_nb + 1) * 65536;
        int64_t nd = ((threshold - (d + table_size)) * 256) >> tlog;
        int64_t bit_cost = min_nb * 256 + nd;
        if (bit_cost >= (int64_t)(tlog + 1) * 256) return -1;
        cost += h->count[s] * bit_cost;
    }
    *out = cost >> acc;
    return 0;
}

/* ZSTD_selectEncodingType with a fresh state (no previous table, so never
 * the repeat mode): sequences.py select_encoding_type. -1 on a failed
 * normalization */
static int select_mode(const Hist* h, int64_t nb_seq, int fse_log,
                       const int32_t* def_norm, int def_log, int def_allowed,
                       int strategy, const int64_t* K) {
    if (h->most == nb_seq)
        return def_allowed && nb_seq <= 2 ? MODE_PREDEFINED : MODE_RLE;
    if (strategy < 5) {          /* below ZSTD_lazy: the heuristic */
        if (def_allowed) {
            int64_t dyn_min =
                ((int64_t)(1 << def_log) * (10 - strategy)) >> 3;
            if (nb_seq < dyn_min || h->most < (nb_seq >> (def_log - 1)))
                return MODE_PREDEFINED;
        }
        return MODE_FSE;
    }
    /* the costs: predefined against a new table and its description */
    int tlog = zt_fse_optimal_table_log(fse_log, nb_seq, h->mx, 2);
    int32_t norm[SYM_PAD];
    uint8_t desc[512];
    int64_t ent;
    if (zt_fse_normalize(h->count, tlog, nb_seq, h->mx, nb_seq >= 2048,
                         norm) < 0)
        return -1;
    int64_t ncount = zt_fse_write_ncount(norm, h->mx, tlog, desc,
                                         sizeof desc);
    if (ncount < 0 || entropy_cost(h, nb_seq, K, &ent) < 0) return -1;
    if (def_allowed
        && cross_entropy_cost(def_norm, def_log, h, K) <= (ncount << 3) + ent)
        return MODE_PREDEFINED;
    return MODE_FSE;
}

/* ZSTD_buildCTable (sequences.py build_seq_ctable): the table in *ct, its
 * description at hdr; returns the description's length, -1 on failure */
static int64_t build_table(int mode, const Hist* h, int last_code,
                           int64_t nb_seq, int fse_log,
                           const int32_t* def_norm, int def_log, int def_max,
                           CTab* ct, uint8_t* hdr, int64_t cap) {
    if (mode == MODE_RLE) {      /* FSE_buildCTable_rle: all zero */
        if (cap < 1) return -1;
        ct->tlog = 0;
        ct->max_symbol = h->mx;
        memset(ct->st, 0, 2 * sizeof(int32_t));
        memset(ct->dnb, 0, (size_t)(h->mx + 1) * sizeof(int64_t));
        memset(ct->dfs, 0, (size_t)(h->mx + 1) * sizeof(int64_t));
        hdr[0] = (uint8_t)h->mx;
        return 1;
    }
    if (mode == MODE_PREDEFINED) {
        ct->tlog = def_log;
        ct->max_symbol = def_max;
        return zt_fse_build_ctable(def_norm, def_max, def_log, ct->st,
                                   ct->dnb, ct->dfs) == 0 ? 0 : -1;
    }
    int tlog = zt_fse_optimal_table_log(fse_log, nb_seq, h->mx, 2);
    int64_t cnt[SYM_PAD];
    int64_t total = nb_seq;
    int32_t norm[SYM_PAD];
    if (last_code < 0 || last_code >= h->n) return -1;
    memcpy(cnt, h->count, (size_t)h->n * sizeof(int64_t));
    /* the last sequence's code rides in the initial state */
    if (cnt[last_code] > 1) {
        cnt[last_code]--;
        total--;
    }
    if (zt_fse_normalize(cnt, tlog, total, h->mx, total >= 2048, norm) < 0)
        return -1;
    int64_t len = zt_fse_write_ncount(norm, h->mx, tlog, hdr, cap);
    if (len < 0
        || zt_fse_build_ctable(norm, h->mx, tlog, ct->st, ct->dnb,
                               ct->dfs) != 0)
        return -1;
    ct->tlog = tlog;
    ct->max_symbol = h->mx;
    return len;
}

/* the table into plan row slot t (pipeline.py's _pad_ct) */
static void put_table(int32_t* row, int t, const CTab* ct) {
    int32_t* st = row + PB_ST + t * STATE_TABLE_PAD;
    int32_t* dn = row + PB_DN + t * SYM_PAD;
    int32_t* df = row + PB_DF + t * SYM_PAD;
    int n_st = ct->tlog ? 1 << ct->tlog : 0;   /* the RLE table is zeros */
    for (int u = 0; u < n_st; u++) st[u] = ct->st[u];
    for (int s = 0; s <= ct->max_symbol; s++) {
        dn[s] = (int32_t)ct->dnb[s];
        df[s] = (int32_t)ct->dfs[s];
    }
    row[PB_TL + t] = ct->tlog;
}

static int64_t nbseq_header(int64_t n, uint8_t* out) {
    if (n < 128) {
        out[0] = (uint8_t)n;
        return 1;
    }
    if (n < 0x7F00) {
        out[0] = (uint8_t)((n >> 8) + 0x80);
        out[1] = (uint8_t)(n & 0xFF);
        return 2;
    }
    out[0] = 0xFF;
    out[1] = (uint8_t)((n - 0x7F00) & 0xFF);
    out[2] = (uint8_t)(((n - 0x7F00) >> 8) & 0xFF);
    return 3;
}

typedef struct {
    const int32_t *ll_bits, *ml_bits, *ll_def, *of_def, *ml_def;
    const int64_t* K;
} Consts;

/* the sequences header and tables of one block (sequences.py
 * build_sequences_header_from_hists with FseEntropyState()), its plan row's
 * tables and the expected bitstream bytes. Returns the header's length,
 * -1 on failure */
static int64_t plan_sequences(const int32_t* srow, int64_t nb_seq,
                              int strategy, const Consts* c, int32_t* row,
                              uint8_t* hdr, int64_t cap, int64_t* last_count,
                              int64_t* est) {
    *last_count = 0;
    *est = 0;
    if (cap < 4) return -1;
    int64_t len = nbseq_header(nb_seq, hdr);
    if (nb_seq == 0) return len;

    static const int fse_log[3] = {LL_FSE_LOG, OF_FSE_LOG, ML_FSE_LOG};
    static const int def_log[3] = {LL_DEFAULT_LOG, OF_DEFAULT_LOG,
                                   ML_DEFAULT_LOG};
    static const int def_max[3] = {35, DEFAULT_MAX_OFF, 52};
    static const int at[3] = {ST_LL, ST_OF, ST_ML};
    static const int n_codes[3] = {36, 32, 53};
    const int32_t* def_norm[3] = {c->ll_def, c->of_def, c->ml_def};
    Hist h[3];
    CTab ct[3];
    int mode[3];
    int64_t modes_at = len++;
    for (int t = 0; t < 3; t++) {        /* LL, OF, ML */
        if (hist_of(srow + at[t], n_codes[t], &h[t]) < 0) return -1;
        int def_allowed = t != 1 || h[t].mx <= DEFAULT_MAX_OFF;
        mode[t] = select_mode(&h[t], nb_seq, fse_log[t], def_norm[t],
                              def_log[t], def_allowed, strategy, c->K);
        if (mode[t] < 0) return -1;
        int64_t n = build_table(mode[t], &h[t], srow[ST_TAIL + t], nb_seq,
                                fse_log[t], def_norm[t], def_log[t],
                                def_max[t], &ct[t], hdr + len, cap - len);
        if (n < 0) return -1;
        if (mode[t] == MODE_FSE) *last_count = n;
        len += n;
        put_table(row, t, &ct[t]);
    }
    hdr[modes_at] = (uint8_t)((mode[0] << 6) + (mode[1] << 4)
                              + (mode[2] << 2));

    /* per channel the state bits (the fractional FSE cost, or table_log a
     * sequence where the table cannot give one), the extra bits and the
     * initial state */
    int64_t bits = 0;
    for (int t = 0; t < 3; t++) {
        int64_t sc;
        if (fse_bit_cost(&ct[t], &h[t], &sc) == 0) bits += sc;
        else bits += nb_seq * ct[t].tlog;
        for (int s = 0; s < h[t].n; s++) {
            int64_t xb = t == 0 ? c->ll_bits[s] : t == 2 ? c->ml_bits[s] : s;
            bits += h[t].count[s] * xb;
        }
        bits += ct[t].tlog;
    }
    *est = (bits >> 3) + 16;
    return len;
}

/* the literal plan of one block: kind, and for Huffman the table into the
 * plan row, the tree at tree_out and the stream sizes into r. Returns the
 * kind, -1 on failure */
static int plan_literals(const int32_t* h4, int64_t n_lit, int strategy,
                         int32_t* row, uint8_t* tree_out, int64_t* r) {
    if (n_lit == 0) return LIT_RAW;
    int shift = 9 - strategy < 3 ? 9 - strategy : 3;
    if (n_lit < (8 << shift)) return LIT_RAW;
    int64_t hist[256];
    int64_t largest = 0;
    int max_symbol = -1;
    for (int s = 0; s < 256; s++) {
        hist[s] = (int64_t)h4[s] + h4[256 + s] + h4[512 + s] + h4[768 + s];
        if (hist[s] > largest) largest = hist[s];
        if (hist[s]) max_symbol = s;
    }
    if (largest == n_lit) return LIT_RLE;
    if (largest <= (n_lit >> 7) + 4) return LIT_RAW;
    int huff_log = zt_fse_optimal_table_log(HUF_TABLELOG_DEFAULT, n_lit,
                                            max_symbol, 1);
    int32_t nb[256], val[256];
    int64_t tree_len = 0;
    int64_t tlog = zt_huf_build_write(hist, max_symbol, huff_log, nb, val,
                                      tree_out, TREE_CAP, &tree_len);
    if (tlog == -2) return LIT_RAW;  /* > 128 symbols, weights incompressible */
    if (tlog < 0) return -1;
    if (tree_len + 12 >= n_lit) return LIT_RAW;

    int minlog = strategy >= 8 ? strategy - 1 : 6;
    int64_t min_gain = (n_lit >> minlog) + 2;
    int single = n_lit < 256;
    int64_t sizes[4] = {0, 0, 0, 0};
    int64_t c_size;
    if (single) {
        int64_t bits = 0;
        for (int s = 0; s < 256; s++) bits += hist[s] * nb[s];
        sizes[0] = (bits + 1 + 7) / 8;
        c_size = tree_len + sizes[0];
    } else {
        if (n_lit < 12) return LIT_RAW;
        for (int t = 0; t < 4; t++) {
            int64_t bits = 0;
            for (int s = 0; s < 256; s++) bits += (int64_t)h4[256 * t + s] * nb[s];
            sizes[t] = (bits + 1 + 7) / 8;
            if (t < 3 && sizes[t] > 65535) return LIT_RAW;
        }
        c_size = tree_len + 6 + sizes[0] + sizes[1] + sizes[2] + sizes[3];
    }
    if (c_size >= n_lit - min_gain || c_size >= n_lit - 1) return LIT_RAW;

    memcpy(row + PB_NBL, nb, sizeof nb);
    memcpy(row + PB_VAL, val, sizeof val);
    row[PB_SINGLE] = single;
    row[PB_HUFUSED] = 1;
    r[R_SINGLE] = single;
    for (int t = 0; t < 4; t++) r[R_SIZE0 + t] = sizes[t];
    r[R_C_SIZE] = c_size;
    r[R_TREE_LEN] = tree_len;
    r[R_HUF_LOG] = tlog;
    r[R_HUF_MAX_SYMBOL] = max_symbol;
    return LIT_HUF;
}

/* Plans blocks [0, nb_blocks): stats int32[nb_blocks, stats_len] and lens
 * int32[nb_blocks] in; the plan rows int32[nb_blocks, plan_len] (written
 * whole), the records int64[nb_blocks, rec_len] and the headers and trees
 * into arena out. The constant tables: LL_BITS[36], ML_BITS[53], the
 * predefined LL[36], OF[29] and ML[53] distributions, K[256]
 * (kInverseProbabilityLog256). Returns the arena bytes used; -1 where
 * stats_len, plan_len or rec_len is not this file's layout or the arena is
 * short, -2 - j where block j's planning fails (a count past its total, a
 * failed normalization: the Python rules raise there). */
int64_t zt_plan_batch(const int32_t* stats, int64_t stats_len,
                      const int32_t* lens, int64_t nb_blocks, int strategy,
                      const int32_t* ll_bits, const int32_t* ml_bits,
                      const int32_t* ll_def, const int32_t* of_def,
                      const int32_t* ml_def, const int64_t* K,
                      int32_t* blob, int64_t plan_len,
                      int64_t* rec, int64_t rec_len,
                      uint8_t* arena, int64_t arena_cap)
{
    if (stats_len != STATS_LEN || plan_len != PLAN_LEN || rec_len != REC_LEN)
        return -1;
    const Consts c = {ll_bits, ml_bits, ll_def, of_def, ml_def, K};
    int64_t used = 0;
    for (int64_t j = 0; j < nb_blocks; j++) {
        const int32_t* srow = stats + j * STATS_LEN;
        int32_t* row = blob + j * PLAN_LEN;
        int64_t* r = rec + j * REC_LEN;
        int64_t nb_seq = srow[ST_TAIL + 3], nb_lit = srow[ST_TAIL + 4];
        int64_t blen = lens[j];
        memset(row, 0, PLAN_LEN * sizeof(int32_t));
        memset(r, 0, REC_LEN * sizeof(int64_t));
        if (arena_cap - used < 4 + 3 * 128 + TREE_CAP) return -1;

        int64_t last_count, est_fse;
        int64_t hlen = plan_sequences(srow, nb_seq, strategy, &c, row,
                                      arena + used, 4 + 3 * 128, &last_count,
                                      &est_fse);
        if (hlen < 0) return -2 - j;
        r[R_HDR_OFF] = used;
        r[R_HDR_LEN] = hlen;
        used += hlen;

        int kind = plan_literals(srow, nb_lit, strategy, row, arena + used, r);
        if (kind < 0) return -2 - j;
        int64_t est_lit = 0;
        if (kind == LIT_HUF) {
            r[R_TREE_OFF] = used;
            used += r[R_TREE_LEN];
            est_lit = r[R_SIZE0] + r[R_SIZE0 + 1] + r[R_SIZE0 + 2]
                + r[R_SIZE0 + 3];
        } else if (kind == LIT_RAW) {
            row[PB_LITRAW] = 1;
            est_lit = nb_lit;
        }
        row[PB_BLEN] = (int32_t)blen;

        r[R_KIND] = kind;
        /* the estimate sizes the compact prefix's fetch; the device stores
         * a block whose estimate reaches its length raw */
        r[R_EST] = est_fse + est_lit < blen + 16 ? est_fse + est_lit
                                                 : blen + 16;
        r[R_LAST_COUNT] = last_count;
        r[R_NB_SEQ] = nb_seq;
        r[R_NB_LIT] = nb_lit;
        r[R_ALL_SAME] = srow[ST_TAIL + 5] != 0;
        r[R_FIRST_LIT] = srow[ST_TAIL + 6];
    }
    return used;
}
