/* Whole-frame fast-path block loop in C (levels 1-2 and --fast).
 *
 * Role: the reference's single-pass architecture — one C call per frame
 * runs matchfind -> literals -> entropy -> block emit for every block
 * (ZSTD_compress_frameChunk + ZSTD_compressBlock_internal,
 * zstd's lib/compress/zstd_compress.c:4527,:4325) — where the
 * Python block loop pays ~3x the parse cost in per-block numpy/glue.
 * Reuses this repo's native primitives: zt_fast_parse (fast.c),
 * zt_huf_build_write / zt_fse_normalize / zt_fse_write_ncount (huf.c),
 * zt_fse_build_ctable / zt_encode_sequences / zt_huf_encode[4] (encode.c).
 *
 * Mode selection mirrors the fast-strategy branch of
 * ZSTD_selectEncodingType (zstd_compress_sequences.c): RLE for a
 * single-symbol histogram, predefined under the nbSeq/most-frequent
 * heuristics, FSE otherwise; repeat mode is never chosen (fast-level
 * blocks carry thousands of sequences, far past the static 1000-sequence
 * ceiling that gates it in the reference).
 *
 * Copy of native/cblock.c.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ---- primitives from the sibling objects ---- */
int64_t zt_fast_parse(const uint8_t*, int64_t, int64_t, int64_t, uint32_t*,
                      int32_t*, int32_t*, int32_t*, int64_t,
                      int, int, int, int, int32_t*);
int64_t zt_split_points(const uint8_t*, int64_t, int64_t, int64_t, int64_t,
                        int64_t*, int64_t);
int64_t zt_row_parse(const uint8_t*, int64_t, int64_t, int64_t, uint32_t*,
                     int32_t*, int32_t*, int32_t*, int64_t,
                     int, int, int, int, int, int,
                     int32_t*, uint8_t*, uint8_t*, int32_t*, int);
void* zt_opt_ctx_new(void);
void zt_opt_ctx_free(void*);
int64_t zt_opt_parse_ctx(void*, const uint8_t*, int64_t, int64_t, int64_t,
                         int64_t, uint32_t*, int32_t*, int32_t*, int32_t*,
                         int64_t, int, int, int, int, int);
int64_t zt_huf_build_write(const int64_t*, int, int, int32_t*, int32_t*,
                           uint8_t*, int64_t, int64_t*);
int64_t zt_fse_normalize(const int64_t*, int, int64_t, int, int, int32_t*);
int64_t zt_fse_write_ncount(const int32_t*, int, int, uint8_t*, int64_t);
int64_t zt_fse_build_ctable(const int32_t*, int, int, int32_t*, int64_t*,
                            int64_t*);
int64_t zt_encode_sequences(int64_t, const int32_t*, const int32_t*,
                            const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, const int32_t*, const int32_t*,
                            int, const int32_t*, const int64_t*,
                            const int64_t*, int, const int32_t*,
                            const int64_t*, const int64_t*, int,
                            const int32_t*, const int64_t*, const int64_t*,
                            uint8_t*, int64_t);
int64_t zt_huf_encode(const uint8_t*, int64_t, const int32_t*,
                      const int32_t*, uint8_t*, int64_t);
int64_t zt_huf_encode4(const uint8_t*, int64_t, const int32_t*,
                       const int32_t*, uint8_t*, int64_t);

#define MAX_BLOCK (128 * 1024)
#define MINMATCH 3

/* RFC 8878 sequence-code value tables */
static const uint32_t LL_BASE_T[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
static const int32_t LL_BITS_T[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE_T[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
static const int32_t ML_BITS_T[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* predefined distributions (RFC 8878 default FSE tables) */
static const int32_t LL_DEF_N[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int32_t ML_DEF_N[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int32_t OF_DEF_N[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static inline uint32_t highbit_u32(uint32_t v) {
    return 31 - __builtin_clz(v);
}

static inline uint32_t ll_code(uint32_t ll) {
    if (ll <= 15) return ll;
    uint32_t lo = 16, hi = 35;
    while (lo < hi) {
        uint32_t mid = (lo + hi + 1) >> 1;
        if (LL_BASE_T[mid] <= ll) lo = mid; else hi = mid - 1;
    }
    return lo;
}

static inline uint32_t ml_code(uint32_t mlb) {  /* mlb = len - 3 */
    if (mlb <= 31) return mlb;
    uint32_t lo = 32, hi = 52, l = mlb + 3;
    while (lo < hi) {
        uint32_t mid = (lo + hi + 1) >> 1;
        if (ML_BASE_T[mid] <= l) lo = mid; else hi = mid - 1;
    }
    return lo;
}

/* FSE_optimalTableLog (minus=2; fse.py optimal_table_log mirror) */
static int opt_tlog(int max_log, int64_t n, int max_sym) {
    int tl = max_log;
    if (n > 1) {
        int mb = (int)highbit_u32((uint32_t)(n - 1)) - 2;
        if (mb < tl) tl = mb;
    } else {
        tl = 0;
    }
    int min_src = (int)highbit_u32((uint32_t)n) + 1;
    int min_sym = max_sym ? (int)highbit_u32((uint32_t)max_sym) + 2 : 2;
    int mn = min_src < min_sym ? min_src : min_sym;
    if (mn > tl) tl = mn;
    if (tl < 5) tl = 5;
    if (tl > 15) tl = 15;
    return tl;
}

/* one built compression table */
typedef struct {
    int tlog;
    int32_t st[1 << 9];
    int64_t dnb[64];
    int64_t dfs[64];
} CTab;

/* build one sequence-code table section: picks the mode, writes the
 * header bytes (0 for predefined/RLE symbol byte for RLE), fills `ct`.
 * Returns header length written to hdr, or -1. mode_out: 0 predef,
 * 1 RLE, 2 FSE (spec Symbol_Compression_Modes values handled by caller).
 */
static int build_code_table(const int64_t* hist, int max_code, int fse_log,
                            int def_log, const int32_t* def_norm,
                            int def_max, int64_t nbseq, int strategy,
                            CTab* ct, uint8_t* hdr, int* mode_out) {
    int64_t most = 0, nz = 0;
    int last = 0;
    for (int s = 0; s <= max_code; s++) {
        if (hist[s]) { nz++; last = s; if (hist[s] > most) most = hist[s]; }
    }
    if (most == nbseq && !(last <= def_max && nbseq <= 2)) {
        /* single symbol: RLE (tiny single-symbol sets go predefined,
         * select_encoding_type's nbSeq<=2 carve-out) */
        hdr[0] = (uint8_t)last;
        /* FSE_buildCTable_rle: all-zero tables give nb_out 0 everywhere
         * and state 0 (fse.py build_ctable_rle mirror) */
        ct->tlog = 0;
        memset(ct->st, 0, sizeof(ct->st));
        memset(ct->dnb, 0, sizeof(ct->dnb));
        memset(ct->dfs, 0, sizeof(ct->dfs));
        *mode_out = 1;
        return 1;
    }
    /* fast-strategy heuristic (ZSTD_selectEncodingType, strategy < lazy) */
    int mult = 10 - strategy;
    int64_t dyn_min = ((int64_t)(1 << def_log) * mult) >> 3;
    if (last <= def_max
        && (nbseq < dyn_min || most < (nbseq >> (def_log - 1)))) {
        if (zt_fse_build_ctable(def_norm, def_max, def_log, ct->st,
                                ct->dnb, ct->dfs) < 0) return -1;
        ct->tlog = def_log;
        *mode_out = 0;
        return 0;
    }
    {
        int tlog = opt_tlog(fse_log, nbseq, last);
        int32_t norm[64];
        if (zt_fse_normalize(hist, tlog, nbseq, last,
                             nbseq >= 2048, norm) < 0) return -1;
        int64_t hlen = zt_fse_write_ncount(norm, last, tlog, hdr, 128);
        if (hlen < 0) return -1;
        if (zt_fse_build_ctable(norm, last, tlog, ct->st, ct->dnb,
                                ct->dfs) < 0) return -1;
        ct->tlog = tlog;
        *mode_out = 2;
        return (int)hlen;
    }
}

/* scratch for one frame walk */
typedef struct {
    int32_t ll[MAX_BLOCK / 4 + 16];
    int32_t ob[MAX_BLOCK / 4 + 16];
    int32_t mb[MAX_BLOCK / 4 + 16];
    int32_t llc[MAX_BLOCK / 4 + 16];
    int32_t ofc[MAX_BLOCK / 4 + 16];
    int32_t mlc[MAX_BLOCK / 4 + 16];
    uint8_t lits[MAX_BLOCK + 32];
    /* payload scratch: worst case ~ raw literals + max-width sequence
     * bitstream, well under 4 blocks' worth */
    uint8_t scratch[4 * MAX_BLOCK + 4096];
    CTab ll_ct, of_ct, ml_ct;
} FastScratch;

#include <stdlib.h>

/* Compress [start, end) of `base` into concatenated zstd blocks (headers
 * included, final block flagged last). Returns bytes written, or -1
 * (caller falls back to the Python block loop). Two parser modes share
 * the block-emit body: the fast greedy (levels 1-2; `table` =
 * int32[2 << hash_log], -1 filled, persists across calls) and the row
 * matchfinder (levels 3-4; row_* tables persist across calls). */
static int64_t compress_frame_core(
    const uint8_t* base, int64_t start, int64_t end, int64_t window_size,
    int64_t block_size, int hash_log, int accel_log, int mls, int step0,
    int strategy, uint32_t* reps, int32_t* table,
    uint8_t* out, int64_t out_cap,
    int use_row, int row_log, int width_log, int row_mls,
    int max_attempts, int defer,
    int32_t* row_pos, uint8_t* row_tag, uint8_t* row_head,
    int32_t* tlong, int hlog_long)
{
    if (block_size > MAX_BLOCK) return -1;
    FastScratch* S = malloc(sizeof(FastScratch));
    if (!S) return -1;
    void* optx = NULL;
    if (use_row == 2) {
        optx = zt_opt_ctx_new();
        if (!optx) { free(S); return -1; }
    }
    uint8_t* op = out;
    uint8_t* oend = out + out_cap;
    int64_t pos = start;
    int min_gain_log = strategy >= 8 ? strategy - 1 : 6;

    while (pos < end) {
        int64_t bend = pos + block_size < end ? pos + block_size : end;
        /* cheap entropy-divergence pre-split (zstd_preSplit.c role) */
        if (bend - pos >= 32768) {
            int64_t pts[8];
            int64_t np = zt_split_points(base, pos, bend, 8192, 16384,
                                         pts, 8);
            if (np > 0 && pts[0] > pos && pts[0] < bend) bend = pts[0];
        }
        int64_t blen = bend - pos;
        int last = (bend == end);
        int64_t window_low = pos - window_size;
        if (window_low < 0) window_low = 0;

        if (op + 3 + blen + 64 > oend) {
            free(S);
            if (optx) zt_opt_ctx_free(optx);
            return -1;
        }

        int64_t nseq = 0;
        if (blen >= 16) {
            if (use_row == 2) {
                /* shallow btultra DP (levels 10-15 class): hash_log /
                 * search_log arrive pre-floored by the caller; the DP's
                 * own matcher context persists across the frame */
                nseq = zt_opt_parse_ctx(optx, base, window_low, pos, bend,
                                        end, reps, S->ll, S->ob, S->mb,
                                        MAX_BLOCK / 4 + 16,
                                        hash_log, max_attempts, row_mls,
                                        defer, strategy);
            } else if (use_row == 1) {
                nseq = zt_row_parse(base, window_low, pos, bend, reps,
                                    S->ll, S->ob, S->mb, MAX_BLOCK / 4 + 16,
                                    row_log, width_log, row_mls,
                                    max_attempts, defer, accel_log,
                                    row_pos, row_tag, row_head, tlong,
                                    hlog_long);
            } else {
                nseq = zt_fast_parse(base, window_low, pos, bend, reps,
                                     S->ll, S->ob, S->mb, MAX_BLOCK / 4 + 16,
                                     hash_log, accel_log, mls, step0,
                                     table);
            }
            if (nseq < 0) { free(S); if (optx) zt_opt_ctx_free(optx); return -1; }
            /* over-matching detector (lazy2 class): a parse of uniformly
             * short fresh matches with ~no repcodes is the word-salad
             * regime where the greedy/lazy class loses to the reference
             * and the shallow DP wins — abort with -2 so the caller
             * reroutes the WHOLE frame through the Python path with its
             * per-block DP fallback (mirrors format/opt.py thresholds:
             * mean_ml < 9.8, rep share < 0.3%). */
            if (use_row && strategy >= 5 && nseq > 256) {
                int64_t mlsum = 0, repn = 0;
                for (int64_t i = 0; i < nseq; i++) {
                    mlsum += S->mb[i] + MINMATCH;
                    repn += (S->ob[i] <= 3);
                }
                if (10 * mlsum < 98 * nseq && 1000 * repn < 3 * nseq) {
                    free(S);
                    if (optx) zt_opt_ctx_free(optx);
                    return -2;
                }
            }
        }

        /* literals assembly + RLE-block detection */
        int64_t nlit = 0;
        {
            int64_t cur = pos;
            for (int64_t i = 0; i < nseq; i++) {
                int64_t ll = S->ll[i];
                memcpy(S->lits + nlit, base + cur, ll);
                nlit += ll;
                cur += ll + S->mb[i] + MINMATCH;
            }
            int64_t tail = bend - cur;
            memcpy(S->lits + nlit, base + cur, tail);
            nlit += tail;
        }

        uint8_t* payload = S->scratch;
        int64_t psize = 0;

        /* ---- literals section ---- */
        int64_t hist[256];
        int64_t largest = 0, last_sym = 0;
        {
            memset(hist, 0, sizeof(hist));
            for (int64_t i = 0; i < nlit; i++) hist[S->lits[i]]++;
            for (int s = 0; s < 256; s++)
                if (hist[s]) { last_sym = s; if (hist[s] > largest) largest = hist[s]; }
        }
        int min_lit = 8 << (9 - strategy < 3 ? 9 - strategy : 3);
        int64_t lit_min_gain = (nlit >> min_gain_log) + 2;
        int wrote_lit = 0;
        if (nlit >= min_lit && largest != nlit
            && largest > (nlit >> 7) + 4) {
            int32_t nb[256], val[256];
            uint8_t tree[300];
            int64_t tree_len = 0;
            int max_nb;
            /* HUF_optimalTableLog: minus=1 variant of the FSE heuristic */
            {
                int tl = 11;
                if (nlit > 1) {
                    int mb = (int)highbit_u32((uint32_t)(nlit - 1)) - 1;
                    if (mb < tl) tl = mb;
                }
                int min_src = (int)highbit_u32((uint32_t)nlit) + 1;
                int min_sym = last_sym ?
                    (int)highbit_u32((uint32_t)last_sym) + 2 : 2;
                int mn = min_src < min_sym ? min_src : min_sym;
                if (mn > tl) tl = mn;
                if (tl < 5) tl = 5;
                max_nb = tl;
            }
            int64_t tl = zt_huf_build_write(hist, (int)last_sym, max_nb,
                                            nb, val, tree, 300, &tree_len);
            if (tl > 0) {
                int single = nlit < 256;
                uint8_t* body = payload + 5;   /* max lit header size */
                memcpy(body, tree, tree_len);
                int64_t csz = single
                    ? zt_huf_encode(S->lits, nlit, nb, val,
                                    body + tree_len, 2 * MAX_BLOCK)
                    : zt_huf_encode4(S->lits, nlit, nb, val,
                                     body + tree_len, 2 * MAX_BLOCK);
                if (csz > 0) {
                    int64_t total = tree_len + csz;
                    if (total < nlit - lit_min_gain && total >= 2) {
                        /* header: 3/4/5 bytes by regen size */
                        int lh = 3 + (nlit >= 1024) + (nlit >= 16384);
                        uint64_t lhc;
                        if (lh == 3)
                            lhc = 2u | ((uint64_t)(single ? 0 : 1) << 2)
                                | ((uint64_t)nlit << 4)
                                | ((uint64_t)total << 14);
                        else if (lh == 4)
                            lhc = 2u | (2u << 2) | ((uint64_t)nlit << 4)
                                | ((uint64_t)total << 18);
                        else
                            lhc = 2u | (3u << 2) | ((uint64_t)nlit << 4)
                                | (((uint64_t)total & 0x3FF) << 22);
                        uint8_t* lp = payload;
                        for (int b = 0; b < (lh == 5 ? 4 : lh); b++)
                            lp[b] = (uint8_t)(lhc >> (8 * b));
                        if (lh == 5)
                            lp[4] = (uint8_t)(((uint64_t)total >> 10) & 0xFF);
                        memmove(payload + lh, body, total);
                        psize = lh + total;
                        wrote_lit = 1;
                    }
                }
            }
        }
        if (!wrote_lit && nlit >= 8 && largest == nlit) {
            /* RLE literal section */
            int fl = 1 + (nlit > 31) + (nlit > 4095);
            if (fl == 1) payload[0] = (uint8_t)(1 | ((nlit << 3) & 0xFF));
            else if (fl == 2) {
                uint32_t h = 1 | (1u << 2) | ((uint32_t)nlit << 4);
                payload[0] = (uint8_t)h; payload[1] = (uint8_t)(h >> 8);
            } else {
                uint32_t h = 1 | (3u << 2) | ((uint32_t)nlit << 4);
                payload[0] = (uint8_t)h; payload[1] = (uint8_t)(h >> 8);
                payload[2] = (uint8_t)(h >> 16);
            }
            payload[fl] = S->lits[0];
            psize = fl + 1;
            wrote_lit = 1;
        }
        if (!wrote_lit) {
            /* raw literals */
            int fl = 1 + (nlit > 31) + (nlit > 4095);
            if (fl == 1) payload[0] = (uint8_t)(0 | ((nlit << 3) & 0xFF));
            else if (fl == 2) {
                uint32_t h = 0 | (1u << 2) | ((uint32_t)nlit << 4);
                payload[0] = (uint8_t)h; payload[1] = (uint8_t)(h >> 8);
            } else {
                uint32_t h = 0 | (3u << 2) | ((uint32_t)nlit << 4);
                payload[0] = (uint8_t)h; payload[1] = (uint8_t)(h >> 8);
                payload[2] = (uint8_t)(h >> 16);
            }
            memcpy(payload + fl, S->lits, nlit);
            psize = fl + nlit;
        }

        /* ---- sequences section ---- */
        uint8_t* sp = payload + psize;
        if (nseq == 0) {
            *sp++ = 0;
            psize += 1;
        } else {
            /* nbseq header */
            if (nseq < 128) {
                *sp++ = (uint8_t)nseq;
            } else if (nseq < 0x7F00) {
                *sp++ = (uint8_t)((nseq >> 8) + 0x80);
                *sp++ = (uint8_t)(nseq & 0xFF);
            } else {
                *sp++ = 0xFF;
                uint32_t v = (uint32_t)(nseq - 0x7F00);
                *sp++ = (uint8_t)(v & 0xFF);
                *sp++ = (uint8_t)(v >> 8);
            }
            /* code arrays + histograms */
            int64_t llh[36] = {0}, ofh[32] = {0}, mlh[53] = {0};
            for (int64_t i = 0; i < nseq; i++) {
                uint32_t lc = ll_code((uint32_t)S->ll[i]);
                uint32_t oc = highbit_u32((uint32_t)S->ob[i]);
                uint32_t mc = ml_code((uint32_t)S->mb[i]);
                S->llc[i] = (int32_t)lc;
                S->ofc[i] = (int32_t)oc;
                S->mlc[i] = (int32_t)mc;
                llh[lc]++; ofh[oc]++; mlh[mc]++;
            }
            CTab* ll_ctp = &S->ll_ct; CTab* of_ctp = &S->of_ct;
            CTab* ml_ctp = &S->ml_ct;
            uint8_t h_ll[128], h_of[128], h_ml[128];
            int m_ll, m_of, m_ml;
            int l_ll = build_code_table(llh, 35, 9, 6, LL_DEF_N, 35, nseq,
                                        strategy, ll_ctp, h_ll, &m_ll);
            int l_of = build_code_table(ofh, 31, 8, 5, OF_DEF_N, 28, nseq,
                                        strategy, of_ctp, h_of, &m_of);
            int l_ml = build_code_table(mlh, 52, 9, 6, ML_DEF_N, 52, nseq,
                                        strategy, ml_ctp, h_ml, &m_ml);
            if (l_ll < 0 || l_of < 0 || l_ml < 0) {
                free(S);
                if (optx) zt_opt_ctx_free(optx);
                return -1;
            }
            /* compression-modes byte: 0 predef, 1 RLE, 2 FSE */
            *sp++ = (uint8_t)((m_ll << 6) | (m_of << 4) | (m_ml << 2));
            memcpy(sp, h_ll, l_ll); sp += l_ll;
            memcpy(sp, h_of, l_of); sp += l_of;
            memcpy(sp, h_ml, l_ml); sp += l_ml;
            /* values: ll extra = ll - base, ml extra = mb+3 - base,
             * of extra = ob - (1<<oc) */
            for (int64_t i = 0; i < nseq; i++) {
                S->ll[i] = (int32_t)((uint32_t)S->ll[i]
                                     - LL_BASE_T[S->llc[i]]);
                S->mb[i] = (int32_t)((uint32_t)(S->mb[i] + MINMATCH)
                                     - ML_BASE_T[S->mlc[i]]);
                S->ob[i] = (int32_t)((uint32_t)S->ob[i]
                                     - (1u << S->ofc[i]));
            }
            int64_t cap_left = (S->scratch + sizeof(S->scratch)) - sp;
            int64_t bl = zt_encode_sequences(
                nseq, S->ll, S->ob, S->mb, S->llc, S->ofc, S->mlc,
                LL_BITS_T, ML_BITS_T,
                ll_ctp->tlog, ll_ctp->st, ll_ctp->dnb, ll_ctp->dfs,
                of_ctp->tlog, of_ctp->st, of_ctp->dnb, of_ctp->dfs,
                ml_ctp->tlog, ml_ctp->st, ml_ctp->dnb, ml_ctp->dfs,
                sp, cap_left);
            if (bl <= 0) { free(S); if (optx) zt_opt_ctx_free(optx); return -1; }
            sp += bl;
            psize = sp - payload;
        }

        /* ---- emit: compressed vs raw vs RLE block ---- */
        int64_t block_min_gain = (blen >> min_gain_log) + 2;
        if (psize >= blen - block_min_gain) {
            if (blen > 1 && largest == nlit && nseq == 0 && nlit == blen) {
                uint32_t bh = (uint32_t)last | (1u << 1)
                            | ((uint32_t)blen << 3);
                op[0] = (uint8_t)bh; op[1] = (uint8_t)(bh >> 8);
                op[2] = (uint8_t)(bh >> 16);
                op[3] = base[pos];
                op += 4;
            } else {
                uint32_t bh = (uint32_t)last | (0u << 1)
                            | ((uint32_t)blen << 3);
                op[0] = (uint8_t)bh; op[1] = (uint8_t)(bh >> 8);
                op[2] = (uint8_t)(bh >> 16);
                memcpy(op + 3, base + pos, blen);
                op += 3 + blen;
            }
        } else {
            uint32_t bh = (uint32_t)last | (2u << 1)
                        | ((uint32_t)psize << 3);
            op[0] = (uint8_t)bh; op[1] = (uint8_t)(bh >> 8);
            op[2] = (uint8_t)(bh >> 16);
            memcpy(op + 3, payload, psize);
            op += 3 + psize;
        }
        pos = bend;
    }
    free(S);
    if (optx) zt_opt_ctx_free(optx);
    return op - out;
}

int64_t zt_compress_fast_frame(
    const uint8_t* base, int64_t start, int64_t end, int64_t window_size,
    int64_t block_size, int hash_log, int accel_log, int mls, int step0,
    int strategy, uint32_t* reps, int32_t* table,
    uint8_t* out, int64_t out_cap)
{
    return compress_frame_core(base, start, end, window_size, block_size,
                               hash_log, accel_log, mls, step0, strategy,
                               reps, table, out, out_cap,
                               0, 0, 0, 0, 0, 0,
                               NULL, NULL, NULL, NULL, 0);
}

/* shallow-DP whole-frame path (levels 10-15 class): sl/mm/tl arrive in
 * the max_attempts/row_mls/defer slots of the core (the DP has no row
 * tables). One native call per frame. */
int64_t zt_compress_dp_frame(
    const uint8_t* base, int64_t start, int64_t end, int64_t window_size,
    int64_t block_size, int strategy, uint32_t* reps,
    int hash_log, int search_log, int min_match, int target_len,
    uint8_t* out, int64_t out_cap)
{
    return compress_frame_core(base, start, end, window_size, block_size,
                               hash_log, 8, 0, 0, strategy, reps, NULL,
                               out, out_cap,
                               2, 0, 0, min_match,
                               search_log, target_len,
                               NULL, NULL, NULL, NULL, 0);
}

/* row-matchfinder whole-frame path (levels 3-4): one native call per
 * frame — the Python per-block loop pays ~35% of the encode in glue */
int64_t zt_compress_row_frame(
    const uint8_t* base, int64_t start, int64_t end, int64_t window_size,
    int64_t block_size, int strategy, uint32_t* reps,
    int row_log, int width_log, int row_mls, int max_attempts, int defer,
    int32_t* row_pos, uint8_t* row_tag, uint8_t* row_head,
    int32_t* tlong, int hlog_long,
    uint8_t* out, int64_t out_cap)
{
    return compress_frame_core(base, start, end, window_size, block_size,
                               0, 8, 0, 0, strategy, reps, NULL,
                               out, out_cap,
                               1, row_log, width_log, row_mls,
                               max_attempts, defer,
                               row_pos, row_tag, row_head, tlong, hlog_long);
}
