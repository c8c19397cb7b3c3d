/* Optimal-parse sequence extraction (btopt/btultra class, levels 13-22).
 *
 * Same *role* as the reference's zstd_opt.c (price-model DP over block
 * positions; zstd's lib/compress/zstd_opt.c
 * ZSTD_compressBlock_opt_generic, ZSTD_getMatchPrice:324,
 * ZSTD_insertBtAndGetAllMatches:590) but written fresh to this repo's
 * conventions:
 *
 *  - ONE adaptive pass per block: the DP runs over a bounded horizon
 *    ("chunk") that extends as matches reach further; when the horizon
 *    stalls, the chunk is committed, the code histograms absorb the
 *    emitted sequences, and prices refresh — statistics adapt WITHIN the
 *    block instead of via whole-block re-parses.
 *  - A rolling-buffer suffix binary tree (bt[2*(pos & btMask)]) is the
 *    matchfinder for the bt strategies: one walk per position both
 *    inserts and collects an increasing-length candidate set.
 *    Anti-quadratic behaviors mirror the reference (zstd_opt.c:716,:816,
 *    :555): positions covered by a found match are skipped for insertion
 *    (nextToUpdate = matchEndIdx - 8), long best-matches skip insertion
 *    forward, and ordering comparisons cap at the block end with a
 *    drop-on-equality rule so the persistent tree stays consistent.
 *  - sufficient_len (targetLength) early-accept: a long-enough match
 *    commits immediately instead of pricing every cut of it.
 *
 * Price accounting: cell price accumulates literal prices plus incremental
 * literal-length-code deltas (llp(run+1)-llp(run)); a match step adds
 * llp(0) (the code-base term the deltas telescope from) + offset-code +
 * match-length-code prices. Trailing literals after the last sequence
 * carry no LL cost, matching the format.
 *
 * This is host-native on purpose: the DP is byte-serial and branchy — the
 * one part of the encoder that does not map to the TPU vector units — while
 * the level 1-12 paths run as batched device kernels.
 *
 * Copy of native/opt.c. Its ZT_OPT_* environment knobs are frozen
 * at their defaults, and the twopass override is per thread (see below).
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MINMATCH 3
#define PINF ((int64_t)1 << 60)
#define SCALE 256            /* price unit: 1/256 bit (BITCOST role) */
#define OPT_CELLS 4096       /* DP horizon per chunk (ZSTD_OPT_NUM role) */
#define MAX_BT_CAND (OPT_CELLS)     /* staircase lengths strictly increase
                                       and cap at sufficient_len < OPT_CELLS,
                                       so this never saturates */
#define MAX_CAND (MAX_BT_CAND + 4)   /* + 3 reps + hash3 probe */
#define HASH3_LOG 16
#define LITFREQ_ADD 2        /* literal stats weight (ZSTD_LITFREQ_ADD) */

/* tuning knobs, frozen at the defaults of native/opt.c's ZT_OPT_* reads:
 * ZT_OPT_NODES_MULT 1, ZT_OPT_BIAS SCALE/5, ZT_OPT_SUFF 0, ZT_OPT_TWOPASS 2,
 * ZT_OPT_NOSKIP 0, ZT_OPT_SKIPMIN 1, ZT_OPT_SKIPCAP 16, ZT_OPT_L67 2, and no
 * debug position (ZT_OPT_SKIPMIN is read by nothing there) */
static const int g_nodes_mult = 1, g_bias = SCALE / 5, g_suff = 0;
static const int g_twopass = 2, g_noskip = 0, g_skipcap = 16;
static void code_tabs_init(void);
/* pricing mode for the btopt strategies (6-7): the reference prices btopt
 * in whole bits for decode-speed bias (zstd_opt.c opt0); fractional pricing
 * measures smaller outputs here, so it is the default */
static int opt_level_67(void) { return 2; }

/* explicit twopass override (small-input seeding portfolio of
 * format/codec.compress); v = -1 restores the default. Thread-local, where
 * native/opt.c's is process-global: pzstd's thread executor encodes chunks
 * on several threads at once, and one chunk's portfolio must not switch
 * another chunk's seeding mode mid-frame. A single-threaded caller sees
 * the same values as with the global. */
static _Thread_local int g_twopass_forced = -2;
void zt_opt_knob_twopass(int v) { g_twopass_forced = v; }

static void read_knobs(void) {
    code_tabs_init();
}

/* ---- format code tables (RFC 8878 sequence codes) ---- */

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

static inline uint32_t highbit(uint32_t v) { return 31 - __builtin_clz(v); }

static inline uint32_t ml_code_exact(uint32_t mlb) { /* mlb = len - 3 */
    if (mlb <= 31) return mlb;
    uint32_t lo = 32, hi = 52, l = mlb + 3;
    while (lo < hi) {
        uint32_t mid = (lo + hi + 1) >> 1;
        if (ML_BASE[mid] <= l) lo = mid; else hi = mid - 1;
    }
    return lo;
}

static inline uint32_t ll_code_exact(uint32_t ll) {
    if (ll <= 15) return ll;
    uint32_t lo = 16, hi = 35;
    while (lo < hi) {
        uint32_t mid = (lo + hi + 1) >> 1;
        if (LL_BASE[mid] <= ll) lo = mid; else hi = mid - 1;
    }
    return lo;
}

/* O(1) code maps (ZSTD_MLcode/ZSTD_LLcode bit-trick role): small values
 * via a direct table, large ones via highbit + delta. Lazily built from
 * the exact binary-search versions above; idempotent (safe if raced). */
static uint8_t ML_CODE_TAB[128], LL_CODE_TAB[64];
static int g_code_tabs = 0;
static void code_tabs_init(void) {
    if (g_code_tabs) return;
    for (uint32_t i = 0; i < 128; i++) ML_CODE_TAB[i] = (uint8_t)ml_code_exact(i);
    for (uint32_t i = 0; i < 64; i++) LL_CODE_TAB[i] = (uint8_t)ll_code_exact(i);
    g_code_tabs = 1;
}
static inline uint32_t ml_code(uint32_t mlb) {
    return mlb < 128 ? ML_CODE_TAB[mlb] : highbit(mlb) + 36;
}
static inline uint32_t ll_code(uint32_t ll) {
    return ll < 64 ? LL_CODE_TAB[ll] : highbit(ll) + 19;
}

/* ---- price model ----
 *
 * Reference-parity price dynamics (zstd_opt.c:40-385): a symbol's price is
 * WEIGHT(sum) - WEIGHT(freq[sym]) ~ log2(sum/freq) in 1/256-bit units,
 * where WEIGHT is the linear-interpolated log2 (ZSTD_fracWeight) for the
 * ultra strategies and whole bits (ZSTD_bitWeight) for btopt. Statistics
 * update per EMITTED sequence (ZSTD_updateStats: literals weigh double)
 * and prices refresh after each emission series (ZSTD_setBasePrices) —
 * so between refreshes prices are static, and across a block codes get
 * CHEAPER as they are used: the positive feedback that teaches the parse
 * the block's own sequence grammar. Cached price arrays below are exact:
 * frequencies only change at emission time, never mid-series. */

typedef struct {
    uint32_t lit[256], llc[36], mlc[53], ofc[32];
    uint32_t lit_tot, ll_tot, ml_tot, of_tot;
    int64_t lit_price[256], ll_price[36], ml_price[53], of_price[32];
    int opt_level;           /* 0 = btopt pricing, 2 = btultra pricing */
} Prices;

/* fractional-bit weight of a frequency (ZSTD_fracWeight) */
static inline uint32_t fw(uint32_t stat) {
    uint32_t s = stat + 1;
    uint32_t hb = highbit(s);
    return hb * SCALE + ((s << 8) >> hb);
}

/* whole-bit weight (ZSTD_bitWeight; btopt favors decode speed over
 * fractional accuracy) */
static inline uint32_t bw(uint32_t stat) {
    return highbit(stat + 1) * SCALE;
}

static void prices_rebuild(Prices* P) {
    int frac = (P->opt_level >= 1);
    uint32_t lit_base = frac ? fw(P->lit_tot) : bw(P->lit_tot);
    /* every literal costs at least ~1 bit however frequent (litPriceMax
     * clamp, zstd_opt.c:281-286) */
    uint32_t lit_pmax = lit_base > SCALE ? lit_base - SCALE : 0;
    for (int i = 0; i < 256; i++) {
        uint32_t w = frac ? fw(P->lit[i]) : bw(P->lit[i]);
        if (w > lit_pmax) w = lit_pmax;
        P->lit_price[i] = (int64_t)(lit_base - w);
    }
    uint32_t ll_base = frac ? fw(P->ll_tot) : bw(P->ll_tot);
    for (int i = 0; i < 36; i++) {
        uint32_t w = frac ? fw(P->llc[i]) : bw(P->llc[i]);
        int64_t p = (int64_t)ll_base - (int64_t)w;
        P->ll_price[i] = p + (int64_t)SCALE * LL_BITS[i];
    }
    uint32_t ml_base = frac ? fw(P->ml_tot) : bw(P->ml_tot);
    for (int i = 0; i < 53; i++) {
        uint32_t w = frac ? fw(P->mlc[i]) : bw(P->mlc[i]);
        int64_t p = (int64_t)ml_base - (int64_t)w;
        P->ml_price[i] = p + (int64_t)SCALE * ML_BITS[i];
    }
    uint32_t of_base = frac ? fw(P->of_tot) : bw(P->of_tot);
    for (int i = 0; i < 32; i++) {
        uint32_t w = frac ? fw(P->ofc[i]) : bw(P->ofc[i]);
        int64_t p = (int64_t)of_base - (int64_t)w;
        p += (int64_t)SCALE * i;    /* ofCode == nb extra bits */
        /* btopt handicaps long offsets to favor decode cache locality
         * (zstd_opt.c:341-342) */
        if (!frac && i >= 20) p += (int64_t)(i - 19) * 2 * SCALE;
        P->of_price[i] = p;
    }
}

/* halve-ish one histogram down to <= 2^log_target total, reviving zero
 * entries to 1 (ZSTD_scaleStats/ZSTD_downscaleStats base_1guaranteed:
 * codes unused last block stay reachable this block) */
static uint32_t scale_stats(uint32_t* f, int n, int log_target) {
    uint64_t sum = 0;
    for (int i = 0; i < n; i++) sum += f[i];
    uint64_t factor = sum >> log_target;
    if (factor <= 1) {
        uint32_t t = 0;
        for (int i = 0; i < n; i++) t += f[i];
        return t;
    }
    int shift = highbit((uint32_t)factor);
    uint32_t t = 0;
    for (int i = 0; i < n; i++) {
        f[i] = 1 + (f[i] >> shift);
        t += f[i];
    }
    return t;
}

/* decay toward recent history at block entry (ZSTD_rescaleFreqs role) */
static void prices_halve(Prices* P) {
    P->lit_tot = scale_stats(P->lit, 256, 12);
    P->ll_tot = scale_stats(P->llc, 36, 11);
    P->ml_tot = scale_stats(P->mlc, 53, 11);
    P->of_tot = scale_stats(P->ofc, 32, 11);
}

static inline int64_t llp(const Prices* P, uint32_t ll) {
    return P->ll_price[ll_code(ll)];
}

/* ---- LCP ---- */

static inline int64_t lcp(const uint8_t* a, const uint8_t* b, int64_t limit) {
    int64_t n = 0;
    while (n + 8 <= limit) {
        uint64_t xa, xb;
        memcpy(&xa, a + n, 8);
        memcpy(&xb, b + n, 8);
        uint64_t x = xa ^ xb;
        if (x) return n + (__builtin_ctzll(x) >> 3);
        n += 8;
    }
    while (n < limit && a[n] == b[n]) n++;
    return n;
}

static inline uint32_t hash4(const uint8_t* p, int hash_log) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (uint32_t)((uint64_t)v * 2654435761u >> (32 - hash_log)) &
           ((1u << hash_log) - 1);
}

static inline uint32_t hash3(const uint8_t* p) {
    uint32_t v = p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * 506832829u) >> (32 - HASH3_LOG);
}

/* BT bucket hash over the strategy's minimum-match width (ZSTD_hashPtr
 * role: the tree groups suffixes by their first `mls` bytes, so the walk
 * enumerates every match of length >= mls — with mls=3 at the top levels
 * this is what makes the staircase complete down to 3-byte matches). */
static inline uint32_t hash_mls(const uint8_t* p, int mls, int hash_log) {
    if (mls == 3) {
        uint32_t v = p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
        return ((v << 8) * 506832829u) >> (32 - hash_log);
    }
    if (mls == 4) return hash4(p, hash_log);
    uint64_t v;
    memcpy(&v, p, 8);
    v &= (~0ULL) >> (8 * (8 - mls));
    return (uint32_t)((v * 0xCF1BBCDCBB586158ULL) >> (64 - hash_log));
}

typedef struct { uint32_t len; uint32_t ob; } Match;

/* ---- DP cells ---- */

/* A cell is a STRETCH (the reference's ZSTD_optimal_t semantics,
 * zstd_opt.c:1135-1143): a match (ml/ob) followed by `litrun` literals.
 * Storing stretches (not sequences) lets a literal run remember which
 * match preceded it — required by the match+1-literal rescue and the
 * lazy repcode resolution below. ml == 0 only at the chunk head. */
typedef struct {
    int64_t price;
    uint32_t ml;       /* stretch's match length (0 = chunk head) */
    uint32_t ob;       /* offBase of the stretch's match */
    uint32_t litrun;   /* pending literal run after the match */
    uint32_t rep[3];
} Cell;

static inline uint32_t off_base(uint32_t d, uint32_t ll, const uint32_t* rep) {
    if (ll != 0) {
        if (d == rep[0]) return 1;
        if (d == rep[1]) return 2;
        if (d == rep[2]) return 3;
    } else {
        if (d == rep[1]) return 1;
        if (d == rep[2]) return 2;
        if (d == rep[0] - 1 && d > 0) return 3;
    }
    return d + 3;
}

static inline void rep_update(const uint32_t* rep, uint32_t ob, uint32_t ll,
                              uint32_t* out) {
    if (ob > 3) {
        out[0] = ob - 3; out[1] = rep[0]; out[2] = rep[1];
        return;
    }
    uint32_t idx = ob + (ll == 0 ? 1 : 0);
    if (idx == 1) { out[0] = rep[0]; out[1] = rep[1]; out[2] = rep[2]; }
    else if (idx == 2) { out[0] = rep[1]; out[1] = rep[0]; out[2] = rep[2]; }
    else if (idx == 3) { out[0] = rep[2]; out[1] = rep[0]; out[2] = rep[1]; }
    else { out[0] = rep[0] - 1; out[1] = rep[0]; out[2] = rep[1]; }
}

/* ---- persistent match-finder + statistics context ----
 * Matcher state (hash heads, rolling suffix-BT / rolling chain) and the
 * running code histograms persist across the blocks of one frame (role of
 * the reference's ZSTD_matchState_t + optState_t living in the CCtx). */
#define ST_MAX (OPT_CELLS / MINMATCH + 8)

typedef struct {
    int32_t* head;       /* [1<<hash_log] latest position per bucket, -1 */
    int32_t* head3;      /* [1<<HASH3_LOG] latest 3-byte-hash position */
    int32_t* bt;         /* [2<<bt_log] rolling child pairs (bt mode) */
    int32_t* chain;      /* [1<<chain_log] rolling chain (chain mode) */
    Cell* cells;
    int32_t st_ll[ST_MAX], st_ob[ST_MAX], st_ml[ST_MAX];  /* emit stack */
    int hash_log, bt_log, chain_log, use_bt, mls;
    int inited;
    int64_t ins_until;   /* first position not yet inserted (nextToUpdate) */
    int64_t ntu3;        /* hash3 fill cursor (nextToUpdate3) */
    int64_t last_end;    /* previous block_end (detects frame restart) */
    Prices P;
    int has_stats;
    /* borrowed per-block match cache (iterated keep-min re-parses);
     * owned by the caller via zt_opt_mcache_new/free. mc_mode: 0 off,
     * 1 record (pass 1), 2 probe (passes 2+). */
    struct MCache* mc;
    int64_t mc_bs;
    int mc_mode;
} OptCtx;

/* ---- per-block match cache ----
 * The keep-min parse re-runs the SAME block 2-3x with different price
 * seeds; the tree enumeration at a position depends only on (position,
 * repcode state, ll0) — not on prices — so pass 1 records its results
 * and later passes replay them on key match. A hit skips the tree walk
 * AND the insertion (the skipped node never enters the re-parse's tree;
 * later misses therefore search a slightly thinner tree — measured
 * no-op on ratio, ~2x on re-parse speed). Misses fall through to the
 * normal search (the ins_until catch-up re-creates any gap exactly). */
#define MC_WIDTH 12
typedef struct MCache {
    int64_t cap;
    uint32_t* key_rep;   /* [3*cap] */
    uint8_t* key_ll0;    /* [cap]; 0xFF = empty */
    int16_t* nc;         /* [cap]; -2 = uncacheable (overflow) */
    uint16_t* adv;       /* [cap] ins_until advance (pos+adv) */
    Match* m;            /* [cap * MC_WIDTH] */
} MCache;

void* zt_opt_mcache_new(int64_t cap) {
    MCache* c = calloc(1, sizeof(MCache));
    if (!c) return NULL;
    c->cap = cap;
    c->key_rep = malloc(sizeof(uint32_t) * 3 * cap);
    c->key_ll0 = malloc(cap);
    c->nc = malloc(sizeof(int16_t) * cap);
    c->adv = malloc(sizeof(uint16_t) * cap);
    c->m = malloc(sizeof(Match) * MC_WIDTH * cap);
    if (!c->key_rep || !c->key_ll0 || !c->nc || !c->adv || !c->m) {
        free(c->key_rep); free(c->key_ll0); free(c->nc); free(c->adv);
        free(c->m); free(c);
        return NULL;
    }
    return c;
}

void zt_opt_mcache_free(void* v) {
    MCache* c = (MCache*)v;
    if (!c) return;
    free(c->key_rep); free(c->key_ll0); free(c->nc); free(c->adv);
    free(c->m);
    free(c);
}

/* arm ctx's cache for one block parse; mode 1 also clears the entries */
void zt_opt_ctx_set_mcache(void* vctx, void* vmc, int64_t block_start,
                           int64_t block_len, int mode) {
    OptCtx* X = (OptCtx*)vctx;
    MCache* c = (MCache*)vmc;
    if (!c || block_len > c->cap || mode == 0) {
        X->mc = NULL; X->mc_mode = 0; X->mc_bs = -1;
        return;
    }
    X->mc = c;
    X->mc_bs = block_start;
    X->mc_mode = mode;
    if (mode == 1)
        memset(c->key_ll0, 0xFF, (size_t)block_len);
}

void* zt_opt_ctx_new(void) { return calloc(1, sizeof(OptCtx)); }

/* deep-copy matcher tables + statistics from src into dst (the fast
 * "snapshot before block" primitive behind the iterated keep-min parse:
 * one clone per block replaces an O(window) tree rewind+refill).
 * used_hint: highest absolute position inserted so far (the frame cursor);
 * when the rolling bt buffer hasn't wrapped yet only its used prefix is
 * copied. Returns 0, or -1 on allocation failure. */
int zt_opt_ctx_clone(void* dst_v, void* src_v, int64_t used_hint);

/* copy ONLY the running statistics/prices (after pass 1, the snapshot
 * context gets pass-1's histograms so the re-parse prices from them) */
void zt_opt_ctx_copy_prices(void* dst_v, void* src_v);

static void opt_ctx_release(OptCtx* x) {
    free(x->head); free(x->head3); free(x->bt); free(x->chain);
    free(x->cells);
    memset(x, 0, sizeof(*x));
}

void zt_opt_ctx_free(void* v) {
    if (!v) return;
    opt_ctx_release((OptCtx*)v);
    free(v);
}

int zt_opt_ctx_clone(void* dst_v, void* src_v, int64_t used_hint) {
    OptCtx* d = (OptCtx*)dst_v;
    OptCtx* s = (OptCtx*)src_v;
    if (!s->inited) {
        opt_ctx_release(d);
        return 0;
    }
    size_t head_n = (size_t)1 << s->hash_log;
    size_t head3_n = (size_t)1 << HASH3_LOG;
    size_t bt_n = (size_t)2 << s->bt_log;
    if (!d->inited || d->hash_log != s->hash_log || d->bt_log != s->bt_log
        || d->mls != s->mls) {
        opt_ctx_release(d);
        d->hash_log = s->hash_log;
        d->bt_log = s->bt_log;
        d->chain_log = s->chain_log;
        d->use_bt = 1;
        d->mls = s->mls;
        d->head = malloc(head_n * sizeof(int32_t));
        d->head3 = malloc(head3_n * sizeof(int32_t));
        d->cells = malloc(sizeof(Cell) * (OPT_CELLS + 2));
        d->bt = malloc(bt_n * sizeof(int32_t));
        if (!d->head || !d->head3 || !d->cells || !d->bt) return -1;
        memset(d->bt, -1, bt_n * sizeof(int32_t));
        d->inited = 1;
    }
    memcpy(d->head, s->head, head_n * sizeof(int32_t));
    memcpy(d->head3, s->head3, head3_n * sizeof(int32_t));
    {   /* rolling buffer: copy only the used prefix when it hasn't wrapped */
        size_t used = (used_hint > 0 && (uint64_t)2 * used_hint < bt_n)
                          ? (size_t)2 * used_hint + 2 : bt_n;
        memcpy(d->bt, s->bt, used * sizeof(int32_t));
    }
    d->ins_until = s->ins_until;
    d->ntu3 = s->ntu3;
    d->last_end = s->last_end;
    d->P = s->P;
    d->has_stats = s->has_stats;
    return 0;
}

void zt_opt_ctx_copy_prices(void* dst_v, void* src_v) {
    OptCtx* d = (OptCtx*)dst_v;
    OptCtx* s = (OptCtx*)src_v;
    d->P = s->P;
    d->has_stats = s->has_stats;
}

/* ---- rolling-buffer suffix binary tree ----
 *
 * Role of zstd_opt.c:590 ZSTD_insertBtAndGetAllMatches / :442
 * ZSTD_insertBt1: each position hangs in a tree ordered by suffix, rooted
 * at its hash-mls bucket; one walk inserts `pos`, re-hooks the path, and
 * (in search mode) collects candidates with strictly increasing length.
 * Child pairs live in a rolling buffer indexed by (pos & btMask): entries
 * older than pos-btMask are recycled, so the walk links such a candidate
 * but never descends into it. Ordering comparisons cap at `iend` (the
 * block end, as the reference's does); on full equality the candidate is
 * dropped (subtree pruned) — order would be unknowable, and guessing
 * corrupts the persistent tree.
 *
 * Search mode mirrors the reference's enumeration EXACTLY — the optimal
 * parse is a self-reinforcing feedback loop (emitted sequences feed the
 * prices that choose the next sequences), so "improved" candidate sets
 * (suffix-min offsets, extra sub-best candidates) measurably LOSE real
 * bytes versus mirroring: a single cumulative best length runs across
 * repcodes -> hash3 -> tree, each recorded match is strictly longer than
 * everything before it, tree matches always carry offbase dist+3 (never
 * remapped to a repcode), and a sufficient/block-end rep returns before
 * `pos` is even inserted. */

/* insert-only walk (ZSTD_insertBt1 role): hangs `pos`, returns nothing;
 * advances ins_until by the matchEndIdx-8 rule + the long-best skip. */
static void bt_insert(OptCtx* X, const uint8_t* base, int64_t pos,
                      int64_t window_low, int64_t iend, int nodes) {
    uint32_t btmask = (1u << X->bt_log) - 1;
    uint32_t h = hash_mls(base + pos, X->mls, X->hash_log);
    int32_t cur = X->head[h];
    X->head[h] = (int32_t)pos;
    int32_t* p_sm = &X->bt[2 * ((uint32_t)pos & btmask)];
    int32_t* p_lg = p_sm + 1;
    uint32_t len_sm = 0, len_lg = 0;
    int64_t cmp_limit = iend - pos;
    int64_t bt_low = pos - btmask;
    uint32_t lmax = 8;
    int64_t mend = pos + 9;      /* matchEndIdx analog */
    while (cur >= 0 && (int64_t)cur < pos && nodes-- > 0) {
        if ((int64_t)cur < window_low) break;
        int64_t ci2 = 2 * (int64_t)((uint32_t)cur & btmask);
        uint32_t l0 = len_sm < len_lg ? len_sm : len_lg;
        int64_t l = l0 + lcp(base + pos + l0, base + cur + l0,
                             cmp_limit - l0);
        if (l > (int64_t)lmax) lmax = (uint32_t)l;
        if (cur + l > mend) mend = cur + l;
        if (l >= cmp_limit) break;  /* order unknowable: drop candidate */
        if (base[cur + l] < base[pos + l]) {
            int32_t nxt = X->bt[ci2 + 1];
            *p_sm = cur;
            if ((int64_t)cur <= bt_low) { p_sm = NULL; break; }
            p_sm = &X->bt[ci2 + 1];
            len_sm = (uint32_t)l;
            cur = nxt;
        } else {
            int32_t nxt = X->bt[ci2];
            *p_lg = cur;
            if ((int64_t)cur <= bt_low) { p_lg = NULL; break; }
            p_lg = &X->bt[ci2];
            len_lg = (uint32_t)l;
            cur = nxt;
        }
    }
    if (p_sm) *p_sm = -1;
    if (p_lg) *p_lg = -1;
    {
        int64_t fwd = mend - 8 - pos;
        if (lmax > 384) {            /* long-best insert skip */
            int64_t e = lmax - 384;
            if (e > 192) e = 192;
            if (e > fwd) fwd = e;
        }
        if (fwd < 1 || g_noskip) fwd = 1;
        else if (g_skipcap > 0 && fwd > g_skipcap) fwd = g_skipcap;
        if (pos + fwd > X->ins_until) X->ins_until = pos + fwd;
    }
}

/* search walk (ZSTD_insertBtAndGetAllMatches role): repcodes, hash3 head,
 * then the tree; one cumulative best across all three. `out` entries are
 * (len, offbase) with strictly increasing len. */
static int bt_all_matches(OptCtx* X, const uint8_t* base, int64_t pos,
                          int64_t window_low, int64_t iend, int nodes,
                          const uint32_t* rep, uint32_t ll0, uint32_t suff,
                          Match* out) {
    int mm = (X->mls == 3) ? 3 : 4;
    int n = 0;
    uint32_t best = (uint32_t)mm - 1;   /* lengthToBeat - 1 */
    int64_t limit = iend - pos;

    /* repcodes first (zstd_opt.c:646-686): each must beat the previous */
    for (uint32_t r = ll0; r < 3 + ll0; r++) {
        uint32_t d = (r == 3) ? (rep[0] > 1 ? rep[0] - 1 : 0) : rep[r];
        if (d == 0 || pos - (int64_t)d < window_low) continue;
        if (memcmp(base + pos, base + pos - d, mm) != 0) continue;
        uint32_t L = (uint32_t)(mm + lcp(base + pos + mm,
                                         base + pos - d + mm, limit - mm));
        if (L > best) {
            best = L;
            out[n].len = L;
            out[n].ob = r - ll0 + 1;
            n++;
            if (L > suff || (int64_t)L >= limit)
                return n;   /* best possible: pos is NOT inserted */
        }
    }

    /* single-head 3-byte probe (mls==3 only, no rep found, short range) */
    if (mm == 3 && best < 3) {
        while (X->ntu3 < pos) {
            X->head3[hash3(base + X->ntu3)] = (int32_t)X->ntu3;
            X->ntu3++;
        }
        int32_t c3 = X->head3[hash3(base + pos)];
        X->head3[hash3(base + pos)] = (int32_t)pos;
        X->ntu3 = pos + 1;
        if (c3 >= 0 && c3 >= window_low && (int64_t)c3 < pos
            && pos - c3 < (1 << 18)) {
            uint32_t L = (uint32_t)lcp(base + pos, base + c3, limit);
            if (L >= 3) {
                best = L;
                out[0].len = L;
                out[0].ob = (uint32_t)(pos - c3) + 3;
                n = 1;
                if (L > suff || (int64_t)L >= limit) {
                    /* skip inserting pos entirely (zstd_opt.c:716) */
                    if (pos + 1 > X->ins_until) X->ins_until = pos + 1;
                    return 1;
                }
            }
        }
    }

    /* tree walk: insert pos + collect increasing-length candidates */
    uint32_t btmask = (1u << X->bt_log) - 1;
    uint32_t h = hash_mls(base + pos, X->mls, X->hash_log);
    int32_t cur = X->head[h];
    X->head[h] = (int32_t)pos;
    int32_t* p_sm = &X->bt[2 * ((uint32_t)pos & btmask)];
    int32_t* p_lg = p_sm + 1;
    uint32_t len_sm = 0, len_lg = 0;
    int64_t bt_low = pos - btmask;
    int64_t mend = pos + 9;      /* matchEndIdx analog */
    while (cur >= 0 && (int64_t)cur < pos && nodes-- > 0) {
        if ((int64_t)cur < window_low) break;
        int64_t ci2 = 2 * (int64_t)((uint32_t)cur & btmask);
        uint32_t l0 = len_sm < len_lg ? len_sm : len_lg;
        int64_t l = l0 + lcp(base + pos + l0, base + cur + l0, limit - l0);
        if (l > (int64_t)best) {
            best = (uint32_t)l;
            if (cur + l > mend) mend = cur + l;
            if (n < MAX_CAND) {
                out[n].len = (uint32_t)l;
                out[n].ob = (uint32_t)(pos - cur) + 3;
                n++;
            } else {             /* keep the longest when saturated */
                out[n - 1].len = (uint32_t)l;
                out[n - 1].ob = (uint32_t)(pos - cur) + 3;
            }
            if (l >= limit)
                break;           /* reached block end: order unknowable */
        }
        if (l >= limit) break;
        if (base[cur + l] < base[pos + l]) {
            int32_t nxt = X->bt[ci2 + 1];
            *p_sm = cur;
            if ((int64_t)cur <= bt_low) { p_sm = NULL; break; }
            p_sm = &X->bt[ci2 + 1];
            len_sm = (uint32_t)l;
            cur = nxt;
        } else {
            int32_t nxt = X->bt[ci2];
            *p_lg = cur;
            if ((int64_t)cur <= bt_low) { p_lg = NULL; break; }
            p_lg = &X->bt[ci2];
            len_lg = (uint32_t)l;
            cur = nxt;
        }
    }
    if (p_sm) *p_sm = -1;
    if (p_lg) *p_lg = -1;
    {
        int64_t fwd = mend - 8 - pos;
        if (fwd < 1 || g_noskip) fwd = 1;
        else if (g_skipcap > 0 && fwd > g_skipcap) fwd = g_skipcap;
        if (pos + fwd > X->ins_until) X->ins_until = pos + fwd;
    }
    return n;
}

/* ---- context preparation ---- */

static int opt_ctx_ensure(OptCtx* x, const uint8_t* base, int64_t window_low,
                          int64_t block_start, int64_t block_end,
                          int64_t cmp_end,
                          int hash_log, int chain_log, int mls,
                          int nodes) {
    size_t head_n = (size_t)1 << hash_log;
    size_t head3_n = (size_t)1 << HASH3_LOG;
    int bt_log = chain_log - 1;
    if (bt_log < 10) bt_log = 10;
    int fresh = !x->inited || x->hash_log != hash_log || x->mls != mls ||
                x->bt_log != bt_log || block_start < x->last_end;
    if (fresh) {
        opt_ctx_release(x);
        x->hash_log = hash_log;
        x->bt_log = bt_log;
        x->chain_log = chain_log;
        x->use_bt = 1;
        x->mls = mls;
        x->head = malloc(head_n * sizeof(int32_t));
        x->head3 = malloc(head3_n * sizeof(int32_t));
        x->cells = malloc(sizeof(Cell) * (OPT_CELLS + 2));
        x->bt = malloc(((size_t)2 << bt_log) * sizeof(int32_t));
        if (!x->head || !x->head3 || !x->cells || !x->bt)
            return -1;
        memset(x->head, -1, head_n * sizeof(int32_t));
        memset(x->head3, -1, head3_n * sizeof(int32_t));
        memset(x->bt, -1, ((size_t)2 << bt_log) * sizeof(int32_t));
        x->ins_until = window_low;
        x->ntu3 = window_low;
        memset(&x->P, 0, sizeof(x->P));
        x->has_stats = 0;
        x->inited = 1;
    }
    x->last_end = block_end;
    /* catch up: index the window prefix / gap before this block
     * (ZSTD_updateTree fill role; ordering compares reach the current
     * block end, as the reference's iend does) */
    while (x->ntu3 + 3 <= block_start) {
        x->head3[hash3(base + x->ntu3)] = (int32_t)x->ntu3;
        x->ntu3++;
    }
    while (x->ins_until < block_start)
        bt_insert(x, base, x->ins_until, window_low, block_end, nodes);
    /* clamp BOTH directions: the reference's ZSTD_updateTree_internal sets
     * nextToUpdate = target unconditionally, so a long-best catch-up
     * overshoot never turns the block head into a skipped area (that bug
     * cost ~100 leading literal bytes per block in duplicated regions) */
    x->ins_until = block_start;
    return 0;
}

/* frame-start statistics: raw literal histogram of the first block plus
 * baseline code priors (ZSTD_rescaleFreqs first-block init,
 * zstd_opt.c:215-250; the LL/OF prior shapes are the reference's tuned
 * constants, kept for behavioral parity like the level tables) */
static const uint32_t BASE_LL_FREQ[36] = {
    4, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
static const uint32_t BASE_OF_FREQ[32] = {
    6, 2, 1, 1, 2, 3, 4, 4, 4, 3, 2, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

static void seed_baseline(Prices* P, const uint8_t* src, int64_t n) {
    memset(P->lit, 0, sizeof(P->lit));
    for (int64_t i = 0; i < n; i++) P->lit[src[i]]++;
    /* first-block literal downscale: shift 8, zeros stay zero
     * (ZSTD_downscaleStats base_0possible call, zstd_opt.c:246) */
    P->lit_tot = 0;
    for (int i = 0; i < 256; i++) {
        P->lit[i] = (P->lit[i] > 0) + (P->lit[i] >> 8);
        P->lit_tot += P->lit[i];
    }
    memcpy(P->llc, BASE_LL_FREQ, sizeof(P->llc));
    P->ll_tot = 0;
    for (int i = 0; i < 36; i++) P->ll_tot += P->llc[i];
    for (int i = 0; i < 53; i++) P->mlc[i] = 1;
    P->ml_tot = 53;
    memcpy(P->ofc, BASE_OF_FREQ, sizeof(P->ofc));
    P->of_tot = 0;
    for (int i = 0; i < 32; i++) P->of_tot += P->ofc[i];
}

/* greedy seeding pass over the frame head: cheap single-table matcher
 * collecting code histograms so the first chunks price realistically
 * (the btultra2 first-pass idea, ZSTD_initStats_ultra role). Uses its own
 * scratch table — the real matcher state is untouched. */
static void seed_stats(const uint8_t* base, int64_t bs, int64_t be,
                       int64_t window_low, const uint32_t* reps0,
                       Prices* P, int count_lits) {
    enum { SLOG = 15 };
    int32_t* tab = malloc(sizeof(int32_t) << SLOG);
    if (!tab) return;
    memset(tab, -1, sizeof(int32_t) << SLOG);
    uint32_t rep[3] = {reps0[0], reps0[1], reps0[2]};
    int64_t ip = bs, anchor = bs;
    while (ip + 8 < be) {
        uint32_t bl = 0, bd = 0;
        uint32_t d = rep[0];
        if (d && ip - (int64_t)d >= window_low &&
            memcmp(base + ip, base + ip - d, 3) == 0) {
            bl = (uint32_t)(3 + lcp(base + ip + 3, base + ip - d + 3,
                                    be - ip - 3));
            bd = d;
        }
        int32_t cand = tab[hash4(base + ip, SLOG)];
        tab[hash4(base + ip, SLOG)] = (int32_t)ip;
        if (cand >= 0 && cand >= window_low && (int64_t)cand < ip &&
            memcmp(base + ip, base + cand, 4) == 0) {
            uint32_t l = (uint32_t)(4 + lcp(base + ip + 4, base + cand + 4,
                                            be - ip - 4));
            if (l > bl + 1) { bl = l; bd = (uint32_t)(ip - cand); }
        }
        if (bl >= 4) {
            uint32_t ll = (uint32_t)(ip - anchor);
            uint32_t ob = off_base(bd, ll, rep);
            if (count_lits) {
                for (int64_t q = anchor; q < ip; q++) P->lit[base[q]]++;
                P->lit_tot += ll;
            }
            P->llc[ll_code(ll)]++; P->ll_tot++;
            P->mlc[ml_code(bl - MINMATCH)]++; P->ml_tot++;
            P->ofc[highbit(ob)]++; P->of_tot++;
            uint32_t nr[3]; rep_update(rep, ob, ll, nr);
            rep[0] = nr[0]; rep[1] = nr[1]; rep[2] = nr[2];
            ip += bl; anchor = ip;
        } else {
            ip++;
        }
    }
    if (count_lits)
        for (int64_t q = anchor; q < be; q++) { P->lit[base[q]]++; P->lit_tot++; }
    free(tab);
}

/* one sequence: histogram feed (ZSTD_updateStats role — literals weigh
 * LITFREQ_ADD) + output append */
static inline int emit_seq(OptCtx* X, const uint8_t* base, int64_t lit_pos,
                           uint32_t ll, uint32_t ob, uint32_t ml,
                           int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                           int64_t* p_nseq, int64_t seq_cap) {
    if (*p_nseq >= seq_cap) return -1;
    Prices* P = &X->P;
    for (uint32_t q = 0; q < ll; q++)
        P->lit[base[lit_pos + q]] += LITFREQ_ADD;
    P->lit_tot += ll * LITFREQ_ADD;
    P->llc[ll_code(ll)]++; P->ll_tot++;
    P->mlc[ml_code(ml - MINMATCH)]++; P->ml_tot++;
    P->ofc[highbit(ob)]++; P->of_tot++;
    ll_out[*p_nseq] = (int32_t)ll;
    ob_out[*p_nseq] = (int32_t)ob;
    mb_out[*p_nseq] = (int32_t)(ml - MINMATCH);
    (*p_nseq)++;
    return 0;
}

/* ---- chunk emission ----
 * Backtracks stretch cells[0..end_idx] (each = match + literal tail),
 * converts them to sequences (a sequence's LL comes from the stretch
 * BELOW it — the reference's reverse traversal, zstd_opt.c:1380-1420),
 * appends them (plus an optional forced match at end_idx) to the output
 * arrays, and feeds the running histograms. Returns the new absolute
 * anchor (the top stretch's literal tail stays pending), or -1 when the
 * output capacity is exceeded. */
static int64_t emit_path(OptCtx* X, const uint8_t* base, int64_t end_idx,
                         int64_t ip, int64_t anchor,
                         uint32_t force_ml, uint32_t force_ob,
                         int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                         int64_t* p_nseq, int64_t seq_cap) {
    Cell* cells = X->cells;
    int ns = 0;
    int64_t i = end_idx;
    while (cells[i].ml > 0) {          /* walk stretches down to the head */
        X->st_ml[ns] = (int32_t)cells[i].ml;
        X->st_ob[ns] = (int32_t)cells[i].ob;
        X->st_ll[ns] = (int32_t)cells[i].litrun;  /* stretch's literal TAIL */
        ns++;
        i -= (int64_t)cells[i].ml + cells[i].litrun;
    }
    /* cells[i] is now the head stretch; its litrun covers the pre-chunk
     * pending literals plus any in-chunk literals before the first match */
    int64_t pos = anchor;              /* literal cursor (absolute) */
    for (int k = ns - 1; k >= 0; k--) {
        uint32_t ll = (k == ns - 1) ? cells[i].litrun
                                    : (uint32_t)X->st_ll[k + 1];
        if (emit_seq(X, base, pos, ll, (uint32_t)X->st_ob[k],
                     (uint32_t)X->st_ml[k], ll_out, ob_out, mb_out,
                     p_nseq, seq_cap) < 0)
            return -1;
        pos += ll + (uint32_t)X->st_ml[k];
    }
    if (force_ml > 0) {
        uint32_t ll = (uint32_t)((ip + end_idx) - pos);
        if (emit_seq(X, base, pos, ll, force_ob, force_ml,
                     ll_out, ob_out, mb_out, p_nseq, seq_cap) < 0)
            return -1;
        pos = ip + end_idx + force_ml;
    }
    return pos;
}

/* ---- the parser core: one adaptive pass over [block_start, block_end) */

static int64_t opt_core(OptCtx* X,
                        const uint8_t* base, int64_t window_low,
                        int64_t block_start, int64_t block_end,
                        int64_t cmp_end,
                        uint32_t* reps,
                        int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                        int64_t seq_cap,
                        int nodes, uint32_t suff) {
    Prices* P = &X->P;
    Cell* cells = X->cells;
    Match m[MAX_CAND];
    (void)cmp_end;

    int64_t ip = block_start, anchor = block_start;
    int64_t nseq = 0;
    uint32_t cur_rep[3] = {reps[0], reps[1], reps[2]};
    int opt_level = P->opt_level;
    int mm = (X->mls == 3) ? 3 : 4;   /* strategy minimum match length */


    while (ip + 8 < block_end) {   /* ilimit = iend - 8 (zstd_opt.c:1118) */
        /* ---- one DP chunk starting at ip ---- */
        cells[0].price = 0;
        cells[0].ml = 0;
        cells[0].ob = 0;
        cells[0].litrun = (uint32_t)(ip - anchor);
        cells[0].rep[0] = cur_rep[0];
        cells[0].rep[1] = cur_rep[1];
        cells[0].rep[2] = cur_rep[2];
        int64_t hi_init = 0;
        int64_t last_pos = 0;
        int64_t commit_end = -1;
        uint32_t force_ml = 0, force_ob = 0;

        for (int64_t cur = 0; cur <= last_pos; cur++) {
            int64_t pos = ip + cur;
            Cell* c = &cells[cur];
            while (hi_init < cur + 2) {       /* keep cur+1, cur+2 valid */
                hi_init++;
                cells[hi_init].price = PINF;
                cells[hi_init].ml = 0;
                cells[hi_init].litrun = 1;    /* != 0: not an end-of-match */
            }
            if (cur > 0) {
                /* arrived by match? resolve the offset history now that
                 * the cell's winner is final (zstd_opt.c:1248-1256) */
                if (c->litrun == 0 && c->ml > 0) {
                    Cell* src = &cells[cur - c->ml];
                    rep_update(src->rep, c->ob, src->litrun, c->rep);
                }
            }
            /* literal step into cur+1: lit price + LL-code delta; ties
             * prefer the literal (zstd_opt.c:1205 `<=`) */
            if (pos < block_end) {
                uint32_t lr = c->litrun;
                int64_t lp = P->lit_price[base[pos]];
                int64_t np = c->price + lp + (llp(P, lr + 1) - llp(P, lr));
                Cell* t = &cells[cur + 1];
                if (np <= t->price) {
                    Cell prevMatch = *t;
                    *t = *c;
                    t->litrun = lr + 1;
                    t->price = np;
                    /* match + 1 literal rescue (zstd_opt.c:1216-1240):
                     * the literal path just buried a match arrival at
                     * cur+1; if ll=1 is cheaper than ll=0, re-seat that
                     * match at cur+2 followed by one literal — this is
                     * what generates the tight ll=1 stitch patterns the
                     * plain DP never finds. */
                    if (opt_level >= 1 && prevMatch.litrun == 0
                        && prevMatch.ml > 0
                        && llp(P, 1) < llp(P, 0)
                        && pos + 1 < block_end) {
                        int64_t lp1 = P->lit_price[base[pos + 1]];
                        int64_t with1 = prevMatch.price + lp1
                                        + (llp(P, 1) - llp(P, 0));
                        int64_t more = np + lp1
                                       + (llp(P, lr + 2) - llp(P, lr + 1));
                        if (with1 < more && with1 < cells[cur + 2].price) {
                            int64_t prev = (cur + 1) - prevMatch.ml;
                            Cell* t2 = &cells[cur + 2];
                            t2->ml = prevMatch.ml;
                            t2->ob = prevMatch.ob;
                            rep_update(cells[prev].rep, prevMatch.ob,
                                       cells[prev].litrun, t2->rep);
                            t2->litrun = 1;
                            t2->price = with1;
                            if (last_pos < cur + 2) last_pos = cur + 2;
                        }
                    }
                }
            }
            if (pos + 8 > block_end) continue;   /* inr > ilimit */
            /* the frontier cell doesn't extend the series — the next
             * series' head search covers it (zstd_opt.c:1268) */
            if (cur == last_pos && cur > 0) break;
            /* skip unpromising positions at btopt level (~+6% speed for
             * -0.01 ratio, zstd_opt.c:1270-1274) */
            if (opt_level == 0 && cur > 0
                && cells[cur + 1].price <= c->price + SCALE / 2)
                continue;

            /* skipped area: nextToUpdate was advanced past pos by the
             * matchEndIdx-8 / long-best rules — the reference finds NO
             * candidates here at all (ZSTD_btGetAllMatches_internal
             * skipped-area return), not even repcodes */
            if (pos < X->ins_until) continue;

            /* close any insertion gap left by an early-accept jump
             * (ZSTD_updateTree_internal catch-up); an overshoot still
             * searches at pos (updateTree clamps back to the target) */
            int64_t limit = block_end - pos;
            int nc;
            uint32_t ll0_ = (c->litrun == 0);
            int64_t rel_ = (X->mc_mode && pos >= X->mc_bs)
                               ? pos - X->mc_bs : -1;
            MCache* mc_ = X->mc;
            if (X->mc_mode == 2 && rel_ >= 0 && rel_ < mc_->cap
                && mc_->key_ll0[rel_] == (uint8_t)ll0_
                && mc_->nc[rel_] >= 0
                && mc_->key_rep[3 * rel_] == c->rep[0]
                && mc_->key_rep[3 * rel_ + 1] == c->rep[1]
                && mc_->key_rep[3 * rel_ + 2] == c->rep[2]) {
                /* replay pass 1's enumeration: same candidates, same
                 * ins_until evolution; the tree walk and insertion are
                 * skipped entirely */
                nc = mc_->nc[rel_];
                memcpy(m, mc_->m + rel_ * MC_WIDTH, sizeof(Match) * nc);
                if (pos + mc_->adv[rel_] > X->ins_until)
                    X->ins_until = pos + mc_->adv[rel_];
            } else {
                while (X->ins_until < pos)
                    bt_insert(X, base, X->ins_until, window_low, block_end,
                              nodes);
                if (X->ins_until > pos) X->ins_until = pos;
                nc = bt_all_matches(X, base, pos, window_low, block_end,
                                    nodes, c->rep, ll0_, suff, m);
                if (X->mc_mode == 1 && rel_ >= 0 && rel_ < mc_->cap) {
                    if (nc <= MC_WIDTH) {
                        int64_t adv_ = X->ins_until - pos;
                        if (adv_ < 0) adv_ = 0;
                        if (adv_ <= 0xFFFF) {
                            mc_->key_ll0[rel_] = (uint8_t)ll0_;
                            mc_->key_rep[3 * rel_] = c->rep[0];
                            mc_->key_rep[3 * rel_ + 1] = c->rep[1];
                            mc_->key_rep[3 * rel_ + 2] = c->rep[2];
                            mc_->nc[rel_] = (int16_t)nc;
                            mc_->adv[rel_] = (uint16_t)adv_;
                            memcpy(mc_->m + rel_ * MC_WIDTH, m,
                                   sizeof(Match) * nc);
                        }
                    } else {
                        mc_->key_ll0[rel_] = (uint8_t)ll0_;
                        mc_->nc[rel_] = -2;   /* uncacheable: re-search */
                    }
                }
            }
            if (nc == 0) continue;
            uint32_t maxlen = m[nc - 1].len, max_ob = m[nc - 1].ob;

            /* sufficient-length / block-end / horizon-overflow match:
             * commit immediately (zstd_opt.c:1160,:1283 early accepts;
             * the head only tests sufficient_len, :1157) */
            if (maxlen > suff
                || (cur > 0 && ((int64_t)maxlen >= limit
                                || cur + maxlen >= OPT_CELLS - 2))) {
                commit_end = cur; force_ml = maxlen; force_ob = max_ob;
                break;
            }

            /* price each match's length range [prev_len+1 .. len] with its
             * own offset, scanning downward with the btopt early abort
             * (zstd_opt.c:1300-1332) */
            int64_t mbase = c->price + P->ll_price[0] + g_bias;
            for (int k = 0; k < nc; k++) {
                uint32_t ob = m[k].ob;
                int64_t ofp = P->of_price[highbit(ob)];
                uint32_t lastML = m[k].len;
                uint32_t startML = k > 0 ? m[k - 1].len + 1 : (uint32_t)mm;
                for (uint32_t l = lastML; l >= startML; l--) {
                    int64_t p_ = cur + l;
                    int64_t np = mbase + ofp
                                 + P->ml_price[ml_code(l - MINMATCH)];
                    if (p_ > last_pos || np < cells[p_].price) {
                        while (last_pos < p_) {
                            last_pos++;
                            if (hi_init < last_pos) {
                                hi_init = last_pos;
                                cells[last_pos].price = PINF;
                                cells[last_pos].ml = 0;
                                cells[last_pos].litrun = 1;
                            }
                        }
                        Cell* t = &cells[p_];
                        t->price = np;
                        t->ml = l;
                        t->ob = ob;
                        t->litrun = 0;
                        /* offset history resolved lazily at visit time */
                    } else if (opt_level == 0) {
                        break;   /* early update abort (~+10% speed) */
                    }
                }
            }
        }

        /* ---- commit the chunk ---- */
        int64_t end_idx = (commit_end >= 0) ? commit_end : last_pos;
        if (commit_end < 0 && last_pos == 0) { ip++; continue; }
        if (commit_end < 0 && cells[end_idx].litrun == 0
            && cells[end_idx].ml > 0) {
            /* frontier cell may not have been visited: resolve its reps */
            Cell* src = &cells[end_idx - cells[end_idx].ml];
            rep_update(src->rep, cells[end_idx].ob, src->litrun,
                       cells[end_idx].rep);
        }
        int64_t new_anchor = emit_path(X, base, end_idx, ip, anchor,
                                       force_ml, force_ob,
                                       ll_out, ob_out, mb_out,
                                       &nseq, seq_cap);
        if (new_anchor < 0) return -1;
        if (commit_end >= 0) {
            uint32_t nr[3];
            rep_update(cells[end_idx].rep, force_ob, cells[end_idx].litrun,
                       nr);
            cur_rep[0] = nr[0]; cur_rep[1] = nr[1]; cur_rep[2] = nr[2];
            ip = ip + end_idx + force_ml;
        } else {
            cur_rep[0] = cells[end_idx].rep[0];
            cur_rep[1] = cells[end_idx].rep[1];
            cur_rep[2] = cells[end_idx].rep[2];
            ip = ip + end_idx;
        }
        anchor = new_anchor;
        /* refresh prices with the absorbed statistics
         * (ZSTD_setBasePrices after each emission series) */
        prices_rebuild(P);
    }

    /* trailing literals do NOT feed statistics: only emitted sequences
     * count (ZSTD_updateStats is never called on the block tail) */
    reps[0] = cur_rep[0]; reps[1] = cur_rep[1]; reps[2] = cur_rep[2];
    return nseq;
}

/* ---- the parser ---- */

int64_t zt_opt_parse_ctx(void* vctx,
                         const uint8_t* base, int64_t window_low,
                         int64_t block_start, int64_t block_end,
                         int64_t src_end,
                         uint32_t* reps,
                         int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                         int64_t seq_cap,
                         int hash_log, int search_log, int min_match,
                         int target_len, int strategy) {
    if (src_end < block_end) src_end = block_end;
    int64_t n = block_end - block_start;
    if (n < 16) return 0;
    if (strategy <= 5) {
        /* fast/lazy-class strategies only reach the DP via the
         * ZSTD_TPU_HOST_PARSER=dp override, whose contract is "the
         * ratio-maximal route": promote to btultra2-class search params
         * instead of running the DP with a fast-class table */
        strategy = 9;
        if (search_log < 7) search_log = 7;
        if (hash_log < 17) hash_log = 17;
        if (target_len < 256) target_len = 256;
        min_match = 3;
    }
    if (hash_log > 24) hash_log = 24;
    if (hash_log < 12) hash_log = 12;
    int mls = min_match < 3 ? 3 : (min_match > 6 ? 6 : min_match);
    int chain_log = hash_log + 2;         /* bt reach; see btMask */
    if (chain_log > 26) chain_log = 26;
    read_knobs();
    int nodes = g_nodes_mult
        << (search_log < 3 ? 3 : (search_log > 12 ? 12 : search_log));
    uint32_t suff = (uint32_t)(target_len >= 16 ? target_len : 16);
    if (g_suff > 0) suff = (uint32_t)g_suff;
    if (suff > OPT_CELLS - 128) suff = OPT_CELLS - 128;

    OptCtx* X = (OptCtx*)vctx;
    /* the match cache is armed per (ctx, block) by zt_opt_ctx_set_mcache;
     * a stale arming from another block must never be replayed */
    if (X->mc_mode && X->mc_bs != block_start) {
        X->mc_mode = 0;
        X->mc = NULL;
    }
    if (opt_ctx_ensure(X, base, window_low, block_start, block_end,
                       src_end, hash_log, chain_log, mls, nodes) < 0)
        return -1;

    Prices* P = &X->P;
    /* btopt (strategies 6-7) prices in whole bits with a long-offset
     * handicap; btultra/btultra2 (8-9) in fractional bits
     * (ZSTD_compressBlock_opt0/opt2 optLevel split). Strategies <= 5 only
     * reach the DP via the ZSTD_TPU_HOST_PARSER=dp override — give them
     * the accurate fractional pricing. */
    P->opt_level = (strategy == 6 || strategy == 7) ? opt_level_67() : 2;
    int twopass = (g_twopass_forced >= 0) ? g_twopass_forced : g_twopass;
    if (!X->has_stats) {
        if (twopass == 2) {
            int64_t seed_end = block_start + (n < 131072 ? n : 131072);
            seed_stats(base, block_start, seed_end, window_low, reps, P, 1);
        } else {
            seed_baseline(P, base + block_start, n);
        }
        X->has_stats = 1;
        if (twopass && n >= 16384 && strategy >= 6) {
            /* first-block statistics pass: parse the block for real, keep
             * only the histograms, then rewind the matcher and reparse
             * with informed prices (ZSTD_initStats_ultra role — btultra2
             * only, zstd_opt.c:1520-1536) */
            prices_rebuild(P);
            uint32_t reps_a[3] = {reps[0], reps[1], reps[2]};
            (void)opt_core(X, base, window_low, block_start, block_end,
                           src_end, reps_a, ll_out, ob_out, mb_out, seq_cap,
                           nodes, suff);
            memset(X->head, -1, ((size_t)1 << X->hash_log) * sizeof(int32_t));
            memset(X->head3, -1, ((size_t)1 << HASH3_LOG) * sizeof(int32_t));
            memset(X->bt, -1, ((size_t)2 << X->bt_log) * sizeof(int32_t));
            X->ins_until = window_low;
            X->ntu3 = window_low;
            /* re-index any window prefix (dictionary) */
            while (X->ntu3 + 3 <= block_start) {
                X->head3[hash3(base + X->ntu3)] = (int32_t)X->ntu3;
                X->ntu3++;
            }
            while (X->ins_until < block_start)
                bt_insert(X, base, X->ins_until, window_low, block_end,
                          nodes);
            X->ins_until = block_start;   /* updateTree clamp */
            prices_halve(P);   /* pass B rescales pass A's statistics */
        }
    } else {
        prices_halve(P);
    }
    prices_rebuild(P);
    return opt_core(X, base, window_low, block_start, block_end, src_end,
                    reps, ll_out, ob_out, mb_out, seq_cap, nodes, suff);
}

/* single-shot compatibility wrapper (tests / no-ctx callers) */
int64_t zt_opt_parse(const uint8_t* base, int64_t window_low,
                     int64_t block_start, int64_t block_end,
                     uint32_t* reps,
                     int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                     int64_t seq_cap,
                     int hash_log, int search_log, int min_match,
                     int target_len, int strategy) {
    void* x = zt_opt_ctx_new();
    if (!x) return -1;
    int64_t rc = zt_opt_parse_ctx(x, base, window_low, block_start,
                                  block_end, block_end, reps, ll_out,
                                  ob_out, mb_out, seq_cap, hash_log,
                                  search_log, min_match, target_len,
                                  strategy);
    zt_opt_ctx_free(x);
    return rc;
}
