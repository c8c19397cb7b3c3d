/* Hash-chain lazy matchfinder (mid levels; greedy/lazy/lazy2 strategies).
 *
 * Role of ZSTD_compressBlock_greedy/lazy/lazy2 (zstd's lib/
 * compress/zstd_lazy.c): a hash head table plus a position-indexed chain
 * table give depth-bounded candidate search at every position; a 0-2 step
 * lazy deferral re-searches one byte ahead and commits the start with the
 * better priced parse. Written fresh for the zstd_tpu sequence contract
 * (ll/ob/mb arrays, off_base = spec Offset_Value, persistent tables of
 * absolute positions shared across a frame's blocks).
 *
 * Pricing: value(new off) = 4*ml - highbit(off), value(rep) = 4*ml + 1;
 * a deferred start must beat the committed one by >3 (the re-searched
 * byte costs a literal). These are the classic lazy-parse trade weights;
 * constants tuned on the pinned 8 MB corpus against the reference sizes.
 *
 * Copy of native/lazy.c.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

static inline uint32_t lz_rd32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}

static inline uint64_t lz_rd64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

static inline uint32_t lz_hash(const uint8_t* p, int mls, int hash_log) {
    uint64_t v = lz_rd64(p);
    if (mls < 8) v &= (((uint64_t)1 << (8 * mls)) - 1);
    return (uint32_t)((v * 0xCF1BBCDCBB586158ULL) >> (64 - hash_log));
}

static inline int64_t lz_ext(const uint8_t* a, const uint8_t* b,
                             const uint8_t* alim) {
    const uint8_t* a0 = a;
    while (a + 8 <= alim) {
        uint64_t x = lz_rd64(a) ^ lz_rd64(b);
        if (x) return (a - a0) + (__builtin_ctzll(x) >> 3);
        a += 8; b += 8;
    }
    while (a < alim && *a == *b) { a++; b++; }
    return a - a0;
}

static inline int lz_highbit(uint64_t v) {
    return 63 - __builtin_clzll(v | 1);
}

typedef struct {
    const uint8_t* base;
    int32_t* head;          /* [1<<hash_log] newest pos per hash, -1 empty */
    int32_t* chain;         /* [1<<chain_log] prev pos with same hash */
    uint32_t chain_mask;
    int hash_log;
    int mls;
    int64_t window_low;
    int64_t block_end;
    /* optional far-reach table: the chain table's modular indexing caps
       its reach at chain_size positions; this 2-way bucket of 8-byte
       hashes keeps absolute positions, so long matches far back in the
       window — and into a dictionary prefix — stay findable (the role
       dfast's long table plays for the reference's dict fast paths) */
    int32_t* tlong;         /* [2<<hlog_long] 2-way buckets, -1 empty */
    int hlog_long;
    /* optional undo log of a logged parse: one entry a table write, its
       index from head (head, chain and tlong lie in one buffer, in that
       order) << 32 | the value it overwrote */
    uint64_t* log;
    int64_t nlog;
} LzCtx;

#define LZ_INLINE static inline __attribute__((always_inline))

LZ_INLINE void lz_log(LzCtx* c, const int32_t* slot) {
    c->log[c->nlog++] = ((uint64_t)(slot - c->head) << 32)
                        | (uint32_t)*slot;
}

/* `logged` is a constant at every call: the unlogged parse and fill
   compile without the log */
LZ_INLINE void lz_insert_at(LzCtx* c, int64_t pos, const int logged) {
    uint32_t h = lz_hash(c->base + pos, c->mls, c->hash_log);
    int32_t* slot = &c->chain[pos & c->chain_mask];
    if (logged) { lz_log(c, slot); lz_log(c, &c->head[h]); }
    *slot = c->head[h];
    c->head[h] = (int32_t)pos;
    if (c->tlong) {
        uint32_t hl = lz_hash(c->base + pos, 8, c->hlog_long);
        if (logged) { lz_log(c, &c->tlong[2 * hl + 1]);
                      lz_log(c, &c->tlong[2 * hl]); }
        c->tlong[2 * hl + 1] = c->tlong[2 * hl];
        c->tlong[2 * hl] = (int32_t)pos;
    }
}

static inline void lz_insert(LzCtx* c, int64_t pos) {
    lz_insert_at(c, pos, 0);
}

/* far candidates via the 8-byte bucket table; same contract as
 * lz_search (no insert, >=8 on hit since the hash pins 8 bytes). */
static int64_t lz_search_long(LzCtx* c, int64_t ip, int64_t* src_out) {
    if (!c->tlong) return 0;
    uint32_t h = lz_hash(c->base + ip, 8, c->hlog_long);
    uint64_t cur8 = lz_rd64(c->base + ip);
    int64_t best = 0, bsrc = -1;
    for (int w = 0; w < 2; w++) {
        int64_t cand = c->tlong[2 * h + w];
        if (cand >= c->window_low && cand >= 0 && cand < ip
            && lz_rd64(c->base + cand) == cur8) {
            int64_t l = 8 + lz_ext(c->base + ip + 8, c->base + cand + 8,
                                   c->base + c->block_end);
            if (l > best) { best = l; bsrc = cand; }
        }
    }
    *src_out = bsrc;
    return best;
}

/* Depth-bounded chain walk; returns best length (>=4) and its source.
 * Does NOT insert ip (callers insert exactly once per position). */
static int64_t lz_search(LzCtx* c, int64_t ip, int depth, int64_t* src_out) {
    uint32_t h = lz_hash(c->base + ip, c->mls, c->hash_log);
    int64_t cand = c->head[h];
    int64_t best = 0, bsrc = -1;
    uint32_t cur4 = lz_rd32(c->base + ip);
    int64_t low = c->window_low;
    /* chain entries older than the chain table's reach are stale slots
       reused by newer positions; the position test rejects them */
    int64_t reach = ip - (int64_t)c->chain_mask - 1;
    if (low < reach) low = reach;
    for (int d = 0; d < depth && cand >= low && cand < ip; d++) {
        if (lz_rd32(c->base + cand) == cur4) {
            int64_t l = 4 + lz_ext(c->base + ip + 4, c->base + cand + 4,
                                   c->base + c->block_end);
            /* best PRICED candidate (same rule as native/row.c): +1
             * length must pay for <= 4 extra offset bits, else the
             * nearer candidate wins — selecting by raw length drifts
             * the offset distribution up on word-like text */
            if (4 * l - lz_highbit((uint64_t)(ip - cand))
                > 4 * best - (bsrc >= 0 ? lz_highbit((uint64_t)(ip - bsrc))
                                        : 1000)) {
                best = l; bsrc = cand;
            }
        }
        cand = c->chain[cand & c->chain_mask];
    }
    *src_out = bsrc;
    return best;
}

/* Index a prefix range (dictionary content / window history) into the
 * head+chain tables so the parse can match into it (ZSTD_insertAndFill /
 * dictMatchState-loading role). */
void zt_lazy_fill(const uint8_t* base, int64_t from, int64_t to,
                  int hash_log, int chain_log, int mls,
                  int32_t* head_table, int32_t* chain_table)
{
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    LzCtx c = { base, head_table, chain_table,
                (uint32_t)((1u << chain_log) - 1), hash_log, mls,
                0, to, NULL, 0 };
    for (int64_t j = from; j + 8 <= to; j++) lz_insert(&c, j);
}

/* fill only the far-reach long table over a prefix range */
void zt_lazy_fill_long(const uint8_t* base, int64_t from, int64_t to,
                       int hlog_long, int32_t* table_long)
{
    for (int64_t j = from; j + 8 <= to; j++) {
        uint32_t hl = (uint32_t)((lz_rd64(base + j)
                                  * 0xCF1BBCDCBB586158ULL)
                                 >> (64 - hlog_long));
        table_long[2 * hl + 1] = table_long[2 * hl];
        table_long[2 * hl] = (int32_t)j;
    }
}

/* The parse loop of one block (or gap) [block_start, block_end) over the
 * tables of c; reps (int64[3]) in and out. With `logged`, every table
 * write goes to c->log first (zt_lazy_parse_logged). */
LZ_INLINE int64_t lz_parse(LzCtx* c, int64_t block_start, int64_t block_end,
                           int64_t* reps,
                           int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                           int64_t seq_cap, int depth, int defer,
                           int accel_log, const int logged)
{
    if (block_end - block_start < 16) return 0;
    const uint8_t* base = c->base;
    int64_t window_low = c->window_low;
    int64_t ip = block_start;
    int64_t anchor = ip;
    int64_t rep0 = reps[0], rep1 = reps[1], rep2 = reps[2];
    int64_t k = 0;
    int64_t ilimit = block_end - 16;

    while (ip < ilimit && k < seq_cap) {
        /* candidate at ip: best of rep probe and chain search */
        int64_t msrc = -1, ml = 0, val = -1000;
        int rcode = 0;
        if (ip > anchor) {
            if (rep0 > 0 && ip - rep0 >= window_low
                && lz_rd32(base + ip) == lz_rd32(base + ip - rep0)) {
                ml = 4 + lz_ext(base + ip + 4, base + ip - rep0 + 4,
                                base + block_end);
                msrc = ip - rep0; rcode = 1;
                val = 4 * ml + 1;
            }
            if (rep1 > 0 && ip - rep1 >= window_low
                && lz_rd32(base + ip) == lz_rd32(base + ip - rep1)) {
                int64_t l = 4 + lz_ext(base + ip + 4, base + ip - rep1 + 4,
                                       base + block_end);
                if (4 * l + 1 > val) {
                    ml = l; msrc = ip - rep1; rcode = 2; val = 4 * l + 1;
                }
            }
        }
        {
            int64_t csrc = -1;
            int64_t cl = lz_search(c, ip, depth, &csrc);
            if (cl >= 4) {
                int64_t v = 4 * cl - lz_highbit((uint64_t)(ip - csrc));
                if (v > val) { ml = cl; msrc = csrc; rcode = 0; val = v; }
            }
            int64_t fsrc = -1;
            int64_t fl = lz_search_long(c, ip, &fsrc);
            if (fl >= 8) {
                int64_t v = 4 * fl - lz_highbit((uint64_t)(ip - fsrc));
                if (v > val) { ml = fl; msrc = fsrc; rcode = 0; val = v; }
            }
        }
        lz_insert_at(c, ip, logged);
        if (ml < 4) {
            ip += 1 + ((ip - anchor) >> accel_log);
            continue;
        }

        /* lazy deferral: re-price one byte ahead up to `defer` times */
        int64_t mstart = ip;
        int steps = 0;
        while (steps < defer && ip + 1 < ilimit) {
            int64_t nip = ip + 1;
            int64_t nsrc = -1, nml = 0, nval = val + 3;  /* must clear by >3 */
            int nrcode = 0;
            if (rep0 > 0 && nip - rep0 >= window_low
                && lz_rd32(base + nip) == lz_rd32(base + nip - rep0)) {
                int64_t l = 4 + lz_ext(base + nip + 4, base + nip - rep0 + 4,
                                       base + block_end);
                if (4 * l + 1 > nval) {
                    nml = l; nsrc = nip - rep0; nrcode = 1; nval = 4 * l + 1;
                }
            }
            {
                int64_t csrc = -1;
                int64_t cl = lz_search(c, nip, depth, &csrc);
                if (cl >= 4) {
                    int64_t v = 4 * cl - lz_highbit((uint64_t)(nip - csrc));
                    if (v > nval) { nml = cl; nsrc = csrc; nrcode = 0; nval = v; }
                }
                int64_t fsrc = -1;
                int64_t fl = lz_search_long(c, nip, &fsrc);
                if (fl >= 8) {
                    int64_t v = 4 * fl - lz_highbit((uint64_t)(nip - fsrc));
                    if (v > nval) { nml = fl; nsrc = fsrc; nrcode = 0; nval = v; }
                }
            }
            if (nml < 4) break;
            /* take the better start: the skipped byte joins the literals */
            lz_insert_at(c, nip, logged);
            ip = nip; mstart = nip; msrc = nsrc; ml = nml; rcode = nrcode;
            val = nval - 3;
            steps++;
        }

        /* backward extension into the pending literal run; a rep match
           must keep >=1 literal or Offset_Value 1/2 change meaning
           (RFC 8878 ll==0 repcode shift) */
        int64_t bk_floor = rcode ? anchor + 1 : anchor;
        while (mstart > bk_floor && msrc > window_low
               && base[mstart - 1] == base[msrc - 1]) {
            mstart--; msrc--; ml++;
        }

        int64_t off = mstart - msrc;
        ll_out[k] = (int32_t)(mstart - anchor);
        mb_out[k] = (int32_t)(ml - 3);
        if (rcode == 1 && off == rep0) {
            ob_out[k] = 1;
        } else if (rcode == 2 && off == rep1) {
            ob_out[k] = 2;
            int64_t t = rep0; rep0 = rep1; rep1 = t;
        } else {
            ob_out[k] = (int32_t)(off + 3);
            rep2 = rep1; rep1 = rep0; rep0 = off;
        }
        k++;
        int64_t next = mstart + ml;
        /* index every interior position: chain quality is what the lazy
           class buys its ratio with (head+chain make this O(1) each) */
        int64_t stop = next < ilimit ? next : ilimit;
        for (int64_t j = ip + 1; j < stop; j++) lz_insert_at(c, j, logged);
        ip = next;
        anchor = next;
        /* zero-literal rep continuation (zstd_lazy.c match-end staple):
           with ll==0 the spec's Offset_Value 1 decodes as rep1 and swaps
           the history, so matches against rep1 at the fresh anchor cost
           ~1 bit of offset */
        while (ip < ilimit && k < seq_cap && rep1 > 0
               && ip - rep1 >= window_low
               && lz_rd32(base + ip) == lz_rd32(base + ip - rep1)) {
            int64_t l = 4 + lz_ext(base + ip + 4, base + ip - rep1 + 4,
                                   base + block_end);
            ll_out[k] = 0;
            ob_out[k] = 1;          /* ll==0: Offset_Value 1 -> rep1 */
            mb_out[k] = (int32_t)(l - 3);
            k++;
            int64_t t = rep0; rep0 = rep1; rep1 = t;
            int64_t e = ip + l;
            int64_t s2 = e < ilimit ? e : ilimit;
            for (int64_t j = ip; j < s2; j++) lz_insert_at(c, j, logged);
            ip = e;
            anchor = e;
        }
    }
    reps[0] = rep0;
    reps[1] = rep1;
    reps[2] = rep2;
    return k;
}

int64_t zt_lazy_parse(const uint8_t* base, int64_t window_low,
                      int64_t block_start, int64_t block_end,
                      uint32_t* reps,
                      int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                      int64_t seq_cap,
                      int hash_log, int chain_log, int mls,
                      int depth, int defer, int accel_log,
                      int32_t* head_table, int32_t* chain_table,
                      int32_t* table_long, int hlog_long)
{
    if (block_end - block_start < 16) return 0;
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    if (depth < 1) depth = 1;
    if (accel_log < 4) accel_log = 4;

    LzCtx c = { base, head_table, chain_table,
                (uint32_t)((1u << chain_log) - 1), hash_log, mls,
                window_low, block_end, table_long, hlog_long, NULL, 0 };
    int64_t r[3] = { reps[0], reps[1], reps[2] };
    int64_t k = lz_parse(&c, block_start, block_end, r, ll_out, ob_out,
                         mb_out, seq_cap, depth, defer, accel_log, 0);
    reps[0] = (uint32_t)r[0];
    reps[1] = (uint32_t)r[1];
    reps[2] = (uint32_t)r[2];
    return k;
}

/* zt_lazy_parse with every table write logged (csrc/host/ldm.c's gap
 * parse): head_table, chain_table and table_long lie in one buffer, in
 * that order; log holds at least 4 entries a position of the block;
 * *nlog is set to the entries written. reps int64[3], in and out.
 * zt_lazy_undo plays the log back. */
int64_t zt_lazy_parse_logged(const uint8_t* base, int64_t window_low,
                             int64_t block_start, int64_t block_end,
                             int64_t* reps,
                             int32_t* ll_out, int32_t* ob_out,
                             int32_t* mb_out, int64_t seq_cap,
                             int hash_log, int chain_log, int mls,
                             int depth, int defer, int accel_log,
                             int32_t* head_table, int32_t* chain_table,
                             int32_t* table_long, int hlog_long,
                             uint64_t* log, int64_t* nlog)
{
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    if (depth < 1) depth = 1;
    if (accel_log < 4) accel_log = 4;
    LzCtx c = { base, head_table, chain_table,
                (uint32_t)((1u << chain_log) - 1), hash_log, mls,
                window_low, block_end, table_long, hlog_long, log, 0 };
    int64_t k = lz_parse(&c, block_start, block_end, reps, ll_out, ob_out,
                         mb_out, seq_cap, depth, defer, accel_log, 1);
    *nlog = c.nlog;
    return k;
}

/* Put back, newest first, the table entries that a logged parse
 * overwrote: the tables are again what they were before it. */
void zt_lazy_undo(int32_t* head_table, const uint64_t* log, int64_t nlog)
{
    for (int64_t i = nlog - 1; i >= 0; i--)
        head_table[log[i] >> 32] = (int32_t)(uint32_t)log[i];
}
