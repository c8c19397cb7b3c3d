/* Row-based matchfinder (mid levels 5-12; greedy/lazy/lazy2 strategies).
 *
 * Role of ZSTD_RowFindBestMatch (zstd's lib/compress/
 * zstd_lazy.c:986): the hash table is organized as rows of 16/32
 * position slots, each slot paired with a 1-byte tag (extra hash bits).
 * A search loads the whole row's tags, compares them against the probe
 * tag in two/four 64-bit SWAR ops, and only the (few) tag-equal slots
 * get a real match extension — giving chain-depth-256 quality at
 * hash-probe cost. Insertion is one cyclic slot write, no chains.
 *
 * Written fresh for the zstd_tpu sequence contract (ll/ob/mb arrays,
 * off_base = spec Offset_Value, persistent absolute-position tables
 * shared across a frame's blocks). The parse skeleton (rep probes, lazy
 * deferral, backward extension, zero-literal rep staple) matches
 * native/lazy.c's pricing: value(new off) = 4*ml - highbit(off),
 * value(rep) = 4*ml + 1, deferral must clear by >3.
 *
 * Copy of native/row.c, with ZT_ROW_FLOOR frozen at its default.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stdlib.h>
#include <stddef.h>
#include <string.h>

static inline uint32_t row_rd32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}

static inline uint64_t row_rd64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

static inline int64_t row_ext(const uint8_t* a, const uint8_t* b,
                              const uint8_t* alim) {
    const uint8_t* a0 = a;
    while (a + 8 <= alim) {
        uint64_t x = row_rd64(a) ^ row_rd64(b);
        if (x) return (a - a0) + (__builtin_ctzll(x) >> 3);
        a += 8; b += 8;
    }
    while (a < alim && *a == *b) { a++; b++; }
    return a - a0;
}

static inline int row_highbit(uint64_t v) {
    return 63 - __builtin_clzll(v | 1);
}

/* full 64-bit hash product; row index and tag slice off the top */
static inline uint64_t row_hash(const uint8_t* p, int mls) {
    uint64_t v = row_rd64(p);
    if (mls < 8) v &= (((uint64_t)1 << (8 * mls)) - 1);
    return v * 0xCF1BBCDCBB586158ULL;
}

typedef struct {
    const uint8_t* base;
    int32_t* pos;            /* [rows << width_log] absolute positions, -1 */
    uint8_t* tag;            /* [rows << width_log] 1-byte tags */
    uint8_t* head;           /* [rows] cyclic insert cursor */
    int row_log;             /* log2(number of rows) */
    int width_log;           /* 4/5/6 (16/32/64 slots) */
    int mls;
    int64_t window_low;
    int64_t block_end;
    /* optional far-reach table (same role as native/lazy.c's tlong):
       2-way buckets of 8-byte-hash absolute positions; long matches far
       back in the window survive the rows' per-bucket LRU eviction */
    int32_t* tlong;
    int hlog_long;
} RowCtx;

static inline void row_split(const RowCtx* c, const uint8_t* p,
                             uint64_t* row_out, uint8_t* tag_out) {
    uint64_t h = row_hash(p, c->mls);
    *row_out = h >> (64 - c->row_log);
    *tag_out = (uint8_t)(h >> (64 - c->row_log - 8));
}

static inline void row_insert(RowCtx* c, int64_t ip) {
    uint64_t row; uint8_t tag;
    row_split(c, c->base + ip, &row, &tag);
    uint32_t width = 1u << c->width_log;
    uint8_t hd = (uint8_t)((c->head[row] - 1) & (width - 1));
    c->head[row] = hd;
    int64_t slot = ((int64_t)row << c->width_log) + hd;
    c->pos[slot] = (int32_t)ip;
    c->tag[slot] = tag;
    if (c->tlong) {
        uint32_t hl = (uint32_t)((row_rd64(c->base + ip)
                                  * 0xCF1BBCDCBB586158ULL)
                                 >> (64 - c->hlog_long));
        c->tlong[2 * hl + 1] = c->tlong[2 * hl];
        c->tlong[2 * hl] = (int32_t)ip;
    }
}

/* far candidates via the 8-byte bucket table; >= 8 on hit since the
 * hash pins 8 bytes (no insert; same contract as row_search). */
static int64_t row_search_long(const RowCtx* c, int64_t ip,
                               int64_t* src_out) {
    if (!c->tlong) { *src_out = -1; return 0; }
    uint32_t h = (uint32_t)((row_rd64(c->base + ip)
                             * 0xCF1BBCDCBB586158ULL)
                            >> (64 - c->hlog_long));
    uint64_t cur8 = row_rd64(c->base + ip);
    int64_t best = 0, bsrc = -1;
    for (int w = 0; w < 2; w++) {
        int64_t cand = c->tlong[2 * h + w];
        if (cand >= c->window_low && cand >= 0 && cand < ip
            && row_rd64(c->base + cand) == cur8) {
            int64_t l = 8 + row_ext(c->base + ip + 8, c->base + cand + 8,
                                    c->base + c->block_end);
            if (l > best) { best = l; bsrc = cand; }
        }
    }
    *src_out = bsrc;
    return best;
}

/* SWAR tag match: bitmask of slots whose tag equals `tag` (bit k = slot
 * k). Equality per byte via the classic zero-byte detector on t ^ tag. */
static inline uint64_t row_tagmask(const uint8_t* tags, int width,
                                   uint8_t tag) {
    uint64_t pat = 0x0101010101010101ULL * tag;
    uint64_t m = 0;
    for (int g = 0; g < width; g += 8) {
        uint64_t t;
        memcpy(&t, tags + g, 8);
        uint64_t x = t ^ pat;
        uint64_t z = (x - 0x0101010101010101ULL) & ~x
                     & 0x8080808080808080ULL;
        /* compress the per-byte high bits to 8 mask bits */
        uint64_t mb = (z * 0x0002040810204081ULL) >> 56;
        m |= mb << g;
    }
    return m;
}

/* Best row match at ip: scans tag-equal slots newest-first, extends up
 * to max_attempts of them, returns best length (>= 4) + source. Does
 * NOT insert (callers insert exactly once per position). */
static int64_t row_search(const RowCtx* c, int64_t ip, int max_attempts,
                          int64_t* src_out) {
    uint64_t row; uint8_t tag;
    row_split(c, c->base + ip, &row, &tag);
    int width = 1 << c->width_log;
    const uint8_t* tags = c->tag + ((int64_t)row << c->width_log);
    const int32_t* poss = c->pos + ((int64_t)row << c->width_log);
    uint64_t mask = row_tagmask(tags, width, tag);
    if (!mask) { *src_out = -1; return 0; }
    uint8_t hd = c->head[row];
    /* rotate so bit 0 = newest slot (head); hd==0 handled apart since a
     * shift by `width` (64) would be undefined */
    uint64_t wmask = (width == 64) ? ~(uint64_t)0
                                   : (((uint64_t)1 << width) - 1);
    uint64_t rot = hd ? (((mask >> hd) | (mask << (width - hd))) & wmask)
                      : mask;
    uint32_t cur4 = row_rd32(c->base + ip);
    int64_t best = 0, bsrc = -1;
    int att = 0;
    while (rot && att < max_attempts) {
        int r = __builtin_ctzll(rot);
        rot &= rot - 1;
        int slot = (r + hd) & (width - 1);
        int64_t cand = poss[slot];
        if (cand < c->window_low || cand >= ip) continue;
        att++;
        if (row_rd32(c->base + cand) != cur4) continue;
        int64_t l = 4 + row_ext(c->base + ip + 4, c->base + cand + 4,
                                c->base + c->block_end);
        /* keep the best PRICED candidate, not the longest: a +1 length
         * gain must pay for <= 4 extra offset bits, otherwise the nearer
         * (newer) candidate wins. Selecting by raw length drifted the
         * offset distribution up ~0.4 bits/seq on word-like text (+2.6%
         * vs reference at L9); pricing inside the search closed it. */
        if (4 * l - row_highbit((uint64_t)(ip - cand))
            > 4 * best - (bsrc >= 0 ? row_highbit((uint64_t)(ip - bsrc))
                                    : 1000)) {
            best = l; bsrc = cand;
        }
    }
    *src_out = bsrc;
    return best;
}

/* Index a prefix range (dictionary content / window history) into the
 * row tables (ZSTD_row_update / dictMatchState-loading role). */
void zt_row_fill(const uint8_t* base, int64_t from, int64_t to,
                 int row_log, int width_log, int mls,
                 int32_t* pos_table, uint8_t* tag_table,
                 uint8_t* head_table, int32_t* table_long, int hlog_long)
{
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    RowCtx c = { base, pos_table, tag_table, head_table,
                 row_log, width_log, mls, 0, to, table_long, hlog_long };
    for (int64_t j = from; j + 8 <= to; j++) row_insert(&c, j);
}

/* ZT_ROW_FLOOR of native/row.c, frozen at its default */
static const int g_row_floor = -1000000;

int64_t zt_row_parse(const uint8_t* base, int64_t window_low,
                     int64_t block_start, int64_t block_end,
                     uint32_t* reps,
                     int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                     int64_t seq_cap,
                     int row_log, int width_log, int mls,
                     int max_attempts, int defer, int accel_log,
                     int32_t* pos_table, uint8_t* tag_table,
                     uint8_t* head_table, int32_t* table_long,
                     int hlog_long)
{
    int64_t n = block_end - block_start;
    if (n < 16) return 0;
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    if (max_attempts < 1) max_attempts = 1;
    if (accel_log < 4) accel_log = 4;

    RowCtx c = { base, pos_table, tag_table, head_table,
                 row_log, width_log, mls, window_low, block_end,
                 table_long, hlog_long };

    int64_t ip = block_start;
    int64_t anchor = ip;
    int64_t rep0 = reps[0], rep1 = reps[1], rep2 = reps[2];
    int64_t k = 0;
    int64_t ilimit = block_end - 16;

    while (ip < ilimit && k < seq_cap) {
        /* candidate at ip: best of rep probes and row search. Fresh
           matches must reach mls (the level's minMatch): the reference's
           mls-byte hash structurally never surfaces shorter ones, and
           accepting 4-byte matches at mls>=5 levels loses ~1-3% on
           word-like text (rep probes stay 4-byte — reps are ~free). */
        int64_t msrc = -1, ml = 0, val = -1000;
        int rcode = 0;
        if (ip > anchor) {
            if (rep0 > 0 && ip - rep0 >= window_low
                && row_rd32(base + ip) == row_rd32(base + ip - rep0)) {
                ml = 4 + row_ext(base + ip + 4, base + ip - rep0 + 4,
                                 base + block_end);
                msrc = ip - rep0; rcode = 1;
                val = 4 * ml + 1;
            }
            if (rep1 > 0 && ip - rep1 >= window_low
                && row_rd32(base + ip) == row_rd32(base + ip - rep1)) {
                int64_t l = 4 + row_ext(base + ip + 4, base + ip - rep1 + 4,
                                        base + block_end);
                if (4 * l + 1 > val) {
                    ml = l; msrc = ip - rep1; rcode = 2; val = 4 * l + 1;
                }
            }
        }
        {
            int64_t csrc = -1;
            int64_t cl = row_search(&c, ip, max_attempts, &csrc);
            if (cl >= mls) {
                int64_t v = 4 * cl - row_highbit((uint64_t)(ip - csrc));
                if (v > val && v >= g_row_floor) { ml = cl; msrc = csrc; rcode = 0; val = v; }
            }
            int64_t fsrc = -1;
            int64_t fl = row_search_long(&c, ip, &fsrc);
            if (fl >= 8) {
                int64_t v = 4 * fl - row_highbit((uint64_t)(ip - fsrc));
                if (v > val) { ml = fl; msrc = fsrc; rcode = 0; val = v; }
            }
        }
        row_insert(&c, ip);
        if (ml < 4) {
            ip += 1 + ((ip - anchor) >> accel_log);
            continue;
        }

        /* lazy deferral: re-price one byte ahead up to `defer` times */
        int64_t mstart = ip;
        int steps = 0;
        while (steps < defer && ip + 1 < ilimit) {
            int64_t nip = ip + 1;
            int64_t nsrc = -1, nml = 0, nval = val + 3;  /* clear by >3 */
            int nrcode = 0;
            if (rep0 > 0 && nip - rep0 >= window_low
                && row_rd32(base + nip) == row_rd32(base + nip - rep0)) {
                int64_t l = 4 + row_ext(base + nip + 4,
                                        base + nip - rep0 + 4,
                                        base + block_end);
                if (4 * l + 1 > nval) {
                    nml = l; nsrc = nip - rep0; nrcode = 1; nval = 4 * l + 1;
                }
            }
            {
                int64_t csrc = -1;
                int64_t cl = row_search(&c, nip, max_attempts, &csrc);
                if (cl >= mls) {
                    int64_t v = 4 * cl - row_highbit((uint64_t)(nip - csrc));
                    if (v > nval && v >= g_row_floor) {
                        nml = cl; nsrc = csrc; nrcode = 0; nval = v;
                    }
                }
                int64_t fsrc = -1;
                int64_t fl = row_search_long(&c, nip, &fsrc);
                if (fl >= 8) {
                    int64_t v = 4 * fl - row_highbit((uint64_t)(nip - fsrc));
                    if (v > nval) {
                        nml = fl; nsrc = fsrc; nrcode = 0; nval = v;
                    }
                }
            }
            if (nml < 4) break;
            /* take the better start: the skipped byte joins the literals */
            row_insert(&c, nip);
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
        /* index every interior position (one cyclic write each — this is
           where the row design wins its speed back vs chains) */
        int64_t stop = next < ilimit ? next : ilimit;
        for (int64_t j = ip + 1; j < stop; j++) row_insert(&c, j);
        ip = next;
        anchor = next;
        /* zero-literal rep continuation (zstd_lazy.c match-end staple) */
        while (ip < ilimit && k < seq_cap && rep1 > 0
               && ip - rep1 >= window_low
               && row_rd32(base + ip) == row_rd32(base + ip - rep1)) {
            int64_t l = 4 + row_ext(base + ip + 4, base + ip - rep1 + 4,
                                    base + block_end);
            ll_out[k] = 0;
            ob_out[k] = 1;          /* ll==0: Offset_Value 1 -> rep1 */
            mb_out[k] = (int32_t)(l - 3);
            k++;
            int64_t t = rep0; rep0 = rep1; rep1 = t;
            int64_t e = ip + l;
            int64_t s2 = e < ilimit ? e : ilimit;
            for (int64_t j = ip; j < s2; j++) row_insert(&c, j);
            ip = e;
            anchor = e;
        }
    }
    reps[0] = (uint32_t)rep0;
    reps[1] = (uint32_t)rep1;
    reps[2] = (uint32_t)rep2;
    return k;
}
