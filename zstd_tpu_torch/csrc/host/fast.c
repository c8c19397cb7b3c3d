/* Fast-class greedy matchfinder (levels 1-2 and --fast).
 *
 * Role of ZSTD_compressBlock_fast (zstd's lib/compress/
 * zstd_fast.c:192): single hash table, greedy commit, repcode-0 probe one
 * byte ahead, backward extension into the literal run, and miss-driven
 * step acceleration. Written fresh for the zstd_tpu sequence contract
 * (ll/ob/mb arrays, off_base = spec Offset_Value, persistent table of
 * absolute positions shared across a frame's blocks).
 *
 * Copy of native/fast.c, the double-fast half included.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

static inline uint32_t rd32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}

static inline uint64_t rd64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

static inline uint32_t hash_mls(const uint8_t* p, int mls, int hash_log) {
    /* multiplicative hash of the low `mls` bytes of an 8-byte load */
    uint64_t v = rd64(p);
    if (mls < 8) v &= (((uint64_t)1 << (8 * mls)) - 1);
    return (uint32_t)((v * 0xCF1BBCDCBB586158ULL) >> (64 - hash_log));
}

static inline int64_t ext_fwd(const uint8_t* a, const uint8_t* b,
                              const uint8_t* alim) {
    const uint8_t* a0 = a;
    while (a + 8 <= alim) {
        uint64_t x = rd64(a) ^ rd64(b);
        if (x) return (a - a0) + (__builtin_ctzll(x) >> 3);
        a += 8; b += 8;
    }
    while (a < alim && *a == *b) { a++; b++; }
    return a - a0;
}

/* Index [start, end) — a dictionary or window prefix — into the fast
 * 2-way bucket table so the first blocks can match into it
 * (ZSTD_fillHashTable role, zstd_fast.c:13-60: the reference also keeps
 * only the most recent positions per hash). */
void zt_fast_fill(const uint8_t* base, int64_t start, int64_t end,
                  int hash_log, int mls, int32_t* table)
{
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    for (int64_t j = start; j + 8 <= end; j++) {
        uint32_t h = hash_mls(base + j, mls, hash_log);
        table[2 * h + 1] = table[2 * h];
        table[2 * h] = (int32_t)j;
    }
}

/* Same for the double-fast long (8-byte) + short (5-byte) tables
 * (ZSTD_fillDoubleHashTable role, zstd_double_fast.c:13-75). */
void zt_dfast_fill(const uint8_t* base, int64_t start, int64_t end,
                   int hlog_long, int hlog_short,
                   int32_t* table_long, int32_t* table_short)
{
    for (int64_t j = start; j + 8 <= end; j++) {
        uint32_t hl = hash_mls(base + j, 8, hlog_long);
        uint32_t hs = hash_mls(base + j, 5, hlog_short);
        table_long[2 * hl + 1] = table_long[2 * hl];
        table_long[2 * hl] = (int32_t)j;
        table_short[2 * hs + 1] = table_short[2 * hs];
        table_short[2 * hs] = (int32_t)j;
    }
}

int64_t zt_fast_parse(const uint8_t* base, int64_t window_low,
                      int64_t block_start, int64_t block_end,
                      uint32_t* reps,
                      int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                      int64_t seq_cap,
                      int hash_log, int accel_log, int mls, int step0,
                      int32_t* table)
{
    int64_t n = block_end - block_start;
    if (n < 16) return 0;
    if (accel_log < 4) accel_log = 4;
    if (mls < 4) mls = 4;
    if (mls > 8) mls = 8;
    if (step0 < 1) step0 = 1;

    int64_t ip = block_start;
    int64_t anchor = ip;
    int64_t rep0 = reps[0], rep1 = reps[1], rep2 = reps[2];
    int64_t k = 0;

    while (ip < block_end - 12 && k < seq_cap) {
        /* 2-way bucket: newest at 2h, previous at 2h+1 */
        uint32_t h = hash_mls(base + ip, mls, hash_log);
        int64_t c0 = table[2 * h], c1 = table[2 * h + 1];
        table[2 * h + 1] = (int32_t)c0;
        table[2 * h] = (int32_t)ip;

        /* repcode probes at ip (needs pending literals so Offset_Value 1/2
           keep their simple meaning) and one ahead (the fast-class staple) */
        int64_t rstart = -1, rml = 0, rcode = 0;
        if (rep0 > 0) {
            if (ip > anchor && ip - rep0 >= window_low
                && rd32(base + ip) == rd32(base + ip - rep0)) {
                rstart = ip;
                rcode = 1;
                rml = 4 + ext_fwd(base + ip + 4, base + ip - rep0 + 4,
                                  base + block_end);
            } else if (ip + 1 - rep0 >= window_low && ip + 1 < block_end - 12
                       && rd32(base + ip + 1) == rd32(base + ip + 1 - rep0)) {
                rstart = ip + 1;
                rcode = 1;
                rml = 4 + ext_fwd(base + ip + 5, base + ip + 1 - rep0 + 4,
                                  base + block_end);
            } else if (ip + 2 - rep0 >= window_low && ip + 2 < block_end - 12
                       && rd32(base + ip + 2) == rd32(base + ip + 2 - rep0)) {
                rstart = ip + 2;
                rcode = 1;
                rml = 4 + ext_fwd(base + ip + 6, base + ip + 2 - rep0 + 4,
                                  base + block_end);
            }
        }
        if (rep1 > 0 && rml == 0 && ip > anchor && ip - rep1 >= window_low
            && rd32(base + ip) == rd32(base + ip - rep1)) {
            rstart = ip;
            rcode = 2;
            rml = 4 + ext_fwd(base + ip + 4, base + ip - rep1 + 4,
                              base + block_end);
        }
        /* table probes: longer of the two bucket entries */
        int64_t tsrc = -1, tml = 0;
        uint32_t cur4 = rd32(base + ip);
        for (int w = 0; w < 2; w++) {
            int64_t cand = (w == 0) ? c0 : c1;
            if (cand >= window_low && cand >= 0 && cand < ip
                && rd32(base + cand) == cur4) {
                int64_t l = 4 + ext_fwd(base + ip + 4, base + cand + 4,
                                        base + block_end);
                if (l > tml) { tml = l; tsrc = cand; }
            }
        }

        int64_t mstart, msrc, ml;
        int is_rep;
        int take_rep = 0;
        if (rml > 0) {
            if (tsrc < 0) take_rep = 1;
            else {
                /* price-aware: a new offset must pay its ~highbit(off)
                   extra header bits with ~3 bits/byte of extra length */
                int hb = 63 - __builtin_clzll((uint64_t)(ip - tsrc) | 1);
                take_rep = (3 * (tml - rml) <= hb + 1);
            }
        }
        if (take_rep) {
            mstart = rstart;
            msrc = rstart - (rcode == 1 ? rep0 : rep1);
            ml = rml;
            is_rep = (int)rcode;
        } else if (tml > 0) {
            /* one-step lazy deferral: if ip+1 starts a clearly longer
               match, take the byte as a literal and re-probe there */
            if (ip + 1 < block_end - 12) {
                uint32_t hn = hash_mls(base + ip + 1, mls, hash_log);
                uint32_t nxt4 = rd32(base + ip + 1);
                int64_t best2 = 0;
                for (int w = 0; w < 2; w++) {
                    int64_t cand = table[2 * hn + w];
                    if (cand >= window_low && cand >= 0 && cand <= ip
                        && rd32(base + cand) == nxt4) {
                        int64_t l = 4 + ext_fwd(base + ip + 5,
                                                base + cand + 4,
                                                base + block_end);
                        if (l > best2) best2 = l;
                    }
                }
                if (best2 > tml + 1) { ip += 1; continue; }
            }
            mstart = ip; msrc = tsrc; ml = tml; is_rep = 0;
            while (mstart > anchor && msrc > window_low
                   && base[mstart - 1] == base[msrc - 1]) {
                mstart--; msrc--; ml++;
            }
        } else {
            ip += step0 + ((ip - anchor) >> accel_log);
            continue;
        }

        int64_t off = mstart - msrc;
        ll_out[k] = (int32_t)(mstart - anchor);
        mb_out[k] = (int32_t)(ml - 3);
        if (is_rep == 1) {
            ob_out[k] = 1;                     /* rep0, literals >= 1 */
        } else if (is_rep == 2) {
            ob_out[k] = 2;                     /* rep1: history swaps */
            int64_t t = rep0; rep0 = rep1; rep1 = t;
        } else {
            ob_out[k] = (int32_t)(off + 3);
            rep2 = rep1; rep1 = rep0; rep0 = off;
        }
        k++;
        ip = mstart + ml;
        anchor = ip;
        /* seed the table inside the skipped span so later probes can land
           mid-match (denser than the reference's end-2/start+1 pair: the
           2-way buckets keep older entries reachable, so extra inserts
           buy discovery instead of evicting it) */
        if (ip < block_end - 12) {
            /* full-density seeding for short/medium matches: every
               interior position enters its bucket, so the table is the
               dense prev-same-bucket structure (the numpy oracle's
               candidate model). Long matches seed at a widening stride
               instead: dense seeding inside a long match floods every
               bucket with period-local entries, and on periodic data the
               NEXT search then only ever finds the short period again —
               keeping older entries alive is what lets the parse escape
               to the long period (a 12880-period rotation corpus went
               595x -> whole-period matches with this; zstd_fast gets the
               same effect from its sparse end-2/start+1 insertion). */
            int64_t stride = 1 + (ml >> 9);
            for (int64_t j = mstart + 1; j < ip; j += stride) {
                uint32_t hj = hash_mls(base + j, mls, hash_log);
                table[2 * hj + 1] = table[2 * hj];
                table[2 * hj] = (int32_t)j;
            }
        }
        /* zero-literal rep continuation (zstd_fast.c match-end staple):
           ll==0 Offset_Value 1 decodes as rep1 and swaps the history */
        while (ip < block_end - 12 && k < seq_cap && rep1 > 0
               && ip - rep1 >= window_low
               && rd32(base + ip) == rd32(base + ip - rep1)) {
            int64_t l = 4 + ext_fwd(base + ip + 4, base + ip - rep1 + 4,
                                    base + block_end);
            ll_out[k] = 0;
            ob_out[k] = 1;
            mb_out[k] = (int32_t)(l - 3);
            k++;
            int64_t t = rep0; rep0 = rep1; rep1 = t;
            uint32_t hr = hash_mls(base + ip, mls, hash_log);
            table[2 * hr + 1] = table[2 * hr];
            table[2 * hr] = (int32_t)ip;
            ip += l;
            anchor = ip;
        }
    }
    reps[0] = (uint32_t)rep0;
    reps[1] = (uint32_t)rep1;
    reps[2] = (uint32_t)rep2;
    return k;
}

/* Double-fast greedy (levels 3-4; zstd_double_fast.c role): a long-hash
 * (8-byte) table finds far/long matches cheaply, a short-hash (5-byte)
 * table catches the rest; a short hit defers to a longer long-table hit
 * one position ahead (the reference's "search long at ip+1" tactic).
 * Both tables are 2-way buckets persistent across a frame's blocks.
 */

static inline void tab_push(int32_t* t, uint32_t h, int64_t pos) {
    t[2 * h + 1] = t[2 * h];
    t[2 * h] = (int32_t)pos;
}

static inline int64_t probe_long(const uint8_t* base, const int32_t* tl,
                                 uint32_t h, int64_t ip, int64_t window_low,
                                 int64_t block_end, int64_t* src) {
    int64_t best = 0;
    uint64_t cur8 = rd64(base + ip);
    for (int w = 0; w < 2; w++) {
        int64_t cand = tl[2 * h + w];
        if (cand >= window_low && cand >= 0 && cand < ip
            && rd64(base + cand) == cur8) {
            int64_t l = 8 + ext_fwd(base + ip + 8, base + cand + 8,
                                    base + block_end);
            if (l > best) { best = l; *src = cand; }
        }
    }
    return best;
}

int64_t zt_dfast_parse(const uint8_t* base, int64_t window_low,
                       int64_t block_start, int64_t block_end,
                       uint32_t* reps,
                       int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                       int64_t seq_cap,
                       int hlog_long, int hlog_short, int accel_log,
                       int32_t* table_long, int32_t* table_short)
{
    int64_t n = block_end - block_start;
    if (n < 16) return 0;
    if (accel_log < 4) accel_log = 4;

    int64_t ip = block_start;
    int64_t anchor = ip;
    int64_t rep0 = reps[0], rep1 = reps[1], rep2 = reps[2];
    int64_t k = 0;

    while (ip < block_end - 16 && k < seq_cap) {
        uint32_t hl = hash_mls(base + ip, 8, hlog_long);
        uint32_t hs = hash_mls(base + ip, 5, hlog_short);
        int64_t lsrc = -1, ssrc = -1;
        int64_t lml = probe_long(base, table_long, hl, ip, window_low,
                                 block_end, &lsrc);
        tab_push(table_long, hl, ip);

        /* repcode probes (same shape as the fast class) */
        int64_t rstart = -1, rml = 0, rcode = 0;
        if (rep0 > 0) {
            if (ip > anchor && ip - rep0 >= window_low
                && rd32(base + ip) == rd32(base + ip - rep0)) {
                rstart = ip; rcode = 1;
                rml = 4 + ext_fwd(base + ip + 4, base + ip - rep0 + 4,
                                  base + block_end);
            } else if (ip + 1 - rep0 >= window_low && ip + 1 < block_end - 16
                       && rd32(base + ip + 1) == rd32(base + ip + 1 - rep0)) {
                rstart = ip + 1; rcode = 1;
                rml = 4 + ext_fwd(base + ip + 5, base + ip + 1 - rep0 + 4,
                                  base + block_end);
            }
        }
        if (rep1 > 0 && rml == 0 && ip > anchor && ip - rep1 >= window_low
            && rd32(base + ip) == rd32(base + ip - rep1)) {
            rstart = ip; rcode = 2;
            rml = 4 + ext_fwd(base + ip + 4, base + ip - rep1 + 4,
                              base + block_end);
        }

        int64_t sml = 0;
        {
            uint32_t cur4 = rd32(base + ip);
            for (int w = 0; w < 2; w++) {
                int64_t cand = table_short[2 * hs + w];
                if (cand >= window_low && cand >= 0 && cand < ip
                    && rd32(base + cand) == cur4) {
                    int64_t l = 4 + ext_fwd(base + ip + 4, base + cand + 4,
                                            base + block_end);
                    if (l > sml) { sml = l; ssrc = cand; }
                }
            }
        }
        tab_push(table_short, hs, ip);

        int64_t mstart, msrc, ml;
        int is_rep = 0;
        /* longer wins; the long table wins ties (usually farther back but
           found through an 8-byte anchor, so its tail extends further) */
        int64_t tml = lml >= sml ? lml : sml;
        int64_t tsrc = lml >= sml ? lsrc : ssrc;
        if (lml == 0) { tml = sml; tsrc = ssrc; }
        int take_rep = 0;
        if (rml > 0) {
            if (tsrc < 0) take_rep = 1;
            else {
                /* price-aware: a new offset must pay its ~highbit(off)
                   extra header bits with ~3 bits/byte of extra length */
                int hb = 63 - __builtin_clzll((uint64_t)(ip - tsrc) | 1);
                take_rep = (3 * (tml - rml) <= hb + 1);
            }
        }
        if (take_rep) {
            mstart = rstart;
            msrc = rstart - (rcode == 1 ? rep0 : rep1);
            ml = rml;
            is_rep = (int)rcode;
        } else if (tml > 0) {
            /* defer to a longer match one position ahead (either table) */
            if (ip + 1 < block_end - 16) {
                uint32_t hn = hash_mls(base + ip + 1, 8, hlog_long);
                int64_t nsrc = -1;
                int64_t nml = probe_long(base, table_long, hn, ip + 1,
                                         window_low, block_end, &nsrc);
                if (nml <= tml + 1) {
                    uint32_t hsn = hash_mls(base + ip + 1, 5, hlog_short);
                    uint32_t nxt4 = rd32(base + ip + 1);
                    for (int w = 0; w < 2; w++) {
                        int64_t cand = table_short[2 * hsn + w];
                        if (cand >= window_low && cand >= 0 && cand <= ip
                            && rd32(base + cand) == nxt4) {
                            int64_t l = 4 + ext_fwd(base + ip + 5,
                                                    base + cand + 4,
                                                    base + block_end);
                            if (l > nml) nml = l;
                        }
                    }
                }
                if (nml > tml + 1) { ip += 1; continue; }
            }
            mstart = ip; msrc = tsrc; ml = tml;
            while (mstart > anchor && msrc > window_low
                   && base[mstart - 1] == base[msrc - 1]) {
                mstart--; msrc--; ml++;
            }
        } else {
            ip += 1 + ((ip - anchor) >> accel_log);
            continue;
        }

        int64_t off = mstart - msrc;
        ll_out[k] = (int32_t)(mstart - anchor);
        mb_out[k] = (int32_t)(ml - 3);
        if (is_rep == 1) {
            ob_out[k] = 1;
        } else if (is_rep == 2) {
            ob_out[k] = 2;
            int64_t t = rep0; rep0 = rep1; rep1 = t;
        } else {
            ob_out[k] = (int32_t)(off + 3);
            rep2 = rep1; rep1 = rep0; rep0 = off;
        }
        k++;
        ip = mstart + ml;
        anchor = ip;
        if (ip < block_end - 16) {
            int64_t stop = ip - 2;
            int ins = 0;
            for (int64_t j = mstart + 1; j <= stop && ins < 16; j += 2, ins++) {
                tab_push(table_long, hash_mls(base + j, 8, hlog_long), j);
                tab_push(table_short, hash_mls(base + j, 5, hlog_short), j);
            }
            if (stop > mstart) {
                tab_push(table_long, hash_mls(base + stop, 8, hlog_long), stop);
                tab_push(table_short, hash_mls(base + stop, 5, hlog_short),
                         stop);
            }
        }
    }
    reps[0] = (uint32_t)rep0;
    reps[1] = (uint32_t)rep1;
    reps[2] = (uint32_t)rep2;
    return k;
}
