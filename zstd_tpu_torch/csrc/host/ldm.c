/* The long-distance matcher's walk over a block's anchors
 * (parallel/ldm_sharded.py, ShardedLdmState.find_long_matches): for each
 * anchor at or past the cursor, the longest forward match among its
 * candidates inside the window; one of at least min_match bytes is
 * extended backward to the cursor, committed, and moves the cursor to its
 * end. Role of zstd's ZSTD_ldm_generateSequences_internal
 * (lib/compress/zstd_ldm.c) over the discovery's candidate lists.
 *
 * zt_ldm_gap_parse is the parse of the gaps between one block's long matches
 * (format/ldm.find_sequences_ldm at strategies 2-5) in one call: lazy.c's
 * chain-lazy parse over each gap, on the frame's one table set, undone
 * after each gap.
 *
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <string.h>

/* equal bytes of a and b, at most limit */
static int64_t ldm_ext(const uint8_t* a, const uint8_t* b, int64_t limit)
{
    int64_t k = 0;
    while (k + 8 <= limit) {
        uint64_t x, y;
        memcpy(&x, a + k, 8);
        memcpy(&y, b + k, 8);
        if (x != y) return k + (__builtin_ctzll(x ^ y) >> 3);
        k += 8;
    }
    while (k < limit && a[k] == b[k]) k++;
    return k;
}

/* anchors[lo, hi) (int64, ascending) with cands[ai * bucket + b] (int32,
 * -1 empty); writes (pos, length, dist) of each committed match to out
 * (int64[3 * (hi - lo)]) in position order and returns their count. */
int64_t zt_ldm_walk(const uint8_t* full, int64_t n, int64_t block_start,
                    int64_t block_end, const int64_t* anchors,
                    const int32_t* cands, int64_t lo, int64_t hi, int bucket,
                    int64_t window, int64_t min_match, int64_t* out)
{
    int64_t k = 0, cursor = block_start;
    for (int64_t ai = lo; ai < hi; ai++) {
        int64_t p = anchors[ai];
        if (p < cursor) continue;
        int64_t limit = block_end - p < n - p ? block_end - p : n - p;
        int64_t best_len = 0, best_c = -1;
        for (int b = 0; b < bucket; b++) {
            int64_t c = cands[ai * bucket + b];
            if (c < 0 || c >= p || p - c > window) continue;
            int64_t len = ldm_ext(full + p, full + c, limit);
            if (len > best_len) { best_len = len; best_c = c; }
        }
        if (best_len < min_match) continue;
        int64_t s = p, c2 = best_c;
        while (s > cursor && c2 > 0 && full[s - 1] == full[c2 - 1]) {
            s--; c2--; best_len++;
        }
        out[3 * k] = s;
        out[3 * k + 1] = best_len;
        out[3 * k + 2] = s - c2;
        k++;
        cursor = s + best_len;
    }
    return k;
}

/* lazy.c */
void zt_lazy_fill(const uint8_t* base, int64_t from, int64_t to,
                  int hash_log, int chain_log, int mls,
                  int32_t* head_table, int32_t* chain_table);
void zt_lazy_fill_long(const uint8_t* base, int64_t from, int64_t to,
                       int hlog_long, int32_t* table_long);
int64_t zt_lazy_parse_logged(const uint8_t* base, int64_t window_low,
                             int64_t block_start, int64_t block_end,
                             int64_t* reps,
                             int32_t* ll_out, int32_t* ob_out,
                             int32_t* mb_out, int64_t seq_cap,
                             int hash_log, int chain_log, int mls,
                             int depth, int defer, int accel_log,
                             int32_t* head_table, int32_t* chain_table,
                             int32_t* table_long, int hlog_long,
                             uint64_t* log, int64_t* nlog);
void zt_lazy_undo(int32_t* head_table, const uint64_t* log, int64_t nlog);

/* The gaps of the block [block_start, block_end) between its long matches
 * longs (int64[n_longs, 3] rows of (pos, length, dist), in position order)
 * parsed by lazy.c's chain-lazy loop, with the long matches' sequences
 * between them (format/ldm.find_sequences_ldm's per-gap loop, in one call).
 *
 * Each gap [gs, ge) is parsed on `tables` (head 1 << hash_log entries,
 * chain 1 << chain_log, long 2 << hlog_long, one int32 buffer: GapTables.all)
 * as they index [span[0], span[1]), in the window [wl, gs) with
 * wl = max(window_low, gs - inner_window): where span[0] < 0 (new tables),
 * span[0] > wl or span[1] > max(gs - 7, span[0]), the tables are set to -1
 * and the span to [wl, wl); then positions [span[1], gs - 7) are indexed
 * and span[1] = gs - 7; then the parse (accel_log 8, gap / 4 + 16
 * sequences at most, none under 16 B), whose table writes go to `log`
 * and are undone after it. A long
 * match's literal length is the bytes between the gap's last match and it;
 * its offset value and the repeat offsets follow RFC 8878 "Repeat offsets"
 * (lazy._off_base, matchfinder.update_reps). reps int64[3] and span
 * int64[2] in and out.
 *
 * Writes the sequences to ll/ob/mb (seq_cap), the literal bytes to lits
 * (block_end - block_start bytes) and info = (literal bytes, non-empty
 * gaps). Returns the sequence count, or -1, before any write, where the
 * long matches leave the block or overlap, or seq_cap (block / 4 + 17 a
 * gap) or log_cap (4 a byte of the block) is too small. */
int64_t zt_ldm_gap_parse(const uint8_t* full, int64_t block_start,
                         int64_t block_end, int64_t window_low,
                         int64_t inner_window, const int64_t* longs,
                         int64_t n_longs, int64_t* reps,
                         int hash_log, int chain_log, int hlog_long, int mls,
                         int depth, int defer, int32_t* tables, int64_t* span,
                         uint64_t* log, int64_t log_cap,
                         int32_t* ll_out, int32_t* ob_out, int32_t* mb_out,
                         int64_t seq_cap, uint8_t* lits, int64_t* info)
{
    int32_t* head = tables;
    int32_t* chain = head + ((int64_t)1 << hash_log);
    int32_t* tlong = chain + ((int64_t)1 << chain_log);
    size_t size = ((size_t)1 << hash_log) + ((size_t)1 << chain_log)
                  + ((size_t)2 << hlog_long);
    int64_t n = block_end - block_start, gs = block_start;
    for (int64_t i = 0; i < n_longs; i++) {
        if (longs[3 * i] < gs || longs[3 * i + 1] < 3) return -1;
        gs = longs[3 * i] + longs[3 * i + 1];
    }
    if (gs > block_end || log_cap < 4 * n
        || seq_cap < n / 4 + 17 * (n_longs + 1))
        return -1;
    int64_t start = span[0], upto = span[1];
    int64_t k = 0, gaps = 0;
    gs = block_start;
    for (int64_t i = 0; i <= n_longs; i++) {
        int64_t ge = i < n_longs ? longs[3 * i] : block_end;
        int64_t p = gs;         /* the end of the gap's last match */
        if (ge > gs) {
            int64_t wl = gs - inner_window;
            if (wl < window_low) wl = window_low;
            int64_t keep = gs - 7 > start ? gs - 7 : start;
            if (start < 0 || start > wl || upto > keep) {
                memset(tables, 0xff, size * sizeof(int32_t));
                start = upto = wl;
            }
            if (gs - 7 > upto) {
                zt_lazy_fill(full, upto, gs, hash_log, chain_log, mls, head,
                             chain);
                zt_lazy_fill_long(full, upto, gs, hlog_long, tlong);
                upto = gs - 7;
            }
            int64_t nlog = 0;
            int64_t m = zt_lazy_parse_logged(
                full, wl, gs, ge, reps, ll_out + k, ob_out + k, mb_out + k,
                (ge - gs) / 4 + 16, hash_log, chain_log, mls, depth, defer,
                8, head, chain, tlong, hlog_long, log, &nlog);
            zt_lazy_undo(head, log, nlog);
            for (int64_t j = k; j < k + m; j++)
                p += (int64_t)ll_out[j] + mb_out[j] + 3;
            k += m;
            gaps++;
        }
        if (i == n_longs) break;
        int64_t len = longs[3 * i + 1], d = longs[3 * i + 2];
        int64_t ll = ge - p, r1 = reps[0], r2 = reps[1], r3 = reps[2], ob;
        if (ll != 0)
            ob = d == r1 ? 1 : d == r2 ? 2 : d == r3 ? 3 : d + 3;
        else
            ob = d == r2 ? 1 : d == r3 ? 2 : (d == r1 - 1 && d > 0) ? 3
                                                                   : d + 3;
        if (ob > 3) {
            reps[0] = ob - 3; reps[1] = r1; reps[2] = r2;
        } else {
            switch (ob + (ll == 0)) {
            case 2: reps[0] = r2; reps[1] = r1; break;
            case 3: reps[0] = r3; reps[1] = r1; reps[2] = r2; break;
            case 4: reps[0] = r1 - 1; reps[1] = r1; reps[2] = r2; break;
            default: break;
            }
        }
        ll_out[k] = (int32_t)ll;
        ob_out[k] = (int32_t)ob;
        mb_out[k] = (int32_t)(len - 3);
        k++;
        gs = ge + len;
    }
    int64_t pos = block_start, nl = 0;
    for (int64_t j = 0; j < k; j++) {
        memcpy(lits + nl, full + pos, (size_t)ll_out[j]);
        nl += ll_out[j];
        pos += (int64_t)ll_out[j] + mb_out[j] + 3;
    }
    memcpy(lits + nl, full + pos, (size_t)(block_end - pos));
    nl += block_end - pos;
    span[0] = start;
    span[1] = upto;
    info[0] = nl;
    info[1] = gaps;
    return k;
}
