/* The long-distance matcher's walk over a block's anchors
 * (parallel/ldm_sharded.py, ShardedLdmState.find_long_matches): for each
 * anchor at or past the cursor, the longest forward match among its
 * candidates inside the window; one of at least min_match bytes is
 * extended backward to the cursor, committed, and moves the cursor to its
 * end. Role of zstd's ZSTD_ldm_generateSequences_internal
 * (lib/compress/zstd_ldm.c) over the discovery's candidate lists.
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
