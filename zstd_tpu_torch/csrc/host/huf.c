/* Huffman CTable construction + tree description in one native call.
 *
 * Role of HUF_buildCTable_wksp + HUF_writeCTable_wksp
 * (zstd's lib/compress/huf_compress.c:620,681,376,730,248) —
 * exact mirror of this repo's Python oracle (format/huffman.py
 * _huf_sort/_huf_build_tree/_huf_set_max_height/build_huf_ctable/
 * write_tree_description), which itself carries behavioral parity with
 * the reference. Includes the weight-FSE sub-codec: optimal_table_log,
 * normalize_count (incl. M2 fallback) and write_ncount mirrored from
 * format/fse.py so the serialized tree is byte-identical whichever side
 * builds it.
 *
 * Copy of native/huf.c.
 * Every C file of csrc/host is built into one shared library with the host C
 * compiler at first use (zstd_tpu_torch/_kernels.py, host()) and loaded
 * with ctypes; it runs on the host, not on the card.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

extern int64_t zt_fse_build_ctable(const int32_t* norm, int max_symbol,
                                   int table_log, int32_t* state_table,
                                   int64_t* delta_nb, int64_t* delta_fs);
extern int64_t zt_fse_compress_2state(const uint8_t* data, int64_t n,
                                      int table_log, const int32_t* st,
                                      const int64_t* dnb, const int64_t* dfs,
                                      uint8_t* out, int64_t out_cap);

#define HUF_TLOG_ABSMAX 12

static inline int hb32(uint32_t v) { return 31 - __builtin_clz(v); }

/* ---------- FSE normalization (format/fse.py exact mirror) ---------- */

static const uint64_t RTB[8] = {0, 473195, 504333, 520860, 550000,
                                700000, 750000, 830000};

static int fse_min_table_log(int64_t src_size, int max_symbol) {
    int min_bits_src = hb32((uint32_t)src_size) + 1;
    int min_bits_symbols = max_symbol ? hb32((uint32_t)max_symbol) + 2 : 2;
    return min_bits_src < min_bits_symbols ? min_bits_src : min_bits_symbols;
}

static int fse_optimal_table_log(int max_table_log, int64_t src_size,
                                 int max_symbol, int minus) {
    int table_log = max_table_log ? max_table_log : 11;
    int max_bits_src = src_size > 1
        ? hb32((uint32_t)(src_size - 1)) - minus : 0;
    if (max_bits_src < table_log) table_log = max_bits_src;
    int mb = fse_min_table_log(src_size, max_symbol);
    if (mb > table_log) table_log = mb;
    if (table_log < 5) table_log = 5;
    if (table_log > 15) table_log = 15;
    return table_log;
}

static int fse_normalize_m2(int32_t* norm, int table_log,
                            const int64_t* count, int64_t total,
                            int max_symbol, int low_prob_count) {
    const int32_t NOT_YET = -2;
    int64_t distributed = 0;
    int64_t low_threshold = total >> table_log;
    int64_t low_one = (total * 3) >> (table_log + 1);

    for (int s = 0; s <= max_symbol; s++) {
        int64_t c = count[s];
        if (c == 0) { norm[s] = 0; continue; }
        if (c <= low_threshold) {
            norm[s] = (int32_t)low_prob_count;
            distributed++; total -= c; continue;
        }
        if (c <= low_one) { norm[s] = 1; distributed++; total -= c; continue; }
        norm[s] = NOT_YET;
    }
    int64_t to_distribute = ((int64_t)1 << table_log) - distributed;
    if (to_distribute == 0) return 0;

    if (to_distribute > 0 && total / to_distribute > low_one) {
        low_one = (total * 3) / (to_distribute * 2);
        for (int s = 0; s <= max_symbol; s++) {
            if (norm[s] == NOT_YET && count[s] <= low_one) {
                norm[s] = 1; distributed++; total -= count[s];
            }
        }
        to_distribute = ((int64_t)1 << table_log) - distributed;
    }

    if (distributed == (int64_t)max_symbol + 1) {
        int max_v = 0; int64_t max_c = 0;
        for (int s = 0; s <= max_symbol; s++)
            if (count[s] > max_c) { max_v = s; max_c = count[s]; }
        norm[max_v] += (int32_t)to_distribute;
        return 0;
    }

    if (total == 0) {
        int s = 0;
        while (to_distribute > 0) {
            if (norm[s] > 0) { to_distribute--; norm[s]++; }
            s = (s + 1) % (max_symbol + 1);
        }
        return 0;
    }

    {
        int v_step_log = 62 - table_log;
        unsigned __int128 mid = ((unsigned __int128)1 << (v_step_log - 1)) - 1;
        unsigned __int128 r_step =
            ((((unsigned __int128)1 << v_step_log)
              * (uint64_t)to_distribute) + mid) / (uint64_t)total;
        unsigned __int128 tmp_total = mid;
        for (int s = 0; s <= max_symbol; s++) {
            if (norm[s] == NOT_YET) {
                unsigned __int128 end =
                    tmp_total + (unsigned __int128)(uint64_t)count[s] * r_step;
                int64_t s_start = (int64_t)(tmp_total >> v_step_log);
                int64_t s_end = (int64_t)(end >> v_step_log);
                int64_t weight = s_end - s_start;
                if (weight < 1) return -1;
                norm[s] = (int32_t)weight;
                tmp_total = end;
            }
        }
    }
    return 0;
}

/* Returns table_log on success, -1 on any condition where the Python
 * oracle raises (RLE case, tableLog out of range, M2 failure). */
static int fse_normalize_count(const int64_t* count, int table_log,
                               int64_t total, int max_symbol,
                               int use_low_prob, int32_t* norm) {
    if (table_log == 0) table_log = 11;
    if (table_log < 5 || table_log > 15) return -1;
    if (table_log < fse_min_table_log(total, max_symbol)) return -1;

    int low_prob_count = use_low_prob ? -1 : 1;
    int scale = 62 - table_log;
    uint64_t step = ((uint64_t)1 << 62) / (uint64_t)total;
    uint64_t v_step = (uint64_t)1 << (scale - 20);
    int64_t still = (int64_t)1 << table_log;
    int largest = 0;
    int64_t largest_p = 0;
    int64_t low_threshold = total >> table_log;

    for (int s = 0; s <= max_symbol; s++) {
        int64_t c = count[s];
        if (c == total) return -1;               /* RLE special case */
        if (c == 0) { norm[s] = 0; continue; }
        if (c <= low_threshold) {
            norm[s] = (int32_t)low_prob_count;
            still -= 1;
        } else {
            unsigned __int128 cs = (unsigned __int128)(uint64_t)c * step;
            int64_t proba = (int64_t)(cs >> scale);
            if (proba < 8) {
                unsigned __int128 rest =
                    (unsigned __int128)v_step * RTB[proba];
                if (cs - ((unsigned __int128)(uint64_t)proba << scale) > rest)
                    proba++;
            }
            if (proba > largest_p) { largest_p = proba; largest = s; }
            norm[s] = (int32_t)proba;
            still -= proba;
        }
    }

    if (-still >= (norm[largest] >> 1)) {
        if (fse_normalize_m2(norm, table_log, count, total, max_symbol,
                             low_prob_count) != 0)
            return -1;
    } else {
        norm[largest] += (int32_t)still;
    }
    return table_log;
}

/* FSE_writeNCount exact bit layout (format/fse.py write_ncount mirror).
 * Returns serialized length, -1 on error / cap overflow. */
static int64_t fse_write_ncount(const int32_t* norm, int max_symbol,
                                int table_log, uint8_t* out, int64_t cap) {
    int64_t olen = 0;
    uint64_t bit_stream = 0;
    int bit_count = 0;
    int table_size = 1 << table_log;

#define ZT_FLUSH16() do { \
        if (olen + 2 > cap) return -1; \
        out[olen++] = (uint8_t)bit_stream; \
        out[olen++] = (uint8_t)(bit_stream >> 8); \
        bit_stream >>= 16; bit_count -= 16; \
    } while (0)

    bit_stream += (uint64_t)(table_log - 5) << bit_count;
    bit_count += 4;
    int remaining = table_size + 1;
    int threshold = table_size;
    int nb_bits = table_log + 1;
    int symbol = 0;
    int alphabet_size = max_symbol + 1;
    int previous_is0 = 0;

    while (symbol < alphabet_size && remaining > 1) {
        if (previous_is0) {
            int start = symbol;
            while (symbol < alphabet_size && !norm[symbol]) symbol++;
            if (symbol == alphabet_size) return -1;
            while (symbol >= start + 24) {
                start += 24;
                bit_stream += (uint64_t)0xFFFF << bit_count;
                ZT_FLUSH16();
                bit_count += 16;
            }
            while (symbol >= start + 3) {
                start += 3;
                bit_stream += (uint64_t)3 << bit_count;
                bit_count += 2;
            }
            bit_stream += (uint64_t)(symbol - start) << bit_count;
            bit_count += 2;
            if (bit_count > 16) ZT_FLUSH16();
        }
        int count = norm[symbol];
        symbol++;
        int mx = (2 * threshold - 1) - remaining;
        remaining -= count < 0 ? -count : count;
        count++;
        if (count >= threshold) count += mx;
        bit_stream += (uint64_t)count << bit_count;
        bit_count += nb_bits;
        if (count < mx) bit_count -= 1;
        previous_is0 = (count == 1);
        if (remaining < 1) return -1;
        while (remaining < threshold) { nb_bits--; threshold >>= 1; }
        if (bit_count > 16) ZT_FLUSH16();
    }
    if (remaining != 1) return -1;
    if (olen + 2 > cap) return -1;
    out[olen++] = (uint8_t)bit_stream;
    out[olen++] = (uint8_t)(bit_stream >> 8);
    return olen - 2 + (bit_count + 7) / 8;
#undef ZT_FLUSH16
}

/* Public wrappers so the Python FSE module can use the same exact
 * normalize / ncount-serialize mirrors (FSE_normalizeCount +
 * FSE_writeNCount roles) without a per-symbol Python loop. */
int64_t zt_fse_normalize(const int64_t* count, int table_log, int64_t total,
                         int max_symbol, int use_low_prob, int32_t* norm) {
    return fse_normalize_count(count, table_log, total, max_symbol,
                               use_low_prob, norm);
}

int64_t zt_fse_write_ncount(const int32_t* norm, int max_symbol,
                            int table_log, uint8_t* out, int64_t cap) {
    return fse_write_ncount(norm, max_symbol, table_log, out, cap);
}

/* FSE_optimalTableLog_internal (minus 2 for FSE tables, 1 for
 * HUF_optimalTableLog), for plan.c's batch planner */
int zt_fse_optimal_table_log(int max_table_log, int64_t src_size,
                             int max_symbol, int minus) {
    return fse_optimal_table_log(max_table_log, src_size, max_symbol, minus);
}

/* ---------- Huffman tree build (format/huffman.py exact mirror) ------ */

/* counts: sorted descending (ties by ascending symbol). leaf_bits out.
 * Returns non_null index, or -1 when the shape is outside what the
 * mirror handles (caller falls back to Python). */
static int huf_build_tree(const int64_t* counts, int n_leaves,
                          int* leaf_bits) {
    int non_null = n_leaves - 1;
    while (non_null > 0 && counts[non_null] == 0) non_null--;
    if (non_null < 1) return -1;

    int64_t tc[512];
    int parent[512];
    const int STARTNODE = 256;
    for (int i = 0; i <= non_null; i++) tc[i] = counts[i];
    int node_nb = STARTNODE;
    int low_s = non_null;
    int node_root = node_nb + low_s - 1;
    int low_n = node_nb;
    tc[node_nb] = tc[low_s] + tc[low_s - 1];
    parent[low_s] = node_nb;
    parent[low_s - 1] = node_nb;
    node_nb++; low_s -= 2;
    for (int k = node_nb; k <= node_root; k++) tc[k] = (int64_t)1 << 30;

    while (node_nb <= node_root) {
        int n1, n2;
        {
            int64_t cs = low_s >= 0 ? tc[low_s] : ((int64_t)1 << 31);
            if (cs < tc[low_n]) { n1 = low_s--; } else { n1 = low_n++; }
        }
        {
            int64_t cs = low_s >= 0 ? tc[low_s] : ((int64_t)1 << 31);
            if (cs < tc[low_n]) { n2 = low_s--; } else { n2 = low_n++; }
        }
        tc[node_nb] = tc[n1] + tc[n2];
        parent[n1] = node_nb;
        parent[n2] = node_nb;
        node_nb++;
    }

    int nbb[512];
    nbb[node_root] = 0;
    for (int k = node_root - 1; k >= STARTNODE; k--)
        nbb[k] = nbb[parent[k]] + 1;
    for (int i = 0; i <= non_null; i++)
        leaf_bits[i] = nbb[parent[i]] + 1;
    for (int i = non_null + 1; i < n_leaves; i++) leaf_bits[i] = 0;
    return non_null;
}

/* HUF_setMaxHeight exact mirror. Returns final max bits, -1 on a state
 * the Python oracle would only reach via out-of-range indexing. */
static int huf_set_max_height(const int64_t* counts, int* leaf_bits,
                              int non_null, int target) {
    int largest = leaf_bits[non_null];
    if (largest <= target) return largest;
    /* infeasible: more leaves than a depth-`target` tree can hold (the
       Python oracle raises here; -1 routes callers to that behavior) */
    if (non_null + 1 > (1 << target)) return -1;

    int64_t base_cost = (int64_t)1 << (largest - target);
    int64_t total_cost = 0;
    int n = non_null;
    while (leaf_bits[n] > target) {
        total_cost += base_cost - ((int64_t)1 << (largest - leaf_bits[n]));
        leaf_bits[n] = target;
        n--;
    }
    while (n >= 0 && leaf_bits[n] == target) n--;
    total_cost >>= (largest - target);

    const int NO_SYMBOL = -1;
    int rank_last[HUF_TLOG_ABSMAX + 2];
    for (int i = 0; i < HUF_TLOG_ABSMAX + 2; i++) rank_last[i] = NO_SYMBOL;
    int current_nb_bits = target;
    for (int pos = n; pos >= 0; pos--) {
        if (leaf_bits[pos] >= current_nb_bits) continue;
        current_nb_bits = leaf_bits[pos];
        rank_last[target - current_nb_bits] = pos;
    }

    while (total_cost > 0) {
        int nb_dec = hb32((uint32_t)total_cost) + 1;
        while (nb_dec > 1) {
            int high_pos = rank_last[nb_dec];
            int low_pos = rank_last[nb_dec - 1];
            if (high_pos == NO_SYMBOL) { nb_dec--; continue; }
            if (low_pos == NO_SYMBOL) break;
            if (counts[high_pos] <= 2 * counts[low_pos]) break;
            nb_dec--;
        }
        while (nb_dec <= HUF_TLOG_ABSMAX && rank_last[nb_dec] == NO_SYMBOL)
            nb_dec++;
        if (rank_last[nb_dec] == NO_SYMBOL) return -1;
        total_cost -= (int64_t)1 << (nb_dec - 1);
        leaf_bits[rank_last[nb_dec]] += 1;
        if (rank_last[nb_dec - 1] == NO_SYMBOL)
            rank_last[nb_dec - 1] = rank_last[nb_dec];
        if (rank_last[nb_dec] == 0) rank_last[nb_dec] = NO_SYMBOL;
        else {
            rank_last[nb_dec] -= 1;
            if (leaf_bits[rank_last[nb_dec]] != target - nb_dec)
                rank_last[nb_dec] = NO_SYMBOL;
        }
    }

    while (total_cost < 0) {
        if (rank_last[1] == NO_SYMBOL) {
            while (n >= 0 && leaf_bits[n] == target) n--;
            leaf_bits[n + 1] -= 1;
            rank_last[1] = n + 1;
            total_cost += 1;
            continue;
        }
        leaf_bits[rank_last[1] + 1] -= 1;
        rank_last[1] += 1;
        total_cost += 1;
    }
    return target;
}

/* ---------- entry: build CTable + serialize tree description -------- */

/* count: int64[256] symbol histogram; nb_bits_out/value_out: int32[256].
 * Returns final table_log (>0), -1 = fall back to the Python oracle,
 * -2 = tree unserializable (mirrors the Python Corruption raise: >128
 * symbols with incompressible weights). */
int64_t zt_huf_build_write(const int64_t* count, int max_symbol,
                           int max_nb_bits,
                           int32_t* nb_bits_out, int32_t* value_out,
                           uint8_t* tree_out, int64_t tree_cap,
                           int64_t* tree_len_out)
{
    if (max_symbol < 1 || max_symbol > 255 || max_nb_bits < 1
        || max_nb_bits > HUF_TLOG_ABSMAX || tree_cap < 260)
        return -1;

    /* sort: count descending, symbol ascending (HUF_sort order) */
    int n_leaves = max_symbol + 1;
    int syms[256];
    int64_t sorted[256];
    for (int i = 0; i < n_leaves; i++) syms[i] = i;
    /* insertion sort: n<=256, nearly free vs the encode itself */
    for (int i = 1; i < n_leaves; i++) {
        int s = syms[i];
        int64_t c = count[s];
        int j = i - 1;
        while (j >= 0 && count[syms[j]] < c) { syms[j + 1] = syms[j]; j--; }
        syms[j + 1] = s;
    }
    for (int i = 0; i < n_leaves; i++) sorted[i] = count[syms[i]];

    int leaf_bits[256];
    int non_null = huf_build_tree(sorted, n_leaves, leaf_bits);
    if (non_null < 0) return -1;
    int table_log = huf_set_max_height(sorted, leaf_bits, non_null,
                                       max_nb_bits);
    if (table_log < 0 || table_log > HUF_TLOG_ABSMAX) return -1;

    /* canonical code values */
    {
        int nb_per_rank[HUF_TLOG_ABSMAX + 1];
        int val_per_rank[HUF_TLOG_ABSMAX + 1];
        memset(nb_per_rank, 0, sizeof nb_per_rank);
        memset(val_per_rank, 0, sizeof val_per_rank);
        for (int i = 0; i <= non_null; i++) nb_per_rank[leaf_bits[i]]++;
        int mn = 0;
        for (int b = table_log; b > 0; b--) {
            val_per_rank[b] = mn;
            mn += nb_per_rank[b];
            mn >>= 1;
        }
        memset(nb_bits_out, 0, 256 * sizeof(int32_t));
        memset(value_out, 0, 256 * sizeof(int32_t));
        for (int i = 0; i <= non_null; i++)
            nb_bits_out[syms[i]] = leaf_bits[i];
        for (int s = 0; s <= max_symbol; s++) {
            int b = nb_bits_out[s];
            if (b) { value_out[s] = val_per_rank[b]; val_per_rank[b]++; }
        }
    }

    /* tree description (HUF_writeCTable: FSE weights, 4-bit fallback) */
    {
        uint8_t weights[256];
        for (int nn = 0; nn < max_symbol; nn++) {
            int b = nb_bits_out[nn];
            weights[nn] = b ? (uint8_t)(table_log + 1 - b) : 0;
        }
        int wt_size = max_symbol;
        int64_t hlen = -1;
        uint8_t hbuf[640];
        if (wt_size > 1) {
            int64_t wcount[HUF_TLOG_ABSMAX + 1];
            memset(wcount, 0, sizeof wcount);
            int max_w = 0;
            for (int i = 0; i < wt_size; i++) {
                wcount[weights[i]]++;
                if (weights[i] > max_w) max_w = weights[i];
            }
            int64_t max_count = 0;
            for (int i = 0; i <= HUF_TLOG_ABSMAX; i++)
                if (wcount[i] > max_count) max_count = wcount[i];
            if (max_count != wt_size && max_count != 1) {
                int tlw = fse_optimal_table_log(6, wt_size, max_w, 2);
                int32_t normw[HUF_TLOG_ABSMAX + 1];
                if (fse_normalize_count(wcount, tlw, wt_size, max_w, 0,
                                        normw) == tlw) {
                    int64_t hdr_len = fse_write_ncount(normw, max_w, tlw,
                                                       hbuf, sizeof hbuf);
                    if (hdr_len > 0) {
                        int32_t st[64];
                        int64_t dnb[HUF_TLOG_ABSMAX + 1];
                        int64_t dfs[HUF_TLOG_ABSMAX + 1];
                        if (zt_fse_build_ctable(normw, max_w, tlw, st,
                                                dnb, dfs) == 0) {
                            int64_t plen = zt_fse_compress_2state(
                                weights, wt_size, tlw, st, dnb, dfs,
                                hbuf + hdr_len,
                                (int64_t)sizeof hbuf - hdr_len);
                            if (plen > 0) hlen = hdr_len + plen;
                        }
                    }
                }
            }
        }
        if (hlen > 1 && hlen < max_symbol / 2) {
            tree_out[0] = (uint8_t)hlen;
            memcpy(tree_out + 1, hbuf, (size_t)hlen);
            *tree_len_out = 1 + hlen;
        } else {
            if (max_symbol > 128) return -2;
            tree_out[0] = (uint8_t)(128 + (max_symbol - 1));
            int64_t o = 1;
            for (int nn = 0; nn < max_symbol; nn += 2) {
                uint8_t hi = weights[nn];
                uint8_t lo = (nn + 1 < max_symbol) ? weights[nn + 1] : 0;
                tree_out[o++] = (uint8_t)((hi << 4) + lo);
            }
            *tree_len_out = o;
        }
    }
    return table_log;
}
