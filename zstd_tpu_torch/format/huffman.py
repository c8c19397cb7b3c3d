"""Huffman coding for literals — exact RFC 8878 semantics.

Copy of zstd_tpu/format/huffman.py: canonical tree
construction with the 11-bit height limit (zstd's lib/compress/huf_compress.c
HUF_sort:620, HUF_buildTree:681, HUF_setMaxHeight:376,
HUF_buildCTableFromTree:730), the tree description serialization
(HUF_writeCTable_wksp:248, HUF_compressWeights:147) and its parsing
(HUF_readStats), the single-symbol decode table, the 1- and 4-stream
host decoders, and the 1- and 4-stream encoders (HUF_compress1X_usingCTable,
HUF_compress4X_usingCTable). build_huf_ctable_with_tree, huf_encode_1x and
huf_encode_4x call the port's copy of zstd_tpu's C (csrc/host/huf.c,
encode.c) where zstd_tpu/format/huffman.py does; their Python branches are
the *_plain functions (the encoders' bytes written through
bitstream.pack_fields).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..constants import HUF_WEIGHT_FSE_LOG_MAX, highbit32
from ..errors import Corruption
from . import fse
from .bitstream import BitReader, pack_fields

HUF_TABLELOG_ABSOLUTEMAX = 12
HUF_TABLELOG_DEFAULT = 11


@dataclasses.dataclass
class HufCTable:
    table_log: int
    max_symbol: int
    nb_bits: np.ndarray  # int32[256]
    value: np.ndarray    # int32[256] canonical code value


def _huf_sort(count: np.ndarray, max_symbol: int) -> list[tuple[int, int]]:
    """Symbols sorted by decreasing count; ties by increasing symbol value.

    The reference's bucket sort (HUF_sort) is stable by symbol within exact
    count buckets; we reproduce that ordering directly.
    """
    syms = [(int(count[s]), s) for s in range(max_symbol + 1)]
    syms.sort(key=lambda t: (-t[0], t[1]))
    return syms


def _huf_build_tree(nodes: list[tuple[int, int]]) -> tuple[list[int], int]:
    """Unlimited-depth Huffman tree over sorted leaves.

    nodes: (count, symbol) sorted descending. Returns (nb_bits per leaf in
    sorted order, non_null_rank). Mirrors HUF_buildTree's merge order exactly
    (ties prefer the internal-node queue)."""
    n_leaves = len(nodes)
    non_null = n_leaves - 1
    while non_null > 0 and nodes[non_null][0] == 0:
        non_null -= 1
    counts = [c for c, _ in nodes]

    STARTNODE = 256
    # Build arrays indexed like the reference: leaves 0..non_null, internal
    # nodes STARTNODE.. ; a sentinel "huffNode0[0]" barrier is emulated by
    # bounds checks below.
    tree_count = {}
    parent = {}
    for i in range(non_null + 1):
        tree_count[i] = counts[i]
    node_nb = STARTNODE
    low_s = non_null
    node_root = node_nb + low_s - 1
    low_n = node_nb
    tree_count[node_nb] = tree_count[low_s] + tree_count[low_s - 1]
    parent[low_s] = node_nb
    parent[low_s - 1] = node_nb
    node_nb += 1
    low_s -= 2
    for k in range(node_nb, node_root + 1):
        tree_count[k] = 1 << 30

    def pick():
        nonlocal low_s, low_n
        # huffNode0[0] barrier: when low_s < 0, treat as +inf
        cs = tree_count[low_s] if low_s >= 0 else (1 << 31)
        cn = tree_count[low_n]
        if cs < cn:
            low_s -= 1
            return low_s + 1
        low_n += 1
        return low_n - 1

    while node_nb <= node_root:
        n1 = pick()
        n2 = pick()
        tree_count[node_nb] = tree_count[n1] + tree_count[n2]
        parent[n1] = node_nb
        parent[n2] = node_nb
        node_nb += 1

    nb_bits = {node_root: 0}
    for k in range(node_root - 1, STARTNODE - 1, -1):
        nb_bits[k] = nb_bits[parent[k]] + 1
    leaf_bits = [0] * n_leaves
    for i in range(non_null + 1):
        leaf_bits[i] = nb_bits[parent[i]] + 1
    return leaf_bits, non_null


def _huf_set_max_height(nodes: list[tuple[int, int]], leaf_bits: list[int],
                        non_null: int, target: int) -> int:
    """Enforce the max code length; exact HUF_setMaxHeight algorithm."""
    largest = leaf_bits[non_null]
    if largest <= target:
        return largest

    base_cost = 1 << (largest - target)
    total_cost = 0
    n = non_null
    while leaf_bits[n] > target:
        total_cost += base_cost - (1 << (largest - leaf_bits[n]))
        leaf_bits[n] = target
        n -= 1
    while leaf_bits[n] == target:
        n -= 1
    total_cost >>= (largest - target)

    NO_SYMBOL = -1
    rank_last = [NO_SYMBOL] * (HUF_TABLELOG_ABSOLUTEMAX + 2)
    current_nb_bits = target
    for pos in range(n, -1, -1):
        if leaf_bits[pos] >= current_nb_bits:
            continue
        current_nb_bits = leaf_bits[pos]
        rank_last[target - current_nb_bits] = pos

    while total_cost > 0:
        nb_dec = highbit32(total_cost) + 1
        while nb_dec > 1:
            high_pos = rank_last[nb_dec]
            low_pos = rank_last[nb_dec - 1]
            if high_pos == NO_SYMBOL:
                nb_dec -= 1
                continue
            if low_pos == NO_SYMBOL:
                break
            high_total = nodes[high_pos][0]
            low_total = 2 * nodes[low_pos][0]
            if high_total <= low_total:
                break
            nb_dec -= 1
        while nb_dec <= HUF_TABLELOG_ABSOLUTEMAX and rank_last[nb_dec] == NO_SYMBOL:
            nb_dec += 1
        total_cost -= 1 << (nb_dec - 1)
        leaf_bits[rank_last[nb_dec]] += 1
        if rank_last[nb_dec - 1] == NO_SYMBOL:
            rank_last[nb_dec - 1] = rank_last[nb_dec]
        if rank_last[nb_dec] == 0:
            rank_last[nb_dec] = NO_SYMBOL
        else:
            rank_last[nb_dec] -= 1
            if leaf_bits[rank_last[nb_dec]] != target - nb_dec:
                rank_last[nb_dec] = NO_SYMBOL

    while total_cost < 0:
        if rank_last[1] == NO_SYMBOL:
            while leaf_bits[n] == target:
                n -= 1
            leaf_bits[n + 1] -= 1
            rank_last[1] = n + 1
            total_cost += 1
            continue
        leaf_bits[rank_last[1] + 1] -= 1
        rank_last[1] += 1
        total_cost += 1

    return target


def build_huf_ctable(count: np.ndarray, max_symbol: int,
                     max_nb_bits: int = HUF_TABLELOG_DEFAULT) -> HufCTable:
    nodes = _huf_sort(count, max_symbol)
    leaf_bits, non_null = _huf_build_tree(nodes)
    max_nb_bits = _huf_set_max_height(nodes, leaf_bits, non_null, max_nb_bits)
    if max_nb_bits > HUF_TABLELOG_ABSOLUTEMAX:
        raise Corruption("huffman tree too deep")

    nb_per_rank = [0] * (HUF_TABLELOG_ABSOLUTEMAX + 1)
    for i in range(non_null + 1):
        nb_per_rank[leaf_bits[i]] += 1
    val_per_rank = [0] * (HUF_TABLELOG_ABSOLUTEMAX + 1)
    mn = 0
    for b in range(max_nb_bits, 0, -1):
        val_per_rank[b] = mn
        mn += nb_per_rank[b]
        mn >>= 1

    nb_bits = np.zeros(256, dtype=np.int32)
    for i in range(non_null + 1):
        _, sym = nodes[i]
        nb_bits[sym] = leaf_bits[i]
    value = np.zeros(256, dtype=np.int32)
    vpr = list(val_per_rank)
    for sym in range(max_symbol + 1):
        b = int(nb_bits[sym])
        if b:
            value[sym] = vpr[b]
            vpr[b] += 1
    return HufCTable(max_nb_bits, max_symbol, nb_bits, value)


def build_huf_ctable_with_tree(count: np.ndarray, max_symbol: int,
                               max_nb_bits: int = HUF_TABLELOG_DEFAULT
                               ) -> tuple[HufCTable, bytes]:
    """build_huf_ctable + write_tree_description in one C call
    (HUF_buildCTable_wksp + HUF_writeCTable_wksp, zstd's
    lib/compress/huf_compress.c:756,248), the bytes of the Python pair."""
    r = native.huf_build_write(count, max_symbol, max_nb_bits)
    if r == -2:
        raise Corruption(
            "cannot serialize huffman tree (>128 symbols, weights incompressible)")
    if r is not None:
        tlog, nb, val, tree = r
        return HufCTable(tlog, max_symbol, nb, val), tree
    return build_huf_ctable_with_tree_plain(count, max_symbol, max_nb_bits)


def build_huf_ctable_with_tree_plain(count: np.ndarray, max_symbol: int,
                                     max_nb_bits: int = HUF_TABLELOG_DEFAULT
                                     ) -> tuple[HufCTable, bytes]:
    """The Python pair of build_huf_ctable_with_tree."""
    ct = build_huf_ctable(count, max_symbol, max_nb_bits)
    return ct, write_tree_description(ct)


def huf_estimate_compressed_size(ct: HufCTable, count: np.ndarray,
                                 max_symbol: int) -> int:
    bits = int(np.sum(ct.nb_bits[: max_symbol + 1] * count[: max_symbol + 1]))
    return bits >> 3


def huf_validate_ctable(ct: HufCTable, count: np.ndarray, max_symbol: int) -> bool:
    if max_symbol > ct.max_symbol:
        return False
    for s in range(max_symbol + 1):
        if count[s] != 0 and ct.nb_bits[s] == 0:
            return False
    return True


def huf_encode_1x(data: bytes, ct: HufCTable) -> bytes:
    """HUF_compress1X_usingCTable: symbols encoded last-to-first."""
    r = native.huf_encode(data, ct.nb_bits, ct.value)
    if r is not None:
        return r
    return huf_encode_1x_plain(data, ct)


def huf_encode_1x_plain(data: bytes, ct: HufCTable) -> bytes:
    """The Python branch of huf_encode_1x."""
    syms = np.frombuffer(data, dtype=np.uint8)[::-1]
    return pack_fields(ct.value[syms], ct.nb_bits[syms])


def huf_encode_4x(data: bytes, ct: HufCTable) -> bytes | None:
    """HUF_compress4X_usingCTable: 4 segments + 6-byte jump table.
    Returns None when a stream exceeds format limits (caller falls back)."""
    if len(data) < 12:
        return None
    r = native.huf_encode4(data, ct.nb_bits, ct.value)
    if r is not None:
        return r
    return huf_encode_4x_plain(data, ct)


def huf_encode_4x_plain(data: bytes, ct: HufCTable) -> bytes | None:
    """The Python branch of huf_encode_4x."""
    n = len(data)
    if n < 12:
        return None
    seg = (n + 3) // 4
    parts = [data[i * seg : min((i + 1) * seg, n)] for i in range(4)]
    streams = [huf_encode_1x_plain(p, ct) for p in parts]
    if any(len(s) == 0 or len(s) > 65535 for s in streams[:3]):
        return None
    jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
    return jump + b"".join(streams)


def huf_optimal_table_log(max_table_log: int, src_size: int, max_symbol: int) -> int:
    """Cheap path of HUF_optimalTableLog (FSE heuristic, minus=1)."""
    return fse.optimal_table_log(max_table_log, src_size, max_symbol, minus=1)


def write_tree_description(ct: HufCTable) -> bytes:
    """HUF_writeCTable_wksp: FSE-compress the weights; 4-bit direct fallback."""
    max_symbol = ct.max_symbol
    huff_log = ct.table_log
    bits_to_weight = [0] * (huff_log + 1)
    for n in range(1, huff_log + 1):
        bits_to_weight[n] = huff_log + 1 - n
    weights = bytes(bits_to_weight[int(ct.nb_bits[n])] for n in range(max_symbol))

    h = _compress_weights(weights)
    if h is not None and 1 < len(h) < max_symbol // 2:
        return bytes([len(h)]) + h

    if max_symbol > 128:
        raise Corruption("cannot serialize huffman tree (>128 symbols, weights incompressible)")
    out = bytearray([128 + (max_symbol - 1)])
    w = weights + b"\x00"
    for n in range(0, max_symbol, 2):
        out.append((w[n] << 4) + w[n + 1])
    return bytes(out)


def _compress_weights(weights: bytes) -> bytes | None:
    """HUF_compressWeights: FSE with tableLog<=6 over weight symbols <=12."""
    wt_size = len(weights)
    if wt_size <= 1:
        return None
    count = np.bincount(np.frombuffer(weights, dtype=np.uint8),
                        minlength=HUF_TABLELOG_ABSOLUTEMAX + 1).astype(np.int64)
    max_symbol = int(np.max(np.frombuffer(weights, dtype=np.uint8)))
    max_count = int(count.max())
    if max_count == wt_size:
        return None  # single symbol: reference signals RLE via size 1; direct repr wins anyway
    if max_count == 1:
        return None  # not compressible
    table_log = fse.optimal_table_log(HUF_WEIGHT_FSE_LOG_MAX, wt_size, max_symbol)
    try:
        norm = fse.normalize_count(count, table_log, wt_size, max_symbol,
                                   use_low_prob_count=False)
    except Exception:
        return None
    header = fse.write_ncount(norm, max_symbol, table_log)
    ctable = fse.build_ctable(norm, max_symbol, table_log)
    payload = fse.fse_compress_2state(weights, ctable)
    if not payload:
        return None
    return header + payload


def read_tree_description(data: bytes) -> tuple[np.ndarray, int, int, int]:
    """HUF_readStats: returns (nb_bits per symbol int32[256], nb_symbols,
    table_log, bytes_consumed)."""
    if len(data) < 1:
        raise Corruption("huffman tree: empty")
    header = data[0]
    if header >= 128:
        # direct 4-bit representation
        o_size = header - 127
        n_bytes = (o_size + 1) // 2
        if 1 + n_bytes > len(data):
            raise Corruption("huffman tree: truncated direct weights")
        weights = []
        for i in range(o_size):
            b = data[1 + i // 2]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0xF))
        consumed = 1 + n_bytes
    else:
        # FSE-compressed weights
        c_size = header
        if 1 + c_size > len(data):
            raise Corruption("huffman tree: truncated FSE weights")
        payload = data[1 : 1 + c_size]
        norm, max_sym, table_log, hdr_len = fse.read_ncount(
            payload, HUF_TABLELOG_ABSOLUTEMAX, HUF_WEIGHT_FSE_LOG_MAX)
        dt = fse.build_dtable(norm, table_log)
        weights = list(fse.fse_decompress_2state(payload[hdr_len:], dt, 255))
        consumed = 1 + c_size

    if len(weights) > 255:
        raise Corruption("huffman tree: too many weights")
    total = 0
    for w in weights:
        if w > HUF_TABLELOG_ABSOLUTEMAX:
            raise Corruption("huffman tree: weight too large")
        if w > 0:
            total += 1 << (w - 1)
    if total == 0:
        raise Corruption("huffman tree: no weights")
    table_log = highbit32(total) + 1
    if table_log > HUF_TABLELOG_ABSOLUTEMAX:
        raise Corruption("huffman tree: tableLog too large")
    rest = (1 << table_log) - total
    last_weight = highbit32(rest) + 1 if rest > 0 else 0
    if last_weight == 0 or (1 << (last_weight - 1)) != rest:
        raise Corruption("huffman tree: invalid implied last weight")
    weights.append(last_weight)
    nb_symbols = len(weights)
    if nb_symbols > 256:
        raise Corruption("huffman tree: too many symbols")

    nb_bits = np.zeros(256, dtype=np.int32)
    for s, w in enumerate(weights):
        nb_bits[s] = (table_log + 1 - w) if w > 0 else 0
    return nb_bits, nb_symbols, table_log, consumed


@dataclasses.dataclass
class HufDTable:
    table_log: int
    symbol: np.ndarray   # int32[2^table_log]
    length: np.ndarray   # int32[2^table_log]


def build_huf_dtable(nb_bits: np.ndarray, nb_symbols: int, table_log: int) -> HufDTable:
    """Single-symbol (X1) decode LUT: canonical codes, ascending from lowest
    weight, symbols in natural order within a weight."""
    table_size = 1 << table_log
    symbol = np.zeros(table_size, dtype=np.int32)
    length = np.zeros(table_size, dtype=np.int32)
    pos = 0
    # weight w corresponds to nbBits = table_log + 1 - w; lowest weight first
    for w in range(1, table_log + 1):
        n = table_log + 1 - w
        span = 1 << (table_log - n)
        for s in range(nb_symbols):
            if nb_bits[s] == n:
                symbol[pos : pos + span] = s
                length[pos : pos + span] = n
                pos += span
    if pos != table_size:
        raise Corruption("huffman decode table underfilled")
    return HufDTable(table_log, symbol, length)


def ctable_to_dtable(ct: HufCTable) -> HufDTable:
    return build_huf_dtable(ct.nb_bits, ct.max_symbol + 1, ct.table_log)


def ctable_from_nbbits(nb_bits: np.ndarray, table_log: int) -> HufCTable:
    """Rebuild the encode table (canonical code values) from code lengths —
    used when loading a dictionary's Huffman table (HUF_readCTable analog)."""
    nb_per_rank = [0] * (HUF_TABLELOG_ABSOLUTEMAX + 2)
    max_symbol = 0
    for s in range(256):
        b = int(nb_bits[s])
        if b:
            nb_per_rank[b] += 1
            max_symbol = s
    val_per_rank = [0] * (HUF_TABLELOG_ABSOLUTEMAX + 2)
    mn = 0
    for b in range(table_log, 0, -1):
        val_per_rank[b] = mn
        mn += nb_per_rank[b]
        mn >>= 1
    value = np.zeros(256, dtype=np.int32)
    for s in range(256):
        b = int(nb_bits[s])
        if b:
            value[s] = val_per_rank[b]
            val_per_rank[b] += 1
    return HufCTable(table_log, max_symbol, np.asarray(nb_bits, dtype=np.int32),
                     value)


def huf_decode_1x(data: bytes, dt: HufDTable, regen_size: int) -> bytes:
    br = BitReader(data)
    out = bytearray(regen_size)
    tlog = dt.table_log
    sym = dt.symbol
    ln = dt.length
    acc = br.acc
    pos = br.pos
    mask = (1 << tlog) - 1
    for i in range(regen_size):
        if pos >= tlog:
            idx = (acc >> (pos - tlog)) & mask
        elif pos <= 0:
            raise Corruption("huffman stream exhausted early")
        else:
            idx = (acc << (tlog - pos)) & mask
        out[i] = int(sym[idx])
        pos -= int(ln[idx])
    if pos != 0:
        raise Corruption("huffman stream not exactly consumed")
    return bytes(out)


def huf_decode_4x(data: bytes, dt: HufDTable, regen_size: int) -> bytes:
    if len(data) < 10:
        raise Corruption("4-stream literals too short")
    s1 = int.from_bytes(data[0:2], "little")
    s2 = int.from_bytes(data[2:4], "little")
    s3 = int.from_bytes(data[4:6], "little")
    total = len(data) - 6
    s4 = total - s1 - s2 - s3
    if s4 < 1:
        raise Corruption("4-stream jump table inconsistent")
    seg = (regen_size + 3) // 4
    last = regen_size - 3 * seg
    if last < 0:
        raise Corruption("4-stream regenerated size too small")
    out = bytearray()
    off = 6
    for size, rs in ((s1, seg), (s2, seg), (s3, seg), (s4, last)):
        out += huf_decode_1x(data[off : off + size], dt, rs)
        off += size
    return bytes(out)
