"""The plain reference decoder that judges the benchmark's frames.

A Zstandard (RFC 8878) frame decoder in Python and NumPy, written for the
benchmark from the format specification. It imports nothing of the program
under test. A frame is decoded in three passes:

  1. a serial walk of the block headers, the literal sections' headers and
     Huffman tree descriptions, and the sequence sections' headers and FSE
     tables (small, per block);
  2. the bitstreams, lane-parallel in NumPy: every Huffman stream of the
     frame is one lane, every block's sequence bitstream is one lane, and
     each step decodes one symbol (or one sequence) of every lane;
  3. a serial pass over the sequences that resolves the repeat offsets and
     writes the output.

Every bitstream has to end exactly where the format says it ends, every
offset has to fall inside the output and the window, and every size has to
agree; anything else raises FormatError. The content checksum is read and
not verified: the benchmark compares the decoded bytes with the input.
"""

from __future__ import annotations

import numpy as np

ZSTD_MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024

LL_BITS = np.array([0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11,
                               12, 13, 14, 15, 16], np.int64)
LL_BASE = np.array(list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                                      128, 256, 512, 1024, 2048, 4096, 8192,
                                      16384, 32768, 65536], np.int64)
ML_BITS = np.array([0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                               11, 12, 13, 14, 15, 16], np.int64)
ML_BASE = np.array(list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67,
                                         83, 99, 131, 259, 515, 1027, 2051,
                                         4099, 8195, 16387, 32771, 65539],
                   np.int64)
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
               2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1]
              + [1] * 30 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
# (largest symbol, largest accuracy log) of the LL, OF and ML tables
TABLE_LIMITS = ((35, 9), (31, 8), (52, 9))


class FormatError(Exception):
    """The frame breaks the format."""


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise FormatError(what)


# ---- FSE tables ----------------------------------------------------------

class FseTable:
    """A decoding table: per state its symbol, bits to read and base of the
    next state."""
    __slots__ = ("log", "sym", "nb", "base")

    def __init__(self, log, sym, nb, base):
        self.log, self.sym, self.nb, self.base = log, sym, nb, base


def fse_table(counts, log: int) -> FseTable:
    """The decoding table of normalized counts (-1: "less than one")."""
    size = 1 << log
    sym = np.zeros(size, np.int64)
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    _need(pos == 0, "FSE spread does not close")
    nb = np.zeros(size, np.int64)
    base = np.zeros(size, np.int64)
    for u in range(size):
        s = int(sym[u])
        x = nxt[s]
        nxt[s] += 1
        nb[u] = log - (x.bit_length() - 1)
        base[u] = (x << int(nb[u])) - size
    return FseTable(log, sym, nb, base)


def rle_table(symbol: int) -> FseTable:
    one = np.zeros(1, np.int64)
    return FseTable(0, np.array([symbol], np.int64), one, one.copy())


def read_ncount(buf: bytes, max_symbol: int, max_log: int):
    """(counts, accuracy log, bytes used) of an FSE table description."""
    bits = int.from_bytes(buf, "little")
    avail = 8 * len(buf)
    pos = 0

    def take(n):
        nonlocal pos
        _need(pos + n <= avail, "FSE table description truncated")
        v = (bits >> pos) & ((1 << n) - 1)
        pos += n
        return v

    log = take(4) + 5
    _need(log <= max_log, "FSE accuracy log too large")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    while remaining > 1:
        _need(len(counts) <= max_symbol, "FSE table: too many symbols")
        mx = (2 * threshold - 1) - remaining
        low = (bits >> pos) & (threshold - 1)
        if low < mx:
            c = take(nbits - 1)
        else:
            c = take(nbits)
            if c >= threshold:
                c -= mx
        c -= 1
        remaining -= abs(c)
        counts.append(c)
        if c == 0:
            while True:
                r = take(2)
                counts.extend([0] * r)
                if r != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    _need(remaining == 1, "FSE table: counts do not sum")
    _need(len(counts) <= max_symbol + 1, "FSE table: symbol out of range")
    return counts, log, (pos + 7) >> 3


# ---- bit readers ----------------------------------------------------------

def _windows(data: bytes) -> np.ndarray:
    """i64[len(data)]: the 7 bytes from each position, little-endian."""
    n = len(data)
    pad = data + bytes(16)
    w = np.empty(n, np.uint64)
    for r in range(8):
        cnt = (n - r + 7) // 8
        w[r::8] = np.frombuffer(pad, "<u8", count=cnt, offset=r)
    return (w & np.uint64((1 << 56) - 1)).astype(np.int64)


def _stream_end(data: bytes, start: int, end: int) -> int:
    """The bit just above the last data bit of a backward stream in
    data[start:end] (below its closing 1 bit)."""
    _need(end > start, "empty bitstream")
    last = data[end - 1]
    _need(last != 0, "bitstream without its closing bit")
    return 8 * (end - 1) + last.bit_length() - 1


class _BackBits:
    """A backward bit reader over one stream, for the serial headers."""

    def __init__(self, data: bytes, start: int, end: int):
        self.v = int.from_bytes(data[start:end], "little")
        self.left = _stream_end(data, start, end) - 8 * start

    def read(self, n: int) -> int:
        self.left -= n
        if self.left >= 0:
            return (self.v >> self.left) & ((1 << n) - 1)
        # bits past the start of the stream read as zeros
        return (self.v << -self.left) & ((1 << n) - 1)


class _Lanes:
    """Backward bit readers over many streams of one buffer at once, in
    the order of `order`. Each call works on the first m lanes; reads of
    up to 48 bits."""

    def __init__(self, win: np.ndarray, data: bytes, starts, ends, order):
        self.win = win
        self.lo = (np.asarray(starts, np.int64) * 8)[order]
        self.at = np.array([_stream_end(data, s, e)
                            for s, e in zip(starts, ends)], np.int64)[order]

    def peek(self, n, m: int):
        """The n bits below each of the first m lanes' positions; bits
        below a stream's start read as zeros."""
        start = self.at[:m] - n
        pos = np.maximum(start, 0)
        v = (self.win[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)
        under = np.minimum(np.maximum(self.lo[:m] - start, 0), 63)
        return (v >> under) << under

    def read(self, n, m: int):
        v = self.peek(n, m)
        self.at[:m] -= n
        return v


def _by_count(count: np.ndarray):
    """(lane order, longest first; the sorted counts)."""
    order = np.argsort(-count, kind="stable")
    return order, count[order]


# ---- Huffman ----------------------------------------------------------------

def _fse_weights(data: bytes, start: int, size: int):
    """Huffman weights compressed with FSE (two interleaved states)."""
    counts, log, used = read_ncount(data[start:start + size], 12, 6)
    t = fse_table(counts, log)
    bits = _BackBits(data, start + used, start + size)
    s1 = bits.read(log)
    s2 = bits.read(log)
    out = []

    def step(s):
        out.append(int(t.sym[s]))
        _need(len(out) <= 255, "too many Huffman weights")
        return int(t.base[s]) + bits.read(int(t.nb[s]))

    while True:
        s1 = step(s1)
        if bits.left < 0:
            out.append(int(t.sym[s2]))
            break
        s2 = step(s2)
        if bits.left < 0:
            out.append(int(t.sym[s1]))
            break
    return out


def huffman_table(data: bytes, pos: int):
    """(symbol LUT, length LUT, table log, bytes used) of a tree
    description."""
    h = data[pos]
    if h >= 128:
        n = h - 127
        used = 1 + (n + 1) // 2
        raw = data[pos + 1:pos + used]
        _need(len(raw) == used - 1, "Huffman weights truncated")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
    else:
        used = 1 + h
        _need(pos + used <= len(data), "Huffman weights truncated")
        weights = _fse_weights(data, pos + 1, h)
    _need(all(w <= 11 for w in weights), "Huffman weight too large")
    total = sum((1 << w) >> 1 for w in weights)
    _need(total > 0, "Huffman weights all zero")
    log = total.bit_length()
    _need(log <= 11, "Huffman table log too large")
    rest = (1 << log) - total
    _need(rest & (rest - 1) == 0, "Huffman weights do not complete a tree")
    weights.append(rest.bit_length())
    size = 1 << log
    sym = np.zeros(size, np.int64)
    length = np.zeros(size, np.int64)
    start = [0] * 13
    nxt = 0
    for w in range(1, log + 1):
        start[w] = nxt
        nxt += weights.count(w) << (w - 1)
    for s, w in enumerate(weights):
        if w:
            k = 1 << (w - 1)
            sym[start[w]:start[w] + k] = s
            length[start[w]:start[w] + k] = log + 1 - w
            start[w] += k
    return sym, length, log, used


def _decode_huffman(data, win, streams, tables) -> list:
    """Every Huffman stream of a frame, as lanes. streams: (start, end,
    symbols, table id); returns each stream's bytes."""
    if not streams:
        return []
    count = np.array([s[2] for s in streams], np.int64)
    order, sc = _by_count(count)
    lanes = _Lanes(win, data, [s[0] for s in streams],
                   [s[1] for s in streams], order)
    base = np.cumsum([0] + [len(t[0]) for t in tables])[:-1]
    sym_all = np.concatenate([t[0] for t in tables]).astype(np.uint8)
    len_all = np.concatenate([t[1] for t in tables])
    tid = np.array([s[3] for s in streams], np.int64)[order]
    off = base.astype(np.int64)[tid]
    log = np.array([t[2] for t in tables], np.int64)[tid]
    steps = int(sc[0])
    out = np.zeros((steps, len(streams)), np.uint8)
    m = len(streams)
    for i in range(steps):
        while sc[m - 1] <= i:
            m -= 1
        idx = off[:m] + lanes.peek(log[:m], m)
        out[i, :m] = sym_all[idx]
        lanes.at[:m] -= len_all[idx]
    _need(bool((lanes.at == lanes.lo).all()),
          "Huffman stream does not end on its last symbol")
    res = [b""] * len(streams)
    for k, lane in enumerate(order.tolist()):
        res[lane] = out[:sc[k], k].tobytes()
    return res


# ---- sequences ----------------------------------------------------------------

def _decode_sequences(data, win, blocks) -> list:
    """Every sequence bitstream of a frame, as lanes. blocks: (start, end,
    nb_seq, (LL, OF, ML) tables); returns per block (ll, of_value, ml)."""
    if not blocks:
        return []
    nseq = np.array([b[2] for b in blocks], np.int64)
    order, sc = _by_count(nseq)
    lanes = _Lanes(win, data, [b[0] for b in blocks], [b[1] for b in blocks],
                   order)
    flat = []
    for k in range(3):
        tabs = [blocks[j][3][k] for j in order.tolist()]
        base = np.cumsum([0] + [len(t.sym) for t in tabs])[:-1]
        flat.append((np.concatenate([t.sym for t in tabs]),
                     np.concatenate([t.nb for t in tabs]),
                     np.concatenate([t.base for t in tabs]),
                     base.astype(np.int64),
                     np.array([t.log for t in tabs], np.int64)))
    (ls, lnb, lb, lo, llog), (os_, onb, ob, oo, olog), \
        (ms, mnb, mb, mo, mlog) = flat
    B = len(blocks)
    sl = lo + lanes.read(llog, B)
    so = oo + lanes.read(olog, B)
    sm = mo + lanes.read(mlog, B)
    steps = int(sc[0])
    ll = np.zeros((steps, B), np.int64)
    of = np.zeros_like(ll)
    ml = np.zeros_like(ll)
    m = B
    for i in range(steps):
        while sc[m - 1] <= i:
            m -= 1
        m2 = m                       # lanes past their last sequence
        while m2 and sc[m2 - 1] <= i + 1:
            m2 -= 1
        llc, ofc, mlc = ls[sl[:m]], os_[so[:m]], ms[sm[:m]]
        of[i, :m] = (1 << ofc) + lanes.read(ofc, m)
        nml, nll = ML_BITS[mlc], LL_BITS[llc]
        v = lanes.read(nml + nll, m)
        ml[i, :m] = ML_BASE[mlc] + (v >> nll)
        ll[i, :m] = LL_BASE[llc] + (v & ((1 << nll) - 1))
        if m2:
            a, b, c = sl[:m2], sm[:m2], so[:m2]
            na, nb, nc = lnb[a], mnb[b], onb[c]
            v = lanes.read(na + nb + nc, m2)
            sl[:m2] = lo[:m2] + lb[a] + (v >> (nb + nc))
            sm[:m2] = mo[:m2] + mb[b] + ((v >> nc) & ((1 << nb) - 1))
            so[:m2] = oo[:m2] + ob[c] + (v & ((1 << nc) - 1))
    _need(bool((lanes.at == lanes.lo).all()),
          "sequence bitstream does not end on its last sequence")
    res = [None] * B
    for k, blk in enumerate(order.tolist()):
        n = int(sc[k])
        res[blk] = (ll[:n, k], of[:n, k], ml[:n, k])
    return res


# ---- frames ----------------------------------------------------------------

def _frame_header(data: bytes, pos: int):
    """(position after the header, window size, content size or None,
    checksum flag)."""
    _need(pos + 5 <= len(data), "frame header truncated")
    _need(int.from_bytes(data[pos:pos + 4], "little") == ZSTD_MAGIC,
          "not a zstd frame")
    fhd = data[pos + 4]
    _need(not fhd & 0x08, "reserved bit set")
    single = bool(fhd & 0x20)
    p = pos + 5
    window = None
    if not single:
        wd = data[p]
        exp = 10 + (wd >> 3)
        window = (1 << exp) + ((1 << exp) >> 3) * (wd & 7)
        p += 1
    did = (0, 1, 2, 4)[fhd & 3]
    _need(did == 0, "frames with a dictionary are not judged here")
    p += did
    fcs_size = (1 if single else 0, 2, 4, 8)[fhd >> 6]
    content = None
    if fcs_size:
        content = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            content += 256
        p += fcs_size
    if single:
        window = content
    return p, window, content, bool(fhd & 0x04)


def _literals_header(data: bytes, p: int):
    """(kind, regenerated size, compressed size, streams, header bytes)."""
    b0 = data[p]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            return kind, b0 >> 3, 0, 0, 1
        if fmt == 1:
            return kind, (b0 >> 4) + (data[p + 1] << 4), 0, 0, 2
        return kind, (b0 >> 4) + (data[p + 1] << 4) + (data[p + 2] << 12), \
            0, 0, 3
    if fmt < 2:
        h = int.from_bytes(data[p:p + 3], "little")
        return kind, (h >> 4) & 0x3FF, (h >> 14) & 0x3FF, \
            1 if fmt == 0 else 4, 3
    if fmt == 2:
        h = int.from_bytes(data[p:p + 4], "little")
        return kind, (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF, 4, 4
    h = int.from_bytes(data[p:p + 5], "little")
    return kind, (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF, 4, 5


def _sequences_header(data: bytes, p: int, end: int, prev: list):
    """(nb_seq, (LL, OF, ML) tables, position of the bitstream). `prev`
    holds the frame's last tables, for the repeat mode; it is updated."""
    _need(p < end, "sequences section missing")
    b0 = data[p]
    if b0 < 128:
        nb, p = b0, p + 1
    elif b0 < 255:
        nb, p = ((b0 - 128) << 8) + data[p + 1], p + 2
    else:
        nb, p = data[p + 1] + (data[p + 2] << 8) + 0x7F00, p + 3
    if nb == 0:
        _need(p == end, "sequences section: trailing bytes")
        return 0, None, p
    _need(p < end, "sequences section: modes missing")
    modes = data[p]
    _need(modes & 3 == 0, "sequences section: reserved bits set")
    p += 1
    tables = []
    for k, default in enumerate((LL_DEFAULT, OF_DEFAULT, ML_DEFAULT)):
        mode = (modes >> (6 - 2 * k)) & 3
        max_sym, max_log = TABLE_LIMITS[k]
        if mode == 0:
            t = fse_table(*default)
        elif mode == 1:
            _need(p < end and data[p] <= max_sym, "RLE symbol out of range")
            t = rle_table(data[p])
            p += 1
        elif mode == 2:
            counts, log, used = read_ncount(data[p:end], max_sym, max_log)
            t = fse_table(counts, log)
            p += used
        else:
            _need(prev[k] is not None, "repeat mode without a table")
            t = prev[k]
        prev[k] = t
        tables.append(t)
    return nb, tuple(tables), p


def _parse_frame(data: bytes, pos: int, tables: list, streams: list,
                 seq_lanes: list) -> dict:
    """Walk one frame's headers. Its Huffman tables, streams and sequence
    bitstreams are appended to the lists shared by all frames decoded
    together; the frame's plan refers to them by index."""
    p, window, content_size, checksum = _frame_header(data, pos)
    block_max = min(window or BLOCK_MAX, BLOCK_MAX)
    prev_tables = [None, None, None]
    huf = None                       # the last Huffman table (treeless)
    plan = []
    last = False
    while not last:
        _need(p + 3 <= len(data), "block header truncated")
        bh = int.from_bytes(data[p:p + 3], "little")
        last, btype, bsize = bool(bh & 1), (bh >> 1) & 3, bh >> 3
        p += 3
        _need(btype != 3, "reserved block type")
        if btype == 0:
            _need(bsize <= block_max and p + bsize <= len(data),
                  "raw block too large or truncated")
            plan.append(("lit", data[p:p + bsize]))
            p += bsize
            continue
        if btype == 1:
            _need(bsize <= block_max and p < len(data), "bad RLE block")
            plan.append(("lit", data[p:p + 1] * bsize))
            p += 1
            continue
        end = p + bsize
        _need(bsize <= block_max and end <= len(data),
              "compressed block too large or truncated")
        kind, regen, csize, nstreams, lh = _literals_header(data, p)
        _need(regen <= BLOCK_MAX, "literals too large")
        p += lh
        if kind == 0:
            lits = ("bytes", data[p:p + regen])
            _need(p + regen <= end, "raw literals truncated")
            p += regen
        elif kind == 1:
            lits = ("bytes", data[p:p + 1] * regen)
            p += 1
        else:
            _need(p + csize <= end, "literals truncated")
            body = p
            if kind == 2:
                sym, length, log, used = huffman_table(data, p)
                huf = len(tables)
                tables.append((sym, length, log))
                body += used
            _need(huf is not None, "treeless literals without a table")
            first = len(streams)
            if nstreams == 1:
                streams.append((body, p + csize, regen, huf))
            else:
                sizes = [int.from_bytes(data[body + 2 * i:body + 2 * i + 2],
                                        "little") for i in range(3)]
                body += 6
                sizes.append(p + csize - body - sum(sizes))
                _need(sizes[3] > 0, "bad jump table")
                seg = (regen + 3) // 4
                _need(regen >= 3 * seg, "too few literals for 4 streams")
                for i in range(4):
                    n = seg if i < 3 else regen - 3 * seg
                    streams.append((body, body + sizes[i], n, huf))
                    body += sizes[i]
            lits = ("streams", first, len(streams))
            p += csize
        nb, seq_tables, p = _sequences_header(data, p, end, prev_tables)
        if nb:
            seq_lanes.append((p, end, nb, seq_tables))
            plan.append(("seq", lits, len(seq_lanes) - 1, regen))
        else:
            plan.append(("seq", lits, None, regen))
        p = end
    if checksum:
        _need(p + 4 <= len(data), "checksum truncated")
        p += 4
    return {"plan": plan, "window": window, "content_size": content_size,
            "end": p}


def _execute(frame: dict, decoded: list, seqs: list) -> bytes:
    """The frame's content from its decoded literals and sequences."""
    window, content_size = frame["window"], frame["content_size"]
    out = bytearray()
    r0, r1, r2 = 1, 4, 8
    limit = window or (1 << 62)
    for step in frame["plan"]:
        if step[0] == "lit":
            out += step[1]
            continue
        _, lits, lane, regen = step
        if lits[0] == "bytes":
            lit = lits[1]
        else:
            lit = b"".join(decoded[lits[1]:lits[2]])
        _need(len(lit) == regen, "literals size mismatch")
        block_start = len(out)
        lp = 0
        if lane is not None:
            lls, ofs, mls = (a.tolist() for a in seqs[lane])
            for ll, ov, ml in zip(lls, ofs, mls):
                if ov > 3:
                    off = ov - 3
                    r0, r1, r2 = off, r0, r1
                elif ll:
                    if ov == 1:
                        off = r0
                    elif ov == 2:
                        off = r1
                        r0, r1 = r1, r0
                    else:
                        off = r2
                        r0, r1, r2 = r2, r0, r1
                elif ov == 1:
                    off = r1
                    r0, r1 = r1, r0
                elif ov == 2:
                    off = r2
                    r0, r1, r2 = r2, r0, r1
                else:
                    off = r0 - 1
                    r0, r1, r2 = off, r0, r1
                if ll:
                    if lp + ll > regen:
                        raise FormatError("literal lengths exceed literals")
                    out += lit[lp:lp + ll]
                    lp += ll
                n = len(out)
                if not 0 < off <= n or off > limit:
                    raise FormatError("offset outside the output or the "
                                      "window")
                if off >= ml:
                    out += out[n - off:n - off + ml]
                else:
                    out += (out[n - off:] * (ml // off + 1))[:ml]
        out += lit[lp:]
        _need(len(out) - block_start <= BLOCK_MAX, "block too large")
    _need(content_size is None or content_size == len(out),
          "content size mismatch")
    return bytes(out)


def _decode_at(data: bytes, starts: list) -> list:
    """The contents of the frames that start at `starts` in `data`, their
    bitstreams decoded together as lanes; with their ends."""
    win = _windows(data)
    tables, streams, seq_lanes = [], [], []
    frames = [_parse_frame(data, p, tables, streams, seq_lanes)
              for p in starts]
    decoded = _decode_huffman(data, win, streams, tables)
    seqs = _decode_sequences(data, win, seq_lanes)
    return [(_execute(f, decoded, seqs), f["end"]) for f in frames]


def decode(data: bytes) -> bytes:
    """The content of every frame in `data`, skippable frames skipped."""
    _need(len(data) > 0, "empty input")
    starts = []
    pos = 0
    while pos < len(data):
        _need(pos + 8 <= len(data), "frame truncated")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + size
            _need(pos <= len(data), "skippable frame truncated")
            continue
        starts.append(pos)
        # the next frame starts where this one ends: walk its blocks
        pos = _parse_frame(data, pos, [], [], [])["end"]
    return b"".join(c for c, _ in _decode_at(data, starts))


def decode_each(frames: list) -> list:
    """The content of each one-frame buffer of `frames`, decoded together;
    a buffer that holds more or less than one frame raises."""
    starts, pos = [], 0
    for f in frames:
        starts.append(pos)
        pos += len(f)
    out = []
    for (content, end), p, f in zip(_decode_at(b"".join(frames), starts),
                                   starts, frames):
        _need(end == p + len(f), "bytes after the frame")
        out.append(content)
    return out


def verdicts(frames: list, inputs: list) -> list:
    """Whether each one-frame buffer of `frames` decodes to its input: all
    decoded together, or one by one where the reference refuses one."""
    try:
        return [c == x for c, x in zip(decode_each(frames), inputs)]
    except Exception:
        out = []
        for f, x in zip(frames, inputs):
            try:
                out.append(decode(f) == x)
            except Exception:          # a frame the reference refuses
                out.append(False)
        return out
