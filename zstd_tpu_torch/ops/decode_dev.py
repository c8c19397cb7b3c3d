"""Device decode: batched Huffman literal decode + sequence execution.

Counterpart of zstd_tpu/ops/decode_dev.py, the hot halves of zstd's
decoder (HUF_decompress4X/1X, ZSTD_execSequence) as batched device work:

  - Huffman: every literal stream of every block is a lane; lane l decodes
    n_syms[l] symbols backward from start_bits[l], one table lookup per
    symbol: idx = bits [pos - 11, pos) of the stream (bits below 0 are 0),
    emit lut_sym[lane_tab[l], idx], pos -= lut_len[lane_tab[l], idx].
    `huf_decode_streams` (a [L, max_syms] buffer) and `literal_pool` (each
    lane straight into its span of the frame's literal pool) launch
    csrc/huf_decode.cu (kernel 3) for CUDA tensors; for CPU tensors they
    run `huf_decode_plain` (and `assemble_pool`).
  - execSequence: every output byte's source is its literal, or, in a
    match, its periodic source (so self-overlap never chains); pointer
    doubling then resolves match bytes to their literal or history source
    in at most EXEC_ROUNDS + 1 rounds. `exec_sequences` launches
    csrc/exec_seq.cu (kernel 4) for CUDA tensors, which places the bytes
    from the sequences and doubles over a shrinking worklist; for CPU
    tensors it runs `exec_prepare` (torch scans over every byte) and
    `exec_resolve_plain`.

The layouts are the JAX package's, except that the Huffman lanes take the
stream bytes and the u8 tables with a lane -> table index instead of
per-lane window values and per-lane i32 tables (`huf_window_values` stays,
as the reference for the window the lanes read).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

MAX_TLOG = 11
EXEC_ROUNDS = 26
EXEC_CLASSES = 45      # where exec_sequences_stats' hop-count histogram starts


def huf_window_values(stream_bytes: torch.Tensor, tlog: int = MAX_TLOG
                      ) -> torch.Tensor:
    """i32[..., 8m + 1]: win[p] = value of bits [p - tlog, p) of the
    stream (bit p - 1 most significant, zero-padded below bit 0), i.e. the
    table index the backward reader uses at bit position p."""
    b = stream_bytes.to(torch.int64)
    bits = torch.stack([(b >> k) & 1 for k in range(8)], dim=-1)
    bits = bits.reshape(*b.shape[:-1], 8 * b.shape[-1])
    padded = torch.nn.functional.pad(bits, (tlog, 0))
    n = bits.shape[-1] + 1
    win = torch.zeros(*b.shape[:-1], n, dtype=torch.int64, device=b.device)
    for t in range(tlog):
        win += padded[..., t : t + n] << t
    return win.to(torch.int32)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}")


def huf_decode_plain(sb: torch.Tensor, start_bits: torch.Tensor,
                     n_syms: torch.Tensor, lut_sym: torch.Tensor,
                     lut_len: torch.Tensor, lane_tab: torch.Tensor,
                     max_syms: int):
    """The lockstep scan of zstd_tpu's huf_decode_streams, one torch step per
    symbol over all lanes. Past a lane's n_syms its position stays and the
    symbol there repeats, as in the JAX scan. Same contract as
    `huf_decode_streams`."""
    L, byte_cap = sb.shape
    dev = sb.device
    W = 8 * byte_cap + 1
    # 24-bit little-endian words of the stream with two zero bytes in front:
    # bits [p - 11, p) of the stream are bits [p + 5, p + 16) of the padded
    # bytes, inside the word at byte (p + 5) >> 3
    pb = torch.nn.functional.pad(sb.to(torch.int64), (2, 2))
    word = pb[:, :-2] | (pb[:, 1:-1] << 8) | (pb[:, 2:] << 16)
    tab = lane_tab.to(torch.int64).clamp(0, lut_sym.shape[0] - 1)[:, None]
    flat_sym = lut_sym.to(torch.int64).reshape(-1)
    flat_len = lut_len.to(torch.int64).reshape(-1)
    base = tab[:, 0] * (1 << MAX_TLOG)
    pos = start_bits.to(torch.int64)
    nsy = n_syms.to(torch.int64)
    syms = torch.zeros((L, max_syms), dtype=torch.uint8, device=dev)

    def lookup(pos):
        q = pos.clamp(0, W - 1) + 5
        w = torch.gather(word, 1, (q >> 3)[:, None])[:, 0]
        idx = (w >> (q & 7)) & ((1 << MAX_TLOG) - 1)
        return flat_sym[base + idx], flat_len[base + idx]

    steps = min(int(nsy.max()) if L else 0, max_syms)
    for i in range(max(steps, 0)):
        sym, ln = lookup(pos)
        syms[:, i] = sym.to(torch.uint8)
        pos = torch.where(i < nsy, pos - ln, pos)
    if steps < max_syms and L:
        sym, _ = lookup(pos)
        col = torch.arange(max_syms, device=dev)[None, :]
        syms = torch.where(col >= torch.clamp(nsy, min=0)[:, None],
                           sym.to(torch.uint8)[:, None], syms)
    return syms, pos.to(torch.int32)


def _huf_check(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
               max_syms, what):
    """Validate kernel 3's inputs on the card; returns the library."""
    L, byte_cap = sb.shape
    T = lut_sym.shape[0]
    dev = sb.device
    for name, t, dt, shape in (("sb", sb, torch.uint8, (L, byte_cap)),
                               ("start_bits", start_bits, torch.int32, (L,)),
                               ("n_syms", n_syms, torch.int32, (L,)),
                               ("lut_sym", lut_sym, torch.uint8,
                                (T, 1 << MAX_TLOG)),
                               ("lut_len", lut_len, torch.uint8,
                                (T, 1 << MAX_TLOG)),
                               ("lane_tab", lane_tab, torch.int32, (L,))):
        _check(f"{what}: {name}", t, dt, shape, dev)
    if byte_cap % 16 or sb.data_ptr() % 16 or lut_sym.data_ptr() % 4 \
            or lut_len.data_ptr() % 4 or T == 0 or max_syms < 0:
        raise ValueError(f"{what}: byte_cap must be a multiple of 16, sb "
                         "16-byte aligned, the tables 4-byte aligned, T > 0")
    lib = _kernels.get("huf_decode.cu")
    if lib.huf_decode_threads(byte_cap) > 1024 \
            or lib.huf_decode_smem_bytes(byte_cap) > _kernels.SMEM_LIMIT:
        raise ValueError(f"{what}: byte_cap {byte_cap} is too large for one "
                         "CTA a lane")
    # a zero length would stall a walk; the host never builds one
    if bool((lut_len == 0).any()):
        raise ValueError(f"{what}: a Huffman table holds a code length of 0")
    return lib


def _huf_launch(lib, sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                max_syms, out, out_base, stats=None, host=None):
    """One launch of kernel 3: lane l's symbols to out[out_base[l] + i];
    `host` = (seg_start, seg_src, seg_is_dev, host_lits, lim) also copies
    the pool's raw/RLE spans. Returns final i32[L]."""
    L, byte_cap = sb.shape
    final = torch.empty(L, dtype=torch.int32, device=sb.device)
    seg_start = seg_src = seg_dev = hl = None
    H = S = lim = 0
    if host is not None:
        seg_start, seg_src, seg_dev, hl, lim = host
        S, H = seg_start.shape[0], hl.shape[0]
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(sb.device):
        stream = torch.cuda.current_stream(sb.device).cuda_stream
        err = lib.huf_decode_launch(
            sb.data_ptr(), start_bits.data_ptr(), n_syms.data_ptr(),
            lut_sym.data_ptr(), lut_len.data_ptr(), lane_tab.data_ptr(),
            out_base.data_ptr(), out.data_ptr(), out.numel(),
            final.data_ptr(), ptr(stats), L, byte_cap, max_syms,
            lut_sym.shape[0], ptr(seg_start), ptr(seg_src), ptr(seg_dev),
            ptr(hl), H, S, lim, ctypes.c_void_p(stream))
    _kernels.check(err, "huf_decode_launch")
    _kernels.LAUNCHES["huf_decode"] += 1
    return final


def huf_decode_streams(sb: torch.Tensor, start_bits: torch.Tensor,
                       n_syms: torch.Tensor, lut_sym: torch.Tensor,
                       lut_len: torch.Tensor, lane_tab: torch.Tensor,
                       max_syms: int):
    """Decode many backward Huffman streams.

    sb:         u8[L, byte_cap]  stream bytes per lane, zero padded
    start_bits: i32[L]           initial bit position (useful bits)
    n_syms:     i32[L]           symbols to decode per lane
    lut_sym, lut_len: u8[T, 2048] decode tables at the 11-bit window
    lane_tab:   i32[L]           lane -> table
    Returns (u8[L, max_syms] symbols, i32[L] final bit position: 0 for a
    well-formed stream, negative when the stream under-ran, since the window
    read clamps instead of trapping). Only syms[l, :n_syms[l]] is defined;
    CPU tensors take `huf_decode_plain`, CUDA tensors launch
    csrc/huf_decode.cu (rows l * max_syms of one buffer) or raise."""
    if sb.device.type == "cpu":
        return huf_decode_plain(sb, start_bits, n_syms, lut_sym, lut_len,
                                lane_tab, max_syms)
    return huf_decode_stats(sb, start_bits, n_syms, lut_sym, lut_len,
                            lane_tab, max_syms, stats=False)[:2]


def huf_decode_stats(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                     max_syms: int, stats: bool = True):
    """`huf_decode_streams` on the card, plus the kernel's counts per lane
    (i32[L, 4]: segments, repair rounds, longest speculative walk, critical
    path in dependent steps; tests/hufmodel.py gives the same). CUDA
    only."""
    if sb.device.type != "cuda":
        raise ValueError(f"huf_decode_streams: unsupported device {sb.device}")
    lib = _huf_check(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                     max_syms, "huf_decode_streams")
    L = sb.shape[0]
    syms = torch.empty((L, max_syms), dtype=torch.uint8, device=sb.device)
    base = torch.arange(L, dtype=torch.int64, device=sb.device) * max_syms
    st = torch.empty((L, 4), dtype=torch.int32, device=sb.device) \
        if stats else None
    final = _huf_launch(lib, sb, start_bits, n_syms, lut_sym, lut_len,
                        lane_tab, max_syms, syms, base, st)
    return syms, final, st


def literal_pool(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                 seg_start, seg_lane, seg_src, seg_is_dev, host_lits, nb_lit,
                 max_syms: int, npad: int):
    """The frame-global literal pool u8[npad] and the lanes' final bit
    positions i32[L]: the Huffman lanes (as `huf_decode_streams`) placed by
    the pool segments, and the host's raw/RLE bytes (as `assemble_pool`).

    CPU tensors take assemble_pool(huf_decode_plain(...)). CUDA tensors
    launch csrc/huf_decode.cu once, each lane writing its symbols straight
    at its dev segment's start (one small scatter of seg_start by seg_lane
    over the segments), and the host spans copied alongside; no [L,
    max_syms] buffer. The two pools are equal on [0, nb_lit) for groups
    the host parse builds: there the segments are nonempty, in increasing
    start order from 0, tile [0, nb_lit), and each dev segment is exactly
    its lane's n_syms symbols. They may differ at and past nb_lit (the
    plain version repeats the last segment's bytes up to npad, the kernel
    leaves zeros) and, for other inputs, inside a dev segment past its
    lane's n_syms or before the first start. No sequence reads those: the
    executor reads the pool by literal rank, and the literal positions of
    such a group number sum(ll) = nb_lit."""
    if sb.device.type == "cpu":
        syms, final = huf_decode_plain(sb, start_bits, n_syms, lut_sym,
                                       lut_len, lane_tab, max_syms)
        return assemble_pool(syms, seg_start, seg_lane, seg_src, seg_is_dev,
                             host_lits, npad), final
    if sb.device.type != "cuda":
        raise ValueError(f"literal_pool: unsupported device {sb.device}")
    lib = _huf_check(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                     max_syms, "literal_pool")
    L = sb.shape[0]
    S = seg_start.shape[0]
    dev = sb.device
    for name, t, dt in (("seg_start", seg_start, torch.int32),
                        ("seg_lane", seg_lane, torch.int32),
                        ("seg_src", seg_src, torch.int32),
                        ("seg_is_dev", seg_is_dev, torch.bool)):
        _check(f"literal_pool: {name}", t, dt, (S,), dev)
    _check("literal_pool: host_lits", host_lits, torch.uint8,
           (host_lits.shape[0],), dev)
    if host_lits.shape[0] == 0 or S == 0:
        raise ValueError("literal_pool: need segments and host_lits")
    # lane -> its dev segment's start; lanes without one write nothing
    base = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
    base.scatter_reduce_(0, torch.where(seg_is_dev, seg_lane.long(), L)
                         .clamp(0, L), seg_start.long(), reduce="amax")
    pool = torch.zeros(npad, dtype=torch.uint8, device=dev)
    lim = min(max(int(nb_lit), 0), npad)
    final = _huf_launch(lib, sb, start_bits, n_syms, lut_sym, lut_len,
                        lane_tab, max_syms, pool, base[:L],
                        host=(seg_start, seg_src, seg_is_dev, host_lits, lim))
    return pool, final


def assemble_pool(syms: torch.Tensor, seg_start: torch.Tensor,
                  seg_lane: torch.Tensor, seg_src: torch.Tensor,
                  seg_is_dev: torch.Tensor, host_lits: torch.Tensor,
                  npad: int) -> torch.Tensor:
    """The frame-global literal pool u8[npad], built on the device from the
    Huffman lanes plus the host's raw/RLE literal bytes. Segments are pool
    spans in increasing start order: dev segments read lane `seg_lane`'s
    symbols, host segments read `host_lits[seg_src + within]`. Starts equal
    to `npad` are padding (their marker lands in a slot that is dropped)."""
    S = seg_start.shape[0]
    dev = syms.device
    starts = seg_start.to(torch.int64)
    marker = torch.full((npad + 1,), -1, dtype=torch.int64, device=dev)
    marker.scatter_reduce_(0, starts.clamp(0, npad),
                           torch.arange(S, device=dev), reduce="amax")
    seg = torch.cummax(marker[:npad], dim=0).values.clamp(0, S - 1)
    pos = torch.arange(npad, device=dev)
    within = pos - starts[seg]
    msyms = syms.shape[1]
    flat = seg_lane.to(torch.int64)[seg] * msyms + within.clamp(0, msyms - 1)
    dev_val = syms.reshape(-1)[flat.clamp(0, syms.numel() - 1)]
    hv = host_lits[(seg_src.to(torch.int64)[seg] + within)
                   .clamp(0, host_lits.shape[0] - 1)]
    return torch.where(seg_is_dev[seg], dev_val, hv)


def exec_prepare(lits: torch.Tensor, ll: torch.Tensor, ml: torch.Tensor,
                 off: torch.Tensor, nb_seq, out_len, n: int):
    """The positional half of exec_sequences (decode_dev.py:161-218), as
    torch ops in int64: (ptr i32[n] each byte's first source (negative:
    history), in_match bool[n], placed u8[n] the literal bytes at their
    positions, zero elsewhere)."""
    dev = lits.device
    seq_cap = ll.shape[0]
    k = torch.arange(seq_cap, device=dev)
    vmask = k < int(nb_seq)
    llv = torch.where(vmask, ll.to(torch.int64), 0)
    mlv = torch.where(vmask, ml.to(torch.int64), 0)
    span = llv + mlv
    seq_end = torch.cumsum(span, 0)
    match_start = seq_end - span + llv      # where the match part begins
    pos = torch.arange(n, device=dev)

    # literal placement: a position is a literal iff no match covers it
    has_match = vmask & (mlv > 0)
    cov = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    cov.index_add_(0, torch.where(has_match, match_start, n).clamp(0, n),
                   torch.ones(seq_cap, dtype=torch.int64, device=dev))
    cov.index_add_(0, torch.where(has_match, match_start + mlv, n)
                   .clamp(0, n),
                   torch.full((seq_cap,), -1, dtype=torch.int64, device=dev))
    in_match = torch.cumsum(cov[:n], 0) > 0
    is_lit = ~in_match & (pos < int(out_len))
    lit_rank = torch.cumsum(is_lit.to(torch.int64), 0) - 1
    placed = torch.where(
        is_lit, lits[lit_rank.clamp(0, min(n, lits.shape[0]) - 1)],
        torch.zeros((), dtype=torch.uint8, device=dev))

    # the match covering each byte: each match's sequence index scattered at
    # its start, then a running max (a start counter would miss zero-match
    # pseudo-sequences)
    marker = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    marker.scatter_reduce_(0, torch.where(has_match, match_start, n)
                           .clamp(0, n), k, reduce="amax")
    mid = torch.cummax(marker[:n], dim=0).values.clamp(0, seq_cap - 1)
    m_start = match_start[mid]
    m_off = torch.where(vmask[mid], off.to(torch.int64)[mid], 1).clamp(min=1)
    # periodic-source rewrite: j's source is start - off + ((j - start) mod
    # off), always before the match start (self-overlap safe); exact in
    # integers, since j - start < ml <= 128 KiB
    src = m_start - m_off + torch.remainder(pos - m_start, m_off)
    ptr = torch.where(in_match, src, pos)
    return ptr.to(torch.int32), in_match, placed


def exec_resolve_plain(ptr: torch.Tensor, in_match: torch.Tensor,
                       placed: torch.Tensor, history: torch.Tensor,
                       out_len, rounds: int | None = None):
    """Pointer doubling (decode_dev.py:220-240), one torch step per round,
    over the positional half from `exec_prepare`: ptr i32[n], in_match
    bool[n], placed u8[n], history u8[h] (h >= 1). Returns (out u8[n], ok,
    rounds run); the rest of the contract is `exec_sequences`'s."""
    rounds = EXEC_ROUNDS if rounds is None else rounds
    n = ptr.shape[0]
    h = history.shape[0]
    p = ptr.to(torch.int64)

    def step(p):
        return torch.where(p < 0, p, p[p.clamp(0, n - 1)])

    r = 0
    cont = bool(in_match.any())
    while cont:
        nxt = step(p)
        changed = bool((nxt != p).any())
        p = nxt
        cont = changed and r < rounds
        r += 1
    pos = torch.arange(n, device=ptr.device)
    ok = ((p == step(p)) | (pos >= int(out_len))).all()
    hist_vals = history[(h + p.clamp(max=-1)).clamp(0, h - 1)]
    vals = torch.where(in_match, placed[p.clamp(0, n - 1)], placed)
    return torch.where(p < 0, hist_vals, vals), ok, r


def exec_sequences(lits: torch.Tensor, ll: torch.Tensor, ml: torch.Tensor,
                   off: torch.Tensor, nb_seq, out_len, n: int,
                   history: torch.Tensor, rounds: int | None = None):
    """Execute sequences against device-resident literals
    (decode_dev.py:150; its nb_lit and hist_len arguments are unused there
    and left out here).

    lits u8[n] (the literals in order); ll/ml/off i32[seq_cap]: litLength /
    matchLength / ABSOLUTE offset; history u8[h]: the bytes before position
    0 that the sequences may reference. Doubling rounds run while one
    changes a pointer, at most `rounds` + 1 of them (default EXEC_ROUNDS,
    read at call time). Returns (out u8[n], ok bool scalar: False when the
    dependency depth exceeded the rounds, rounds run: an int from the plain
    version, an i32 scalar on the card from the kernel). CPU tensors take
    `exec_prepare` + `exec_resolve_plain`; CUDA tensors launch
    csrc/exec_seq.cu once after O(seq_cap) prefix sums, or raise."""
    if lits.device.type == "cpu":
        ptr, in_match, placed = exec_prepare(lits, ll, ml, off, nb_seq,
                                             out_len, n)
        return exec_resolve_plain(ptr, in_match, placed, history, out_len,
                                  rounds)
    return exec_sequences_stats(lits, ll, ml, off, nb_seq, out_len, n,
                                history, rounds, stats=False)[:3]


def exec_sequences_stats(lits, ll, ml, off, nb_seq, out_len, n: int,
                         history, rounds: int | None = None,
                         stats: bool = True):
    """`exec_sequences` on the card, plus the kernel's counts (i32, see
    csrc/exec_seq.cu): [0] rounds run, [1] 1 if a match byte below out_len
    stayed unresolved, [2] the most hops from a byte to its source, [3]
    passes, [4 + t] the entries of pass t's worklist; with `stats`, also
    [EXEC_CLASSES + c] the match bytes whose hop count d has ceil(log2 d)
    == c (those with c > t are the pointers that round t of the
    out-of-place doubling changes), the ns of its three phases (place,
    passes, gather) and last the grid size. CUDA only."""
    rounds = EXEC_ROUNDS if rounds is None else rounds
    dev = lits.device
    if dev.type != "cuda":
        raise ValueError(f"exec_sequences: unsupported device {dev}")
    seq_cap = ll.shape[0]
    h = history.shape[0]
    for name, t, dt, shape in (("lits", lits, torch.uint8, lits.shape),
                               ("ll", ll, torch.int32, (seq_cap,)),
                               ("ml", ml, torch.int32, (seq_cap,)),
                               ("off", off, torch.int32, (seq_cap,)),
                               ("history", history, torch.uint8, (h,))):
        _check(f"exec_sequences: {name}", t, dt, shape, dev)
    if lits.dim() != 1 or lits.shape[0] == 0 or h == 0 \
            or not 0 < n < (1 << 31) - 1 or rounds < 0:
        raise ValueError("exec_sequences: need 1-D lits, a history, "
                         "0 < n < 2^31 - 1 and rounds >= 0")
    nb = min(max(int(nb_seq), 0), seq_cap)
    vmask = torch.arange(seq_cap, device=dev) < nb
    llv = torch.where(vmask, ll.long(), 0)
    mlv = torch.where(vmask, ml.long(), 0)
    # the kernel places bytes by binary search over the sequence ends,
    # which needs them in order
    if bool(((llv < 0) | (mlv < 0)).any()):
        raise ValueError("exec_sequences: a negative literal or match "
                         "length; the kernel takes lengths >= 0")
    cs = torch.cumsum(llv + mlv, 0)
    seq_end = cs.clamp(max=n).int()
    mstart = (cs - mlv).clamp(max=n).int()
    lit_start = torch.zeros(seq_cap + 1, dtype=torch.int64, device=dev)
    lit_start[1:] = torch.cumsum(llv, 0)
    lit_start = lit_start.clamp(max=n).int()
    pairs = torch.empty(n, dtype=torch.int64, device=dev)
    lists = torch.empty((3, (n + 3) // 4 * 4), dtype=torch.int32,
                        device=dev)            # rows 16-byte aligned
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    lib = _kernels.get("exec_seq.cu")
    ctrl = torch.empty(lib.exec_seq_ctrl_len(), dtype=torch.int32,
                       device=dev)
    diag = torch.empty(lib.exec_seq_stats_len(), dtype=torch.int32,
                       device=dev) if stats else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.exec_seq_launch(
            lits.data_ptr(), lits.shape[0], seq_end.data_ptr(),
            mstart.data_ptr(), lit_start.data_ptr(), off.data_ptr(), nb,
            pairs.data_ptr(), lists[0].data_ptr(), lists[1].data_ptr(),
            lists[2].data_ptr(), history.data_ptr(), h, out.data_ptr(),
            ok.data_ptr(), ctrl.data_ptr(),
            None if diag is None else diag.data_ptr(), n,
            min(max(int(out_len), 0), n), int(rounds),
            ctypes.c_void_p(stream))
    _kernels.check(err, "exec_seq_launch")
    _kernels.LAUNCHES["exec_seq"] += 1
    return out, ok[0], ctrl[0], ctrl if diag is None else torch.cat([ctrl,
                                                                     diag])


def fused_frame_decode(sb, start_bits, n_syms, n_lanes, lut_sym, lut_len,
                       lane_tab, seg_start, seg_lane, seg_src, seg_is_dev,
                       host_lits, nb_lit, lls, mls, offs, nb_seq, out_len,
                       max_syms: int, n: int):
    """A group of frames decoded on the device (decode_dev.py:118): the
    Huffman lanes and the literal pool (`literal_pool`: on the card one
    launch of kernel 3 that writes each lane's symbols at its pool span),
    then the frame-global sequence executor (`exec_sequences`: on the card
    one launch of kernel 4). Returns (out u8[n], ok bool scalar, final
    i32[L]); ok folds in the Huffman check (every active lane's stream ends
    exactly at bit 0). nb_lit, the pool's literal count, bounds the pool's
    host spans on the card; the CPU path, as the JAX program, ignores it."""
    pool, final = literal_pool(sb, start_bits, n_syms, lut_sym, lut_len,
                               lane_tab, seg_start, seg_lane, seg_src,
                               seg_is_dev, host_lits, nb_lit, max_syms, n)
    out, ok, _ = exec_sequences(pool, lls, mls, offs, nb_seq, out_len, n,
                                torch.zeros(1, dtype=torch.uint8,
                                            device=sb.device))
    lane_active = torch.arange(sb.shape[0], device=sb.device) < int(n_lanes)
    hufok = torch.where(lane_active, final == 0, True).all()
    return out, ok & hufok, final
