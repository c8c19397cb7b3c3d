"""Device decode: frames parsed on the host, the rest on the device.

Counterpart of zstd_tpu/device_decoder.py on PyTorch. The split is that of
zstd's decoder, C orchestration around vectorized inner loops
(lib/decompress/zstd_decompress.c:951 frame walk; huf_decompress.c hot
loops; zstd_decompress_block.c:1001 ZSTD_execSequence):

  host:   frame and block headers, literal-section headers, Huffman table
          descriptions, FSE sequence decode + repcode resolution (byte
          serial, a few KB per block; in the port's copy of native/decode.c,
          csrc/host/decode.c, as zstd_tpu does; _parse_frame_plain runs the
          copied Python branch instead)
  device: ops/decode_dev.fused_frame_decode for each group of frames: every
          literal stream of every block decoded by the Huffman lane kernel,
          the literal pool assembled on the device, and the frame-global
          sequence executor with the pointer-doubling kernel. Decoded
          literals never cross to the host: the only copy back is the
          output (or only the ok flag for device-resident consumers).

Frames of any zstd encoder are accepted. A frame whose blocks exceed a device
limit (a literal stream over _STREAM_CAP) is decoded on the host by the
copied Python decoder, and counted in COUNTS["host_frames"].

Every device step runs on the device of the caller's choosing: `cuda` (the
default; raises if there is none) or `cpu` (the kernels' plain versions).
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .constants import BT_COMPRESSED, BT_RAW, BT_RLE
from .errors import Corruption, ZstdError, ZstdErrorCode
from .format import huffman
from .format import literals as litmod
from .format import sequences as sq
from .format.frame import decompress_frame, is_skippable, parse_frame_header
from .format.matchfinder import resolve_offset, update_reps
from .ops.decode_dev import MAX_TLOG, fused_frame_decode
from .pipeline import _resolve_device
from .xxhash64 import content_checksum

_STREAM_CAP = 36 * 1024            # bytes per Huffman stream (4X of 128K)
# one fused decode covers up to this much decoded content; larger groups
# split so that device buffers stay bounded
_GROUP_CONTENT_CAP = 32 << 20

# frames the device could not take, decoded on the host instead
COUNTS = {"host_frames": 0}


def _expand_lut(dt: huffman.HufDTable) -> tuple[np.ndarray, np.ndarray]:
    """Scale a 2^tlog LUT up to the fixed 2^MAX_TLOG device window.
    uint8 both ways (symbols are bytes, lengths <= 11) so the per-frame
    table upload stays tiny."""
    shift = MAX_TLOG - dt.table_log
    idx = np.arange(1 << MAX_TLOG) >> shift
    return dt.symbol[idx].astype(np.uint8), dt.length[idx].astype(np.uint8)


class _DeviceUnsupported(Exception):
    """Block shape the device kernels cannot take; the frame goes to the
    host decoder (module contract: never a user-facing error by itself)."""


def _parse_literals_section(payload: bytes, hst: litmod.HufDecodeState):
    """Like decode_literals but WITHOUT running the Huffman streams: returns
    (kind, lit_bytes_or_None, (streams, dtable)|None, regen, consumed,
    next_state). kind: 'raw' | 'huf'."""
    if not payload:
        raise Corruption("empty block payload")
    b0 = payload[0]
    block_type = b0 & 3
    if block_type in (litmod.LBT_RAW, litmod.LBT_RLE):
        lit, nxt, used = litmod.decode_literals(payload, hst)
        return "raw", lit, None, len(lit), used, nxt
    # compressed / treeless: parse header
    size_format = (b0 >> 2) & 3
    if size_format in (0, 1):
        if len(payload) < 3:
            raise Corruption("literals header truncated")
        h = int.from_bytes(payload[:3], "little")
        regen = (h >> 4) & 0x3FF
        csize = (h >> 14) & 0x3FF
        lh = 3
        single = size_format == 0
    elif size_format == 2:
        h = int.from_bytes(payload[:4], "little")
        regen = (h >> 4) & 0x3FFF
        csize = (h >> 18) & 0x3FFF
        lh = 4
        single = False
    else:
        h = int.from_bytes(payload[:5], "little")
        regen = (h >> 4) & 0x3FFFF
        csize = (h >> 22) & 0x3FFFF
        lh = 5
        single = False
    section = payload[lh : lh + csize]
    if len(section) < csize:
        raise Corruption("literals section truncated")
    if block_type == litmod.LBT_COMPRESSED:
        nb_bits, nsym, tlog, tree_used = huffman.read_tree_description(section)
        dt = huffman.build_huf_dtable(nb_bits, nsym, tlog)
        nxt = litmod.HufDecodeState(dt)
        body = section[tree_used:]
    else:  # treeless: reuse previous table
        if hst.dtable is None:
            raise Corruption("treeless literals without a previous table")
        dt = hst.dtable
        nxt = hst
        body = section
    if single:
        streams = [(body, regen)]
    else:
        if len(body) < 6:
            raise Corruption("4-stream literals: missing jump table")
        s1 = int.from_bytes(body[0:2], "little")
        s2 = int.from_bytes(body[2:4], "little")
        s3 = int.from_bytes(body[4:6], "little")
        seg = (regen + 3) // 4
        p = 6
        sizes = [s1, s2, s3, len(body) - 6 - s1 - s2 - s3]
        if sizes[3] <= 0:
            raise Corruption("4-stream literals: bad jump table")
        streams = []
        rem = regen
        for t in range(4):
            ln = min(seg, rem) if t < 3 else rem
            streams.append((body[p : p + sizes[t]], ln))
            rem -= ln
            p += sizes[t]
    return ("huf", None, (streams, dt), regen, lh + csize, nxt)


def _raise_device_failure(final: torch.Tensor, nl: int) -> None:
    """Turn a failed ok flag into the right typed error."""
    if nl and bool((final[:nl] != 0).any()):
        raise Corruption("huffman stream over-read (device decode)")
    raise Corruption("device exec: dependency depth exceeded")


def _parse_jobs(data: bytes, window_log_max: int):
    """Walk all frames: parse device-decodable ones, host-decode the rest.
    Returns [("dev", _ParsedFrame, csum_pos) | ("host", content, -1)] in
    order."""
    pos = 0
    jobs = []
    while pos < len(data):
        if is_skippable(data, pos):
            size = int.from_bytes(data[pos + 4 : pos + 8], "little")
            pos += 8 + size
            continue
        try:
            pf = _parse_frame(data, pos, window_log_max)
            p = pf.end_pos
            csum_pos = p if pf.hdr.checksum_flag else -1
            if pf.hdr.checksum_flag:
                p += 4
            pf.end_pos = p
            jobs.append(("dev", pf, csum_pos))
            pos = p
        except _DeviceUnsupported:
            content, pos = decompress_frame(data, pos, window_log_max)
            COUNTS["host_frames"] += 1
            jobs.append(("host", content, -1))
    return jobs


def _group_dev_jobs(jobs):
    """Split the job list into runs of consecutive device frames (bounded
    by _GROUP_CONTENT_CAP content bytes per fused decode) and host jobs."""
    groups = []
    run = []
    run_n = 0
    for job in jobs:
        if job[0] == "dev" and (not run or
                                run_n + job[1].n <= _GROUP_CONTENT_CAP):
            run.append(job)
            run_n += job[1].n
            continue
        if run:
            groups.append(("dev", run))
            run, run_n = [], 0
        if job[0] == "dev":
            run = [job]
            run_n = job[1].n
        else:
            groups.append(("host", job[1]))
    if run:
        groups.append(("dev", run))
    return groups


def device_decompress(data: bytes, window_log_max: int = 31,
                      device=None) -> bytes:
    """Decode all frames of `data` on `device` (default: the CUDA card;
    raises if there is none). Frames whose blocks exceed a device limit go
    to the host decoder (module contract above).

    Consecutive device-decodable frames fuse into one decode (the Huffman
    lanes of all of them in one launch), and every group is dispatched
    before any output is fetched."""
    dev = _resolve_device(device)
    if len(data) == 0:
        raise ZstdError(ZstdErrorCode.srcSize_wrong, "empty input")
    groups = _group_dev_jobs(_parse_jobs(data, window_log_max))
    dispatched = []
    for kind, payload in groups:
        if kind == "host":
            dispatched.append(("host", payload))
        else:
            dispatched.append(("dev", payload, *_dispatch_group(
                [pf for _, pf, _ in payload], dev)))
    out = bytearray()
    for d in dispatched:
        if d[0] == "host":
            out += d[1]
            continue
        _, run, outj, okj, finalj, nl = d
        if not bool(okj):
            _raise_device_failure(finalj, nl)
        arr = _fetch(outj[: sum(pf.n for _, pf, _ in run)])
        base = 0
        for _, pf, csum_pos in run:
            content = arr[base : base + pf.n].tobytes()
            base += pf.n
            if pf.hdr.frame_content_size is not None and \
                    len(content) != pf.hdr.frame_content_size:
                raise Corruption("decoded size mismatch")
            if csum_pos >= 0:
                stored = int.from_bytes(data[csum_pos : csum_pos + 4],
                                        "little")
                if stored != content_checksum(content):
                    raise ZstdError(ZstdErrorCode.checksum_wrong,
                                    "content checksum mismatch")
            out += content
    return bytes(out)


def _bucket(n: int, base: int = 4096) -> int:
    """Pad sizes to coarse power-of-two buckets (the JAX package's shapes,
    which the port keeps so the two can be compared)."""
    b = base
    while b < n:
        b *= 2
    return b


def device_decompress_resident(data: bytes, window_log_max: int = 31,
                               device=None):
    """Decode frames, leaving the output on the device (the shape for
    feeding decompressed bytes straight into a device input pipeline: no
    copy to the host, no host checksum). Returns (device uint8 tensor padded
    to a size bucket, content length, ok) — callers check `bool(ok)` after
    consuming; it folds in the Huffman over-read check, and
    `ok.error_kind()` tells a literal stream over-read from exec depth
    exhaustion. Multi-frame inputs fuse into one decode (up to
    _GROUP_CONTENT_CAP content; the first group only — content is the
    frames' outputs concatenated)."""
    dev = _resolve_device(device)
    if is_skippable(data, 0):
        raise ZstdError(ZstdErrorCode.prefix_unknown, "skippable frame")
    groups = _group_dev_jobs(_parse_jobs(data, window_log_max))
    if not groups or groups[0][0] != "dev":
        raise _DeviceUnsupported("no device-decodable leading frame")
    run = groups[0][1]
    outj, okj, finalj, nl = _dispatch_group([pf for _, pf, _ in run], dev)
    n = sum(pf.n for _, pf, _ in run)
    return outj, n, _ResidentOk(okj, finalj, nl)


class _ResidentOk:
    """Deferred ok flag for the resident path: truthiness fetches the
    fused decode's ok flag; `error_kind()` reports which check failed
    ('over-read' | 'exec-depth' | None) without changing the bool
    contract."""

    def __init__(self, okj, finalj, nl):
        self._okj = okj
        self._finalj = finalj
        self._nl = nl

    def __bool__(self) -> bool:
        return bool(self._okj)

    def error_kind(self) -> str | None:
        if bool(self._okj):
            return None
        if self._nl and bool((self._finalj[: self._nl] != 0).any()):
            return "over-read"
        return "exec-depth"


class _ParsedFrame:
    """Host-side parse of one frame, ready to merge into a fused dispatch."""
    __slots__ = ("lanes", "lane_tab", "tables", "segs", "host_pool",
                 "pool_len", "ll", "ml", "off", "n", "end_pos", "hdr")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _parse_frame(data: bytes, pos: int, window_log_max: int) -> _ParsedFrame:
    """Parse one frame's blocks on the host: literal streams, Huffman tables,
    pool segments, and the frame-global sequence arrays (FSE sequence
    decode + repcode resolution in C, one decoder context a frame, whose
    tables and repcodes carry from block to block). No device work."""
    ctx = native.dctx_new()
    try:
        def sequences(section: bytes):
            res = native.decode_sequences(ctx, section)
            if res is None:
                raise Corruption("sequences section decode failed")
            return res
        return _parse_blocks(data, pos, window_log_max, sequences)
    finally:
        native.dctx_free(ctx)


class _PlainSequences:
    """The Python branch of a frame's sequence decode: the copied FSE
    decode and the repcode loop, with the tables and repcodes they carry
    from block to block."""

    def __init__(self):
        self.fst = sq.FseDecodeState()
        self.reps = (1, 4, 8)

    def __call__(self, section: bytes):
        nb, self.fst, c2 = sq.parse_sequences_section(section, self.fst)
        if not nb:
            return (np.zeros(0, np.int64),) * 3
        lls, obs, mls = sq.decode_sequences(section[c2:], nb, self.fst)
        offs = np.zeros(nb, np.int64)
        r = self.reps
        for i in range(nb):
            offs[i] = resolve_offset(r, int(obs[i]), int(lls[i]))
            r = update_reps(r, int(obs[i]), int(lls[i]))
        self.reps = r
        return lls, mls, offs


def _parse_frame_plain(data: bytes, pos: int,
                       window_log_max: int) -> _ParsedFrame:
    """_parse_frame with the Python branch of the sequence decode."""
    return _parse_blocks(data, pos, window_log_max, _PlainSequences())


def _parse_blocks(data: bytes, pos: int, window_log_max: int,
                  sequences) -> _ParsedFrame:
    """The body of _parse_frame; `sequences` decodes one block's sequences
    section into (literal lengths, match lengths, absolute offsets)."""
    hdr = parse_frame_header(data[pos:], window_log_max)
    p = pos + hdr.header_size
    hst = litmod.HufDecodeState()

    lanes: list[tuple[bytes, int]] = []    # (stream bytes, n symbols)
    lane_tab: list[int] = []               # lane -> table index
    tables: list[tuple[np.ndarray, np.ndarray]] = []
    table_ids: dict[int, int] = {}
    table_pins: list = []   # keep dt objects alive: id() keys must not recycle
    segs: list[tuple[int, int, int, bool]] = []  # (start, lane, src, is_dev)
    host_pool = bytearray()
    pool_off = 0
    seq_lists = []     # per block: (ll, ml, off_abs, lit_count) or None
    blocks_lit = []    # per block literal count
    total_len = 0
    last = False
    while not last:
        if p + 3 > len(data):
            raise ZstdError(ZstdErrorCode.srcSize_wrong,
                            "truncated block header")
        bh = int.from_bytes(data[p : p + 3], "little")
        last = bool(bh & 1)
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        p += 3
        if btype == BT_RAW:
            chunk = data[p : p + bsize]
            if len(chunk) != bsize:
                raise ZstdError(ZstdErrorCode.srcSize_wrong,
                                "truncated raw block")
            p += bsize
            if chunk:
                segs.append((pool_off, 0, len(host_pool), False))
                host_pool += chunk
                pool_off += len(chunk)
            seq_lists.append(None)
            blocks_lit.append(len(chunk))
            total_len += bsize
        elif btype == BT_RLE:
            if p >= len(data):
                raise ZstdError(ZstdErrorCode.srcSize_wrong,
                                "truncated RLE block")
            chunk = data[p : p + 1] * bsize
            p += 1
            if chunk:
                segs.append((pool_off, 0, len(host_pool), False))
                host_pool += chunk
                pool_off += len(chunk)
            seq_lists.append(None)
            blocks_lit.append(len(chunk))
            total_len += bsize
        elif btype == BT_COMPRESSED:
            payload = data[p : p + bsize]
            p += bsize
            kind, lit, spec, regen, used, hst = _parse_literals_section(
                payload, hst)
            if kind == "huf":
                streams, dt = spec
                ti = table_ids.get(id(dt))
                if ti is None:
                    ti = len(tables)
                    table_ids[id(dt)] = ti
                    table_pins.append(dt)
                    tables.append(_expand_lut(dt))
                for s_bytes, ln in streams:
                    if len(s_bytes) == 0:
                        raise Corruption(
                            "literal stream size out of range")
                    if s_bytes[-1] == 0:
                        raise Corruption(
                            "huffman stream: missing sentinel")
                    if len(s_bytes) > _STREAM_CAP or ln > _STREAM_CAP:
                        raise _DeviceUnsupported(
                            "literal stream exceeds device cap")
                    if ln:
                        segs.append((pool_off, len(lanes), 0, True))
                        pool_off += ln
                    lanes.append((s_bytes, ln))
                    lane_tab.append(ti)
                lit_count = regen
            else:
                if lit:
                    segs.append((pool_off, 0, len(host_pool), False))
                    host_pool += lit
                    pool_off += len(lit)
                lit_count = len(lit)
            lls, mls, offs = sequences(payload[used:])
            if len(lls):
                # the executor takes literal lengths that stay within the
                # block's literals (host mirror: block.py 'literal buffer
                # overrun'); checked here, on both devices alike
                if int(lls.sum()) > lit_count:
                    raise Corruption("literal buffer overrun (device decode)")
                span = int(lls.sum()) + int(mls.sum())
                seq_lists.append((lls.astype(np.int64),
                                  mls.astype(np.int64),
                                  offs.astype(np.int64), lit_count))
                total_len += span + (lit_count - int(lls.sum()))
            else:
                seq_lists.append(None)
                total_len += lit_count
            blocks_lit.append(lit_count)
        else:
            raise Corruption("reserved block type")

    # frame-global sequence arrays: literal-only spans (raw/RLE blocks,
    # trailing literals of each block) become zero-match pseudo-sequences
    # so every match's global position comes out of one running (ll + ml)
    # prefix sum on the device
    g_ll, g_ml, g_off = [], [], []
    for idx, sl in enumerate(seq_lists):
        if sl is None:
            if blocks_lit[idx]:
                g_ll.append(np.array([blocks_lit[idx]], np.int64))
                g_ml.append(np.zeros(1, np.int64))
                g_off.append(np.ones(1, np.int64))
            continue
        lls, mls, offs, lit_count = sl
        g_ll.append(lls)
        g_ml.append(mls)
        g_off.append(offs)
        trailing = int(lit_count - lls.sum())
        if trailing:
            g_ll.append(np.array([trailing], np.int64))
            g_ml.append(np.zeros(1, np.int64))
            g_off.append(np.ones(1, np.int64))

    n = total_len
    if g_ll:
        ll = np.concatenate(g_ll)
        ml = np.concatenate(g_ml)
        off = np.concatenate(g_off)
    else:
        ll = np.zeros(0, np.int64)
        ml = np.zeros(0, np.int64)
        off = np.zeros(0, np.int64)

    # offset validation BEFORE exec: the device gather clamps out-of-window
    # sources instead of trapping, so a corrupt frame would otherwise decode
    # to silently-wrong bytes (host mirror: block.py 'offset beyond window')
    if len(ml):
        ends = np.cumsum(ll + ml)
        match_start = ends - ml
        win = hdr.window_size or (1 << 62)
        bad = (ml > 0) & ((off > match_start) | (off > win))
        if bool(bad.any()):
            raise Corruption("offset beyond window (device decode)")

    return _ParsedFrame(lanes=lanes, lane_tab=lane_tab, tables=tables,
                        segs=segs, host_pool=bytes(host_pool),
                        pool_len=pool_off, ll=ll, ml=ml, off=off,
                        n=int(n), end_pos=p, hdr=hdr)


def _group_inputs(frames: list) -> dict:
    """Merge parsed frames into the arguments of one fused_frame_decode, as
    numpy arrays and ints (the JAX package's layout and size buckets).

    The decode is frame-global (absolute positions, pool-segment scatter),
    so K frames merge by concatenation with base shifts: output positions by
    the running content length, pool segments by the running literal-pool
    length, lanes and tables by their counts. Match offsets never cross a
    frame boundary (validated per frame), so they stay right after the
    shift. One decode puts every lane of every frame into one kernel
    launch: the lanes are latency-bound chains, so this is the difference
    between K launches of a chain and one."""
    lanes: list[tuple[bytes, int]] = []
    lane_tab: list[int] = []
    tables: list[tuple[np.ndarray, np.ndarray]] = []
    segs: list[tuple[int, int, int, bool]] = []
    host_pool = bytearray()
    g_ll, g_ml, g_off = [], [], []
    pool_base = 0
    for pf in frames:
        lane_base = len(lanes)
        tab_base = len(tables)
        src_base = len(host_pool)
        tables.extend(pf.tables)
        lanes.extend(pf.lanes)
        lane_tab.extend(t + tab_base for t in pf.lane_tab)
        host_pool += pf.host_pool
        for (st, lane, src, is_dev) in pf.segs:
            segs.append((st + pool_base,
                         lane + lane_base if is_dev else 0,
                         src + src_base if not is_dev else 0, is_dev))
        pool_base += pf.pool_len
        g_ll.append(pf.ll)
        g_ml.append(pf.ml)
        g_off.append(pf.off)
    ll = np.concatenate(g_ll) if g_ll else np.zeros(0, np.int64)
    ml = np.concatenate(g_ml) if g_ml else np.zeros(0, np.int64)
    off = np.concatenate(g_off) if g_off else np.zeros(0, np.int64)
    n = sum(pf.n for pf in frames)

    npad = _bucket(int(n))
    seq_cap = _bucket(max(len(ll), 1))
    nl = len(lanes)
    L = _bucket(max(nl, 1), base=4)
    mx_bytes = max((len(s) for s, _ in lanes), default=1)
    mx_syms = max((ln for _, ln in lanes), default=1)
    byte_cap = min(_bucket(max(mx_bytes, 1024)), _STREAM_CAP)
    # per-stream lengths were already capped at _STREAM_CAP during the
    # literals parse, so syms_cap >= mx_syms always holds here
    syms_cap = min(_bucket(max(mx_syms, 1024)), _STREAM_CAP)
    T = _bucket(max(len(tables), 1), base=2)
    S = _bucket(max(len(segs), 1), base=16)
    Hcap = _bucket(max(len(host_pool), 1), base=1024)

    sb = np.zeros((L, byte_cap), np.uint8)
    bits = np.zeros(L, np.int32)
    nsy = np.zeros(L, np.int32)
    for i, (s_bytes, ln) in enumerate(lanes):
        sb[i, : len(s_bytes)] = np.frombuffer(s_bytes, np.uint8)
        bits[i] = 8 * (len(s_bytes) - 1) + (s_bytes[-1].bit_length() - 1)
        nsy[i] = ln
    ltab = np.zeros(L, np.int32)
    ltab[:nl] = lane_tab
    lut_sym = np.zeros((T, 1 << MAX_TLOG), np.uint8)
    lut_len = np.ones((T, 1 << MAX_TLOG), np.uint8)
    for t, (s_, l_) in enumerate(tables):
        lut_sym[t] = s_
        lut_len[t] = l_
    seg_start = np.full(S, npad, np.int32)
    seg_lane = np.zeros(S, np.int32)
    seg_src = np.zeros(S, np.int32)
    seg_dev = np.zeros(S, bool)
    for i, (st, lane, src, is_dev) in enumerate(segs):
        seg_start[i] = st
        seg_lane[i] = lane
        seg_src[i] = src
        seg_dev[i] = is_dev
    hp = np.zeros(Hcap, np.uint8)
    hp[: len(host_pool)] = np.frombuffer(bytes(host_pool), np.uint8)

    def padded(a):
        return np.pad(a, (0, seq_cap - len(a))).astype(np.int32)

    return dict(sb=sb, start_bits=bits, n_syms=nsy, n_lanes=nl,
                lut_sym=lut_sym, lut_len=lut_len, lane_tab=ltab,
                seg_start=seg_start, seg_lane=seg_lane, seg_src=seg_src,
                seg_is_dev=seg_dev, host_lits=hp, nb_lit=pool_base,
                lls=padded(ll), mls=padded(ml), offs=padded(off),
                nb_seq=len(ll), out_len=int(n), max_syms=syms_cap,
                n=int(npad))


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array on `dev`; to a card through pinned memory without
    waiting (the caching host allocator keeps the pinned buffer until the
    copy is done)."""
    t = torch.from_numpy(a)
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A device tensor's bytes on the host, through pinned memory."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def _dispatch_group(frames: list, dev: torch.device) -> tuple:
    """Upload one group's inputs and enqueue its fused decode on `dev`.
    Returns (out u8[npad], ok bool scalar, final i32[L], n_lanes) on the
    device; out is the concatenated content of all frames (padded)."""
    g = _group_inputs(frames)
    args = {k: _upload(v, dev) if isinstance(v, np.ndarray) else v
            for k, v in g.items()}
    out, ok, final = fused_frame_decode(**args)
    return out, ok, final, g["n_lanes"]
