"""Device encode pipeline on PyTorch: the counterpart of TpuCompressor in
zstd_tpu/pipeline.py.

Structure (as in zstd_tpu, built around the host link):

  h2d:   raw input blocks + one plan blob per batch (entropy tables).
  device stage A (`_analyze`): match extraction -> code conversion -> all
         histograms. Only the i32[B, 1152] stats vector is fetched; the
         per-sequence arrays stay resident on the device.
  host:  entropy planning from the histograms alone (`_build_plans`: one
         call of csrc/host/plan.c a batch).
  device stage B (`_pack`): FSE (the fse_chain kernel + bit packing) and
         Huffman packing, then compaction of the valid bytes behind an
         i32[B, 7] sizes header.
  d2h:   one prefix of the compact buffer per batch.
  host:  frame assembly (`_finalize`).

Match extraction has four engines. Two are chosen as zstd_tpu chooses them:
`lazy` (ops/fastmatch.extract_batch_lazy, the chunked-resolve kernel) at
every level whose strategy is >= 3, else `pallas` (torch-op propose + the
extract kernel). The `engine` argument ("pallas", "v3" or "xla") overrides
both at every level, as ZSTD_TPU_ENGINE does there; `xla`
(ops/seqextract.extract_batch_xla: torch-op candidates, then the xla_walk
kernel, from the greedy walk to the seqstore and the literal index in one
launch) is also the engine of parallel.zstdmt.compress_sharded.

Batches run in a window of three: stage A of batch k is enqueued before the
host plans batch k-2 and assembles batch k-3, and the stats and compact
prefixes come back through non_blocking copies into pinned memory, each
waited on by an event.

A call of TorchCompressor.compress is one ZSTD_trace event (trace.py's
GLOBAL_TRACER, which the CLI's --trace writes) and advances
GLOBAL_PROGRESSION batch by batch. While trace.recording() is on it is also
one span tree: per batch k the spans stage_in, stage_a, stats_wait, plan,
stage_b, fetch_wait and finalize, then assemble.

Every device step runs on the device of the caller's choosing: `cuda` (the
default; the kernels run there) or `cpu` (the kernels' plain versions). It
never falls back from one to the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native
from .constants import (BLOCK_MAX_SIZE, BT_COMPRESSED, BT_RAW, BT_RLE,
                        LBT_COMPRESSED, LBT_RAW, LBT_RLE, MIN_MATCH)
from .format.frame import write_frame_header
from .format.literals import _min_gain
from .ops.bitpack import bytes_of_words
from .ops.codes import histogram, seq_codes
from .ops.fastmatch import extract_batch_lazy, extract_batch_v3
from .ops.fse_enc import STATE_TABLE_PAD, SYM_PAD, fse_pack
from .ops.huffman_enc import huf_pack_4x
from .ops.seqextract import extract_batch, extract_batch_xla
from .params import CParams, Strategy, get_cparams
from .trace import GLOBAL_PROGRESSION, GLOBAL_TRACER
from .trace import RECORDER as _rec
from .xxhash64 import content_checksum

# stats vector layout (zstd_tpu/pipeline.py's, so the two can be compared)
_STATS_LIT_HIST = 0          # [4, 256]
_STATS_LL = 1024             # [36]
_STATS_ML = 1060             # [53]
_STATS_OF = 1113             # [32]
_STATS_TAIL = 1145           # last_codes[3], nb_seq, nb_lit, all_same, first_lit
STATS_LEN = 1152

# the host plan for stage B travels as ONE i32 row per block; offsets:
_PB_ST = 0
_PB_DN = _PB_ST + 3 * STATE_TABLE_PAD
_PB_DF = _PB_DN + 3 * SYM_PAD
_PB_TL = _PB_DF + 3 * SYM_PAD
_PB_NBL = _PB_TL + 3
_PB_VAL = _PB_NBL + 256
_PB_SINGLE = _PB_VAL + 256
_PB_LITRAW = _PB_SINGLE + 1
_PB_HUFUSED = _PB_LITRAW + 1
_PB_BLEN = _PB_HUFUSED + 1
PLAN_LEN = _PB_BLEN + 1
# the columns of the batch planner's records that the host halves read, and
# its literal kinds
(_R_KIND, _R_SINGLE, _R_C_SIZE, _R_EST, _R_LAST_COUNT, _R_NB_SEQ, _R_NB_LIT,
 _R_ALL_SAME, _R_FIRST_LIT, _R_HDR_OFF, _R_HDR_LEN, _R_TREE_OFF,
 _R_TREE_LEN) = map(native.PLAN_FIELDS.index, (
    "kind", "single", "c_size", "est", "last_count", "nb_seq", "nb_lit",
    "all_same", "first_lit", "hdr_off", "hdr_len", "tree_off", "tree_len"))
_LIT_RLE, _LIT_HUF = 1, 2

# batches in flight: stage A of batch k is enqueued before batch
# k - WINDOW + 1 is planned and batch k - WINDOW finished
WINDOW = 3

# the compact prefix is fetched in whole steps of this many bytes
FETCH_STEP = 128 * 1024

RESIDENT_DTYPES = dict(llc=torch.int32, mlc=torch.int32, ofc=torch.int32,
                       ob=torch.int32, mlb=torch.int32, llx=torch.int32,
                       lits=torch.uint8, nb_lit=torch.int32,
                       nb_seq=torch.int32)


def _analyze(blocks: torch.Tensor, valid_lens: torch.Tensor, hash_log: int,
             mls: int, seq_cap: int, engine: str = "pallas"):
    """Device stage A. blocks u8[B, N], valid_lens i32[B].
    Returns (stats i32[B, STATS_LEN], resident dict). The `pallas` engine
    zeroes `lits` past nb_lit; `lazy`, `v3` and `xla` gather them through
    lit_idx, which holds N - 1 there, as zstd_tpu does."""
    if engine == "pallas":
        res = extract_batch(blocks, valid_lens, hash_log, mls, seq_cap)
        lits = res["lits"]
    else:
        fn = {"lazy": extract_batch_lazy, "v3": extract_batch_v3,
              "xla": extract_batch_xla}[engine]
        res = fn(blocks, valid_lens, hash_log, mls, seq_cap)
        lits = blocks.gather(1, res["lit_idx"].to(torch.int64))
    n = blocks.shape[1]
    j = torch.arange(n, device=blocks.device)[None, :]
    all_same = ((blocks == blocks[:, :1]) |
                (j >= valid_lens[:, None])).all(dim=1)
    return stage_a_stats(res, lits, all_same)


def stage_a_stats(res: dict, lits: torch.Tensor, all_same: torch.Tensor):
    """(stats i32[B, STATS_LEN], resident dict) of stage A from an engine's
    seqstore `res`, the literal rows and each block's all_same flag: the
    sequence codes and histograms, the exact per-stream literal histogram,
    and the tail (last codes, nb_seq, nb_lit, all_same, first literal)."""
    nb_lit, nb_seq = res["nb_lit"], res["nb_seq"]
    codes = seq_codes(res["ll"], res["off"], res["ml"], nb_seq)
    j = torch.arange(lits.shape[1], device=lits.device)[None, :]
    nbl = nb_lit.to(torch.int64)[:, None]
    # exact per-stream byte histogram: stream s holds literals
    # [s * seg, (s + 1) * seg) with seg = ceil(nb_lit / 4)
    stream = (j // ((nbl + 3) // 4).clamp(min=1)).clamp(0, 3)
    lit_hist4 = histogram(stream * 256 + lits.long(), j < nbl, 1024)
    tail = torch.stack([nb_seq, nb_lit, all_same.to(torch.int32),
                        lits[:, 0].to(torch.int32)], dim=1)
    stats = torch.cat([lit_hist4, codes["ll_hist"], codes["ml_hist"],
                       codes["of_hist"], codes["last_codes"], tail], dim=1)
    resident = dict(llc=codes["llc"], mlc=codes["mlc"], ofc=codes["ofc"],
                    ob=codes["ob"], mlb=codes["mlb"], llx=res["ll"],
                    lits=lits, nb_lit=nb_lit, nb_seq=nb_seq)
    return stats, resident


def resident_from_numpy(d: dict, device) -> dict:
    """The resident dict of stage A from numpy arrays (zstd_tpu's layout and
    dtypes), on `device`."""
    return {k: torch.tensor(np.asarray(d[k]), dtype=dt, device=device)
            for k, dt in RESIDENT_DTYPES.items()}


def fse_inputs(r: dict, plan_blob: torch.Tensor, cap: int) -> tuple:
    """The arguments of ops.fse_enc.fse_fields in stage B: the resident
    codes/extras cut (or zero-padded) to `cap` columns, nb_seq capped, and
    the three FSE tables of every block from the plan blob."""
    B = plan_blob.shape[0]

    def capped(x):
        x = x[:, :cap]
        if x.shape[1] < cap:
            x = torch.nn.functional.pad(x, (0, cap - x.shape[1]))
        return x.contiguous()

    def blob(a, b, *shape):
        return plan_blob[:, a:b].reshape(B, *shape).contiguous()

    return (*(capped(r[k]) for k in ("llc", "mlc", "ofc", "llx", "mlb", "ob")),
            r["nb_seq"].clamp(max=cap).contiguous(),
            blob(_PB_ST, _PB_DN, 3, STATE_TABLE_PAD),
            blob(_PB_DN, _PB_DF, 3, SYM_PAD), blob(_PB_DF, _PB_TL, 3, SYM_PAD),
            blob(_PB_TL, _PB_NBL, 3))


def _pack(r: dict, plan_blob: torch.Tensor, cap: int, out_w_fse: int,
          seg_cap: int, out_w_huf: int):
    """Device stage B. Returns (compact u8[capp], sizes i32[B, 7]): the
    [B, 7] header (fse, huf0..3, overflow, zeroed) at the head of the compact
    buffer, then each block's pieces [fse, huf0..huf3, raw literals] packed
    tight. Gated pieces (overflow, or no gain over raw) have size 0."""
    lits, nb_lit, nb_seq = r["lits"], r["nb_lit"], r["nb_seq"]
    B, L = lits.shape
    dev = lits.device
    fse_words, fse_bits = fse_pack(*fse_inputs(r, plan_blob, cap), out_w_fse)
    single = plan_blob[:, _PB_SINGLE] > 0
    lit_raw = plan_blob[:, _PB_LITRAW] > 0
    huf_used = plan_blob[:, _PB_HUFUSED] > 0
    blens = plan_blob[:, _PB_BLEN]
    huf_words, huf_bits = huf_pack_4x(
        lits, nb_lit, plan_blob[:, _PB_NBL:_PB_VAL], plan_blob[:, _PB_VAL:_PB_SINGLE],
        single, seg_cap, out_w_huf)
    fse_nb = (fse_bits + 7) // 8
    huf_nb = (huf_bits + 7) // 8
    # stream buffers are sized for typical densities; a block whose stream
    # overflows its buffer is flagged and stored raw by the host. So is a
    # block with more sequences than its seqstore holds (the xla engine does
    # not stop at seq_cap; zstd_tpu packs such a block and writes a frame
    # that no decoder takes)
    overflow = (fse_nb > out_w_fse * 4) | (huf_nb > out_w_huf * 4).any(dim=1) \
        | (nb_seq > r["llc"].shape[1])
    Wf, Wh = 4 * out_w_fse, 4 * out_w_huf
    fse_bytes = bytes_of_words(fse_words, fse_nb)
    huf_bytes = bytes_of_words(huf_words.reshape(B * 4, out_w_huf),
                               huf_nb.reshape(-1)).reshape(B, 4 * Wh)
    jl = torch.arange(L, device=dev)[None, :]
    raw_lits = torch.where(lit_raw[:, None] & (jl < nb_lit[:, None]), lits, 0)
    sizes = torch.cat([fse_nb[:, None], huf_nb,
                       overflow.to(torch.int32)[:, None]], dim=1)

    # ---- compaction: gate pieces as zstd_tpu does, then scatter every
    # valid byte to its place behind the sizes header
    fse_sz = torch.where(nb_seq > 0, sizes[:, 0], 0)
    s_idx = torch.arange(4, device=dev)[None, :]
    huf_gate = huf_used[:, None] & ((s_idx == 0) | ~single[:, None])
    huf_sz = torch.where(huf_gate, sizes[:, 1:5], 0)
    raw_sz = torch.where(lit_raw, nb_lit, 0)
    est = fse_sz + huf_sz.sum(dim=1) + raw_sz + 16
    zeroed = overflow | (est >= blens)
    g = (~zeroed).to(torch.int64)[:, None]
    piece_sz = torch.cat([fse_sz[:, None], huf_sz, raw_sz[:, None]],
                         dim=1).to(torch.int64) * g               # [B, 6]
    flat = piece_sz.reshape(-1)
    hdr_len = B * 7 * 4
    dst = torch.cumsum(flat, 0) - flat + hdr_len                 # exclusive
    capp = hdr_len + B * (Wf + 4 * Wh + L) + max(Wf, Wh, L) + 8
    sizes2 = torch.cat([sizes, zeroed.to(torch.int32)[:, None]],
                       dim=1).to(torch.int32)                     # [B, 7]

    src = torch.cat([fse_bytes, huf_bytes, raw_lits], dim=1)
    col = torch.arange(Wf + 4 * Wh + L, device=dev)
    hcol = col - Wf
    col_piece = torch.where(col < Wf, 0,
                            torch.where(hcol < 4 * Wh, 1 + hcol // Wh, 5))
    col_start = torch.where(col < Wf, 0,
                            torch.where(hcol < 4 * Wh, Wf + (hcol // Wh) * Wh,
                                        Wf + 4 * Wh))
    col_off = (col - col_start)[None, :]
    pid = torch.arange(B, device=dev)[:, None] * 6 + col_piece[None, :]
    dest = torch.where(col_off < flat[pid], dst[pid] + col_off, capp)
    buf = torch.zeros(capp + 1, dtype=torch.uint8, device=dev)
    buf[:hdr_len] = sizes2.view(torch.uint8).reshape(-1)
    buf.scatter_(0, dest.reshape(-1), src.reshape(-1))   # capp: dropped bytes
    return buf[:capp], sizes2


def _seq_cap_bucket(max_seq: int) -> int:
    for c in (1024, 2048, 4096, 8192, 16384, 32768):
        if max_seq <= c:
            return c
    return 32768


def _lit_header(h_type: int, regen: int, c_size: int, single_stream: bool) -> bytes:
    lh_size = 3 + (regen >= 1024) + (regen >= 16384)
    if lh_size == 3:
        lhc = h_type + ((0 if single_stream else 1) << 2) + (regen << 4) + (c_size << 14)
        return lhc.to_bytes(3, "little")
    if lh_size == 4:
        lhc = h_type + (2 << 2) + (regen << 4) + (c_size << 18)
        return lhc.to_bytes(4, "little")
    lhc = h_type + (3 << 2) + (regen << 4) + ((c_size & 0x3FF) << 22)
    return lhc.to_bytes(4, "little") + bytes([(c_size >> 10) & 0xFF])


def _raw_lit_header(n: int) -> bytes:
    fl = 1 + (n > 31) + (n > 4095)
    if fl == 1:
        return bytes([LBT_RAW | ((n << 3) & 0xFF)])
    if fl == 2:
        return (LBT_RAW + (1 << 2) + (n << 4)).to_bytes(2, "little")
    return (LBT_RAW + (3 << 2) + (n << 4)).to_bytes(3, "little")


def _rle_lit_section(n: int, byte: int) -> bytes:
    fl = 1 + (n > 31) + (n > 4095)
    if fl == 1:
        hdr = bytes([LBT_RLE + ((n << 3) & 0xFF)])
    elif fl == 2:
        hdr = (LBT_RLE + (1 << 2) + (n << 4)).to_bytes(2, "little")
    else:
        hdr = (LBT_RLE + (3 << 2) + (n << 4)).to_bytes(3, "little")
    return hdr + bytes([byte])


def write_blocks(out: bytearray, payloads: list, data: bytes,
                 checksum: bool) -> bytes:
    """The frame from its header `out`: every block (payload, block type,
    block length) behind its 3-byte header, the last one marked (an empty
    input is one empty raw block), then the content checksum if asked."""
    payloads = payloads or [(b"", BT_RAW, 0)]
    for i, (payload, btype, blen) in enumerate(payloads):
        size = blen if btype == BT_RLE else len(payload)
        bh = int(i == len(payloads) - 1) | (btype << 1) | (size << 3)
        out += bh.to_bytes(3, "little")
        out += payload
    if checksum:
        out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "kernels' plain versions on the host")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class TorchCompressor:
    """Batched, device-resident block compressor. `engine` None picks the
    match engine by level; "pallas", "v3" or "xla" forces one."""
    level: int = 1
    checksum: bool = False
    batch_blocks: int = 32
    device: str | torch.device | None = None
    engine: str | None = None

    def __post_init__(self):
        self.device = _resolve_device(self.device)
        if self.engine not in (None, "pallas", "v3", "xla"):
            raise ValueError(f"unknown engine {self.engine!r}: pass None, "
                             "'pallas', 'v3' or 'xla'")

    def _engine_for(self, cparams: CParams) -> str:
        """zstd_tpu's choice: lazy when strategy >= 3, else pallas; an
        explicit engine overrides both (ZSTD_TPU_ENGINE's role there)."""
        if self.engine is not None:
            return self.engine
        return "lazy" if cparams.strategy >= Strategy.GREEDY else "pallas"

    # -- staging helpers -------------------------------------------------
    def _h2d(self, a: np.ndarray):
        """(device tensor, pinned host tensor kept alive for the copy)."""
        host = torch.from_numpy(a)
        if self.device.type == "cpu":
            return host, None
        host = host.pin_memory()
        return host.to(self.device, non_blocking=True), host

    def _d2h(self, t: torch.Tensor):
        """Start a copy to the host: (host tensor, event or None)."""
        if self.device.type == "cpu":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    @staticmethod
    def _wait(host: torch.Tensor, ev) -> np.ndarray:
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _setup(self, n: int):
        cparams = get_cparams(self.level, n)
        block_size = min(1 << cparams.window_log, BLOCK_MAX_SIZE)
        nb_blocks = (n + block_size - 1) // block_size
        batches = [(bs, min(bs + self.batch_blocks, nb_blocks))
                   for bs in range(0, nb_blocks, self.batch_blocks)]
        return cparams, block_size, batches

    @staticmethod
    def _batch_blocks(arr, n, bs, be, block_size):
        """Blocks [bs, be) of the n-byte input `arr` as zero-padded rows
        u8[be - bs, block_size] and their lengths i32[be - bs]; rows past
        the input's end have length 0."""
        s = bs * block_size
        starts = s + np.arange(be - bs, dtype=np.int64) * block_size
        lens = np.clip(n - starts, 0, block_size).astype(np.int32)
        blocks = np.zeros((be - bs, block_size), dtype=np.uint8)
        m = int(lens.sum())
        blocks.reshape(-1)[:m] = arr[s:s + m]
        return blocks, lens

    def _dispatch_a(self, arr, n, k, batch, block_size, cparams, prog=None):
        """Batch k's blocks pinned and uploaded (span stage_in), then stage A
        and the copy of its stats enqueued (stage_a). `prog`, where given,
        is the frame progression to advance."""
        t = _rec.on and _rec.begin("stage_in", k)
        blocks, lens = self._batch_blocks(arr, n, *batch, block_size)
        blocks_d, keep_b = self._h2d(blocks)
        lens_d, keep_l = self._h2d(lens)
        end = min(batch[1] * block_size, n)
        if prog is not None:
            prog.ingested = end
        if t:
            _rec.end(t)
        t = _rec.on and _rec.begin("stage_a", k)
        stats, resident = _analyze(
            blocks_d, lens_d, cparams.hash_log,
            min(max(cparams.min_match, 4), 8), max(block_size // 8, 8),
            self._engine_for(cparams))
        stats_h, ev = self._d2h(stats)
        if t:
            _rec.end(t)
        return lens, stats_h, ev, resident, end, (keep_b, keep_l)

    def _dispatch_b(self, stage_a, k, block_size, cparams, fetch, prog=None):
        """Batch k's stats waited for (stats_wait) and planned (plan), then
        the plan rows pinned and uploaded, stage B enqueued and
        fetch(plans, compact) started (stage_b). Returns (plans, plan rows,
        lens, compact, what fetch returned, the pinned rows kept alive for
        their copy)."""
        lens, stats_h, ev, resident, end, _ = stage_a
        t = _rec.on and _rec.begin("stats_wait", k)
        stats = self._wait(stats_h, ev)
        if t:
            _rec.end(t)
        if prog is not None:
            prog.consumed = end
        t = _rec.on and _rec.begin("plan", k)
        plans, blob, cap, out_w_fse, seg_cap, out_w_huf = self._build_plans(
            stats, lens, cparams.strategy, block_size)
        if t:
            _rec.end(t)
        t = _rec.on and _rec.begin("stage_b", k)
        blob_d, keep = self._h2d(blob)
        compact, _ = _pack(resident, blob_d, cap, out_w_fse, seg_cap,
                           out_w_huf)
        fetched = fetch(plans, compact)
        if t:
            _rec.end(t)
        return plans, blob, lens, compact, fetched, keep

    def _window(self, arr, n, batches, block_size, cparams, fetch, finish,
                prog=None) -> list:
        """The software pipeline over batches: stage A of batch k is
        enqueued, then batch k - 2 is planned and its stage B enqueued with
        fetch(plans, compact), then finish(k - 3, *what _dispatch_b
        returned) runs; the tail plans the last two batches, then finishes
        the last three. Returns what finish returned, in batch order."""
        stage_a: dict[int, tuple] = {}
        stage_b: dict[int, tuple] = {}
        done = []

        def plan(k):
            stage_b[k] = self._dispatch_b(stage_a.pop(k), k, block_size,
                                          cparams, fetch, prog)

        for k in range(len(batches)):
            stage_a[k] = self._dispatch_a(arr, n, k, batches[k], block_size,
                                          cparams, prog)
            if k >= WINDOW - 1:
                plan(k - WINDOW + 1)
            if k >= WINDOW:
                done.append(finish(k - WINDOW, *stage_b.pop(k - WINDOW)))
        for k in range(max(len(batches) - WINDOW + 1, 0), len(batches)):
            plan(k)
        for k in range(max(len(batches) - WINDOW, 0), len(batches)):
            done.append(finish(k, *stage_b.pop(k)))
        return done

    # -- entry points ----------------------------------------------------
    def compress(self, data: bytes) -> bytes:
        """One zstd frame of `data`: one ZSTD_trace event, and one span tree
        while recording is on (see the module's docstring). The frame
        progression starts anew."""
        prog = GLOBAL_PROGRESSION
        prog.ingested = prog.consumed = prog.produced = prog.flushed = 0
        with GLOBAL_TRACER.span("compress", self.level) as ev:
            n = len(data)
            cparams, block_size, batches = self._setup(n)
            ev.window_log, ev.src_size = cparams.window_log, n
            out = self._encode(data, cparams, block_size, batches)
            prog.produced = prog.flushed = len(out)
            ev.dst_size = len(out)
        return out

    def _encode(self, data, cparams, block_size, batches) -> bytes:
        n = len(data)
        out = bytearray(write_frame_header(n, cparams.window_log, self.checksum))
        if n == 0:
            return write_blocks(out, [], data, self.checksum)
        GLOBAL_PROGRESSION.produced = len(out)
        arr = np.frombuffer(data, dtype=np.uint8)

        def finish(k, plans, blob, lens, compact, fetched, _):
            t = _rec.on and _rec.begin("fetch_wait", k)
            regions, streams = self._fetch_regions(plans, blob, compact,
                                                   *fetched)
            if t:
                _rec.end(t)
            t = _rec.on and _rec.begin("finalize", k)
            results = self._finalize(plans, lens, regions, streams, arr,
                                     batches[k][0], block_size, cparams)
            if t:
                _rec.end(t)
            GLOBAL_PROGRESSION.produced += sum(3 + len(r[0]) for r in results)
            return results

        done = self._window(arr, n, batches, block_size, cparams,
                            self._start_fetch, finish, GLOBAL_PROGRESSION)
        payloads = [r for results in done for r in results]
        t = _rec.on and _rec.begin("assemble")
        out = write_blocks(out, payloads, data, self.checksum)
        if t:
            _rec.end(t)
        return out

    def compress_resident(self, data: bytes) -> int:
        """Device-resident encode: both device stages over the whole input
        with the packed streams left on the device. Only the stats vectors
        (for host planning) and the [B, 7] sizes headers cross the link.
        Returns the total compressed payload bytes the device reports."""
        n = len(data)
        cparams, block_size, batches = self._setup(n)

        def header(plans, compact):
            return self._d2h(compact[: len(plans[0]) * 7 * 4])

        def total(k, plans, blob, lens, compact, fetched, _):
            sizes = self._wait(*fetched).view(np.int32).reshape(len(lens), 7)
            return self._region_metas(plans[0], blob, sizes)[3]

        out = sum(self._window(np.frombuffer(data, dtype=np.uint8), n,
                               batches, block_size, cparams, header, total))
        self._sync()
        return out

    # -- host halves ------------------------------------------------------
    def _build_plans(self, stats, lens, strategy, block_size):
        """Per-block entropy planning from the stats vectors alone: the
        whole batch in one call of the host library (csrc/host/plan.c).
        Returns (plans, plan rows, cap, out_w_fse, seg_cap, out_w_huf);
        plans is (records int64[B, len(native.PLAN_FIELDS)], the arena of
        sequences headers and Huffman trees they point into)."""
        blob, rec, arena = native.plan_batch(stats, lens, strategy, PLAN_LEN)
        cap = _seq_cap_bucket(max(int(rec[:, _R_NB_SEQ].max(initial=0)), 1))
        # typical-density buffer sizing (overflow -> host raw fallback):
        # ~24 bits/sequence, ~10 bits/literal
        out_w_fse = (cap * 24) // 32 + 16
        seg_cap = (block_size + 3) // 4
        out_w_huf = (seg_cap * 10) // 32 + 4
        return (rec, arena), blob, cap, out_w_fse, seg_cap, out_w_huf

    @staticmethod
    def _region_metas(rec, blob, sizes):
        """The device's piece gating on the host, from the records, the plan
        rows and the fetched [B, 7] sizes header, as _pack gates from
        `fse_sz = ...` to `piece_sz = ...`. Returns (offsets int64[B, 6] and
        sizes int64[B, 6] of the pieces fse, huf0-3 and raw in the compact
        stream, zeroed bool[B], total bytes)."""
        single = blob[:, _PB_SINGLE] > 0
        lit_raw = blob[:, _PB_LITRAW] > 0
        huf_used = blob[:, _PB_HUFUSED] > 0
        huf_gate = huf_used[:, None] & ((np.arange(4) == 0) | ~single[:, None])
        zeroed = sizes[:, 6] != 0
        piece = np.concatenate([
            np.where(rec[:, _R_NB_SEQ] > 0, sizes[:, 0], 0)[:, None],
            np.where(huf_gate, sizes[:, 1:5], 0),
            np.where(lit_raw, rec[:, _R_NB_LIT], 0)[:, None]],
            axis=1).astype(np.int64) * ~zeroed[:, None]
        end = np.cumsum(piece).reshape(piece.shape)
        return end - piece, piece, zeroed, int(piece.sum())

    def _start_fetch(self, plans, compact):
        """Start the prefix fetch of the compact buffer, sized from the host
        estimate of the streams. Returns (host, event, prefix length)."""
        rec = plans[0]
        hdr = len(rec) * 7 * 4
        est_total = int(rec[:, _R_EST].sum())
        step = FETCH_STEP
        nb = min(max(-(-(hdr + est_total) // step) * step, step),
                 int(compact.shape[0]))
        return (*self._d2h(compact[:nb]), nb)

    def _fetch_regions(self, plans, blob, compact, host, ev, nb):
        """Wait for the prefix fetch; the [B, 7] sizes header at its head
        places the streams (re-fetched bigger if the estimate undershot,
        which the device pre-gate makes rare). Returns (_region_metas'
        result, the streams)."""
        rec = plans[0]
        hdr = len(rec) * 7 * 4
        fetched = self._wait(host, ev)
        sizes = fetched[:hdr].view(np.int32).reshape(len(rec), 7)
        regions = self._region_metas(rec, blob, sizes)
        total = regions[3]
        if hdr + total > nb:
            fetched = compact[: hdr + total].cpu().numpy()
        return regions, fetched[hdr: hdr + total]

    def _finalize(self, plans, lens, regions, compact, arr, first_block,
                  block_size, cparams: CParams):
        """Each block of a batch as (payload, block type, block length),
        from its record, the arena and its pieces in the fetched streams."""
        rec, arena = plans
        offs, sizes, zeroed, _ = regions
        strategy = cparams.strategy
        results = []
        for j, (r, blen, o, z, zero) in enumerate(zip(
                rec.tolist(), lens.tolist(), offs.tolist(), sizes.tolist(),
                zeroed.tolist())):
            s = (first_block + j) * block_size
            src = arr[s : s + blen]
            raw = (src.tobytes(), BT_RAW, blen)
            if blen < MIN_MATCH + 1 + 8:
                results.append(raw)
                continue
            rle = (src[:1].tobytes(), BT_RLE, blen) \
                if r[_R_ALL_SAME] and blen > 1 else raw
            if zero:
                # stream-buffer overflow, or the device's size pre-gate says
                # this block cannot beat raw: store raw/RLE
                results.append(rle)
                continue
            nb_lit = r[_R_NB_LIT]

            if r[_R_KIND] == _LIT_HUF:
                tree = arena[r[_R_TREE_OFF]:r[_R_TREE_OFF] + r[_R_TREE_LEN]]
                streams = [compact[o[t] : o[t] + z[t]].tobytes()
                           for t in range(1, 5)]
                if r[_R_SINGLE]:
                    payload_l = tree + streams[0]
                else:
                    jump = b"".join(len(x).to_bytes(2, "little")
                                    for x in streams[:3])
                    payload_l = tree + jump + b"".join(streams)
                if len(payload_l) != r[_R_C_SIZE]:
                    results.append(raw)  # defensive
                    continue
                lit_section = _lit_header(LBT_COMPRESSED, nb_lit,
                                          r[_R_C_SIZE], r[_R_SINGLE]) \
                    + payload_l
            elif r[_R_KIND] == _LIT_RLE:
                lit_section = _rle_lit_section(nb_lit, r[_R_FIRST_LIT])
            else:
                lit_section = _raw_lit_header(nb_lit) + \
                    compact[o[5] : o[5] + z[5]].tobytes()

            seq_section = arena[r[_R_HDR_OFF]:r[_R_HDR_OFF] + r[_R_HDR_LEN]]
            if r[_R_NB_SEQ]:
                if r[_R_LAST_COUNT] and (r[_R_LAST_COUNT] + z[0]) < 4:
                    results.append(raw)
                    continue
                seq_section += compact[o[0] : o[0] + z[0]].tobytes()

            payload = lit_section + seq_section
            if len(payload) >= blen - _min_gain(blen, strategy):
                results.append(rle)
                continue
            results.append((payload, BT_COMPRESSED, blen))
        return results


def compress(data: bytes, level: int = 1, checksum: bool = False,
             batch_blocks: int = 32, device=None, engine=None) -> bytes:
    """One zstd frame of `data`, encoded through the device pipeline on
    `device` (default: the CUDA card; raises if there is none). `engine`
    None picks the match engine by level; "pallas", "v3" or "xla" forces
    one."""
    return TorchCompressor(level=level, checksum=checksum,
                           batch_blocks=batch_blocks, device=device,
                           engine=engine).compress(data)
