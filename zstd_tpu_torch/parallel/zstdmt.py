"""zstdmt analog: one zstd frame compressed by every rank of a process group.

Counterpart of zstd_tpu/parallel/zstdmt.py (the reference's job-parallel
single-frame compressor, lib/compress/zstdmt_compress.c) on
torch.distributed:

  - the frame's blocks shard contiguously over the ranks (b_pad / world
    each, b_pad the block count rounded up to a multiple of the world);
  - each block sees the tail of the previous content as window context,
    sized by the overlapLog rule (ZSTDMT_computeOverlapSize: overlap =
    window >> (9 - ovlog), default ovlog 6 for fast strategies .. 9 for
    btultra2): candidates may point into the halo, so offsets cross block
    and rank boundaries. The cross-rank halo is a ring exchange; the frame's
    first block has its fabricated halo banned;
  - sequences and literals are emitted only for each block's own bytes
    (emit_from = halo), through the xla engine (ops/seqextract.
    extract_batch_xla: on a card the xla_walk kernel walks the greedy chain
    and writes the seqstore and the literal index in one launch);
  - the ranks' stats are gathered and every rank plans every block's
    entropy tables (deterministic host code), packs its own blocks through
    pipeline._pack, and sends its tight compact prefix to rank 0, which
    stitches them in order and assembles the frame (zstdmt's ordered
    flushProduced / serialState).

The frame is the same for every world size, and equals zstd_tpu's for the
same mesh size except where zstd_tpu's frame is corrupt: in the frame's
first block the backward extension here never reaches into the fabricated
halo (see ops/seqextract.extract_batch_xla).

While trace.recording() is on, a call is one span tree on each rank: the
root `compress_sharded`, then `stage_in` (the rank's blocks cut and
uploaded), `halo_exchange`, `stage_a`, `stats_gather`, `plan`, `stage_b`,
`parts_gather` and, on rank 0, `finalize` and `assemble` (the stitch). The
collectives (halo_rows, the ring; gather_rows, the all_gathers of the
stats and of the parts' sizes; gather_padded, the parts'), stage A, stage
B and rank 0's stitch are called through this module's globals, so that a
caller can wrap each. Of the collectives only gather_padded waits for the
device, for the parts' lengths; the copies of the stats and, on rank 0, of
the parts to the host come after them. COUNTS counts each rank's work
whether recording is on or not.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import BLOCK_MAX_SIZE
from ..format.frame import write_frame_header
from ..ops.seqextract import extract_batch_xla
from ..params import get_cparams
from ..pipeline import TorchCompressor, _pack, stage_a_stats, write_blocks
from ..trace import RECORDER as _rec
from .shard_compress import (ShardGroup, gather_padded, gather_rows,
                             halo_rows, make_group)

DEFAULT_HALO = 512   # floor: always at least the round-2 short halo

# this rank's work since the process started: calls of compress_sharded;
# the frame's blocks that its stage A ran (its own, with content); the halo
# bytes in front of them (the context stage A reads besides the blocks); the
# bytes it received in the stats and parts gathers (every block's stats
# row and sizes row, every rank's part)
COUNTS = {"calls": 0, "blocks": 0, "halo_bytes": 0, "gathered_bytes": 0}


def overlap_size(strategy: int, window_log: int, overlap_log: int = 0) -> int:
    """ZSTDMT_computeOverlapSize analog: overlap_log 0 = per-strategy
    default (6 fast .. 9 btultra2); overlap = window >> (9 - ovlog)."""
    if overlap_log == 0:
        if strategy >= 8:          # btultra2
            ovlog = 9
        elif strategy >= 6:        # btopt/btultra
            ovlog = 8
        elif strategy >= 4:        # lazy2/btlazy2
            ovlog = 7
        else:
            ovlog = 6
    else:
        ovlog = max(1, min(overlap_log, 9))
    rlog = 9 - ovlog
    if rlog >= 8:
        return 0
    return 1 << max(window_log - rlog, 0)


def analyze_sharded(ext: torch.Tensor, lens: torch.Tensor,
                    halo_ok: torch.Tensor, hash_log: int, mls: int,
                    seq_cap: int, halo: int):
    """Stage A of this rank's blocks behind their halos: extract and stats.
    ext u8[b, halo + n] (halo_rows), lens i32[b] content lengths,
    halo_ok bool[b]. Returns (stats i32[b, 1152], resident dict), as
    pipeline._analyze does."""
    b, width = ext.shape
    emit_from = torch.full((b,), halo, dtype=torch.int32, device=ext.device)
    res = extract_batch_xla(ext, lens + halo, hash_log, mls, seq_cap,
                            emit_from=emit_from, halo_ok=halo_ok)
    lits = ext.gather(1, res["lit_idx"].to(torch.int64))
    j = torch.arange(width, device=ext.device)[None, :]
    all_same = ((ext == ext[:, halo:halo + 1]) | (j < halo)
                | (j >= halo + lens.to(torch.int64)[:, None])).all(dim=1)
    return stage_a_stats(res, lits, all_same)


def _pack_sharded(resident: dict, blob: np.ndarray, rec: np.ndarray,
                  shape: tuple, device):
    """Stage B of this rank's blocks (their plan rows and records): pack and
    compact them. Returns (the tight compact bytes u8[total], sizes
    i32[b, 7]), both on the device."""
    compact, sizes = _pack(resident, torch.from_numpy(blob).to(device),
                           *shape)
    total = TorchCompressor._region_metas(rec, blob, sizes.cpu().numpy())[3]
    hdr = len(rec) * 7 * 4
    return compact[hdr:hdr + total], sizes


def stitch(out: bytearray, comp: TorchCompressor, plans, blob: np.ndarray,
           lens: np.ndarray, parts: list, sizes: np.ndarray, data: bytes,
           nb_blocks: int, block_size: int, cparams) -> bytes:
    """Rank 0's in-order stitch (zstdmt's flushProduced analog): the ranks'
    tight parts, end to end, hold the frame's pieces in block order; the
    blocks' payloads (span `finalize`), then the frame (span `assemble`)."""
    t = _rec.on and _rec.begin("finalize")
    regions = TorchCompressor._region_metas(plans[0], blob, sizes)
    payloads = comp._finalize(plans, lens, regions, np.concatenate(parts),
                              np.frombuffer(data, dtype=np.uint8), 0,
                              block_size, cparams)[:nb_blocks]
    if t:
        _rec.end(t)
    t = _rec.on and _rec.begin("assemble")
    frame = write_blocks(out, payloads, data, comp.checksum)
    if t:
        _rec.end(t)
    return frame


def compress_sharded(data: bytes, level: int = 1, checksum: bool = False,
                     group: ShardGroup | None = None, overlap_log: int = 0,
                     device=None) -> bytes | None:
    """Compress `data` into ONE zstd frame with every rank of `group`.

    SPMD: every rank calls it with the same `data`. `group` None is
    make_group(device) over the default process group: device None is this
    rank's card (NCCL; raises without one), device="cpu" the host (gloo).
    Rank 0 returns the frame; the other ranks return None. The frame is the
    same for every world size. overlap_log mirrors ZSTD_c_overlapLog:
    0 = strategy default, 9 = a full window of cross-boundary context
    (capped at one block)."""
    root = _rec.on and _rec.begin_call("compress_sharded",
                                       time.perf_counter_ns())
    COUNTS["calls"] += 1
    try:
        if group is None:
            group = make_group(device)
        return _compress(data, level, checksum, group, overlap_log)
    finally:
        if root:
            _rec.end(root)


def _compress(data: bytes, level: int, checksum: bool, group: ShardGroup,
              overlap_log: int) -> bytes | None:
    """compress_sharded's body on this rank of `group`."""
    world, rank = group.world, group.rank
    n = len(data)
    cparams = get_cparams(level, n)
    block_size = min(1 << cparams.window_log, BLOCK_MAX_SIZE)
    halo = overlap_size(cparams.strategy, cparams.window_log, overlap_log)
    halo = int(min(max(halo, DEFAULT_HALO), block_size))
    # cross-block offsets may reach up to block_size + halo back; the
    # declared window must cover them (decoders check offset <= window)
    window_log = cparams.window_log
    while n > (1 << window_log) and (1 << window_log) < block_size + halo:
        window_log += 1
    out = bytearray(write_frame_header(n, window_log, checksum))
    if n == 0:
        frame = write_blocks(out, [], data, checksum)
        return frame if rank == 0 else None

    t = _rec.on and _rec.begin("stage_in")
    nb_blocks = (n + block_size - 1) // block_size
    b_pad = -(-nb_blocks // world) * world
    rows = b_pad // world
    mine = slice(rank * rows, (rank + 1) * rows)
    arr = np.frombuffer(data, dtype=np.uint8)
    blocks, _ = TorchCompressor._batch_blocks(arr, n, mine.start, mine.stop,
                                              block_size)
    lens = np.clip(n - np.arange(b_pad) * block_size, 0,
                   block_size).astype(np.int32)
    halo_ok = np.arange(mine.start, mine.stop) > 0  # frame start: no history
    dev = group.device
    blocks = torch.from_numpy(blocks).to(dev)
    lens_d = torch.from_numpy(lens[mine]).to(dev)
    halo_ok = torch.from_numpy(halo_ok).to(dev)
    if t:
        _rec.end(t)
    own = max(min(mine.stop, nb_blocks) - mine.start, 0)
    COUNTS["blocks"] += own
    COUNTS["halo_bytes"] += own * halo

    t = _rec.on and _rec.begin("halo_exchange")
    ext = halo_rows(blocks, halo, group)
    if t:
        _rec.end(t)
    t = _rec.on and _rec.begin("stage_a")
    seq_cap = max(block_size // 4, 8)
    mls = min(max(cparams.min_match, 4), 8)
    stats, resident = analyze_sharded(ext, lens_d, halo_ok, cparams.hash_log,
                                      mls, seq_cap, halo)
    if t:
        _rec.end(t)

    # every rank plans every block (the only ordered section, zstdmt's
    # serialState), then packs its own
    t = _rec.on and _rec.begin("stats_gather")
    stats_all = gather_rows(stats, group).cpu().numpy()
    if t:
        _rec.end(t)
    t = _rec.on and _rec.begin("plan")
    comp = TorchCompressor(level=level, checksum=checksum, device=dev)
    plans, blob, *shape = comp._build_plans(stats_all, lens, cparams.strategy,
                                            halo + block_size)
    if t:
        _rec.end(t)
    t = _rec.on and _rec.begin("stage_b")
    part, sizes = _pack_sharded(resident, blob[mine], plans[0][mine], shape,
                                dev)
    if t:
        _rec.end(t)
    t = _rec.on and _rec.begin("parts_gather")
    rows, lengths = gather_padded(part, group)
    sizes = gather_rows(sizes, group)
    COUNTS["gathered_bytes"] += stats_all.nbytes + sum(lengths) \
        + sizes.numel() * sizes.element_size()
    if rank == 0:      # only rank 0 stitches: the others leave theirs there
        rows, sizes = rows.cpu().numpy(), sizes.cpu().numpy()
    if t:
        _rec.end(t)
    if rank != 0:
        return None
    parts = [rows[i, :k] for i, k in enumerate(lengths)]
    return stitch(out, comp, plans, blob, lens, parts, sizes, data,
                  nb_blocks, block_size, cparams)
