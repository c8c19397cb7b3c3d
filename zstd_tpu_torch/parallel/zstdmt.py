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
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BLOCK_MAX_SIZE, BT_RAW, BT_RLE
from ..format.frame import write_frame_header
from ..ops.seqextract import extract_batch_xla
from ..params import get_cparams
from ..pipeline import TorchCompressor, _pack, stage_a_stats
from ..xxhash64 import content_checksum
from .shard_compress import (ShardGroup, gather_bytes, gather_rows,
                             halo_rows, make_group)

DEFAULT_HALO = 512   # floor: always at least the round-2 short halo


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


def _analyze_sharded(blocks: torch.Tensor, lens: torch.Tensor,
                     halo_ok: torch.Tensor, grp: ShardGroup, hash_log: int,
                     mls: int, seq_cap: int, halo: int):
    """Stage A of this rank's blocks: halo exchange, extract and stats.
    blocks u8[b, n] (the rank's blocks, zero-padded), lens i32[b] content
    lengths, halo_ok bool[b]. Returns (stats i32[b, 1152], resident dict),
    as pipeline._analyze does."""
    ext = halo_rows(blocks, halo, grp)
    b, width = ext.shape
    emit_from = torch.full((b,), halo, dtype=torch.int32, device=ext.device)
    res = extract_batch_xla(ext, lens + halo, hash_log, mls, seq_cap,
                            emit_from=emit_from, halo_ok=halo_ok)
    lits = ext.gather(1, res["lit_idx"].to(torch.int64))
    j = torch.arange(width, device=ext.device)[None, :]
    all_same = ((ext == ext[:, halo:halo + 1]) | (j < halo)
                | (j >= halo + lens.to(torch.int64)[:, None])).all(dim=1)
    return stage_a_stats(res, lits, all_same)


def _pack_sharded(resident: dict, blob: np.ndarray, plans: list, shape: tuple,
                  device):
    """Stage B of this rank's blocks: pack and compact them. Returns (the
    tight compact bytes u8[total], sizes i32[b, 7])."""
    compact, sizes = _pack(resident, torch.from_numpy(blob).to(device),
                           *shape)
    sizes = sizes.cpu().numpy()
    _, total = TorchCompressor._region_metas(plans, sizes)
    hdr = len(plans) * 7 * 4
    return compact[hdr:hdr + total].cpu().numpy(), sizes


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
    if group is None:
        group = make_group(device)
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
        out += (1 | (BT_RAW << 1)).to_bytes(3, "little")
        if checksum:
            out += content_checksum(b"").to_bytes(4, "little")
        return bytes(out) if rank == 0 else None

    nb_blocks = (n + block_size - 1) // block_size
    b_pad = -(-nb_blocks // world) * world
    rows = b_pad // world
    mine = range(rank * rows, (rank + 1) * rows)
    arr = np.frombuffer(data, dtype=np.uint8)
    lens = np.zeros(b_pad, dtype=np.int32)
    for bi in range(nb_blocks):
        lens[bi] = min(block_size, n - bi * block_size)
    blocks = np.zeros((rows, block_size), dtype=np.uint8)
    for j, bi in enumerate(mine):
        s = bi * block_size
        blocks[j, :lens[bi]] = arr[s:s + lens[bi]]
    halo_ok = np.array([bi > 0 for bi in mine])   # frame start: no history

    dev = group.device
    seq_cap = max(block_size // 4, 8)
    mls = min(max(cparams.min_match, 4), 8)
    stats, resident = _analyze_sharded(
        torch.from_numpy(blocks).to(dev),
        torch.from_numpy(lens[rank * rows:(rank + 1) * rows]).to(dev),
        torch.from_numpy(halo_ok).to(dev), group, cparams.hash_log, mls,
        seq_cap, halo)

    # every rank plans every block (the only ordered section, zstdmt's
    # serialState), then packs its own
    stats_all = gather_rows(stats, group).cpu().numpy()
    comp = TorchCompressor(level=level, checksum=checksum, device=dev)
    plans, blob, *shape = comp._build_plans(stats_all, lens, cparams.strategy,
                                            halo + block_size)
    part, sizes = _pack_sharded(resident, blob[rank * rows:(rank + 1) * rows],
                                plans[rank * rows:(rank + 1) * rows], shape,
                                dev)
    parts = gather_bytes(part, group)
    sizes = gather_rows(torch.from_numpy(sizes).to(dev), group).cpu().numpy()
    if rank != 0:
        return None

    # in-order stitch (flushProduced analog)
    metas, base = [], 0
    for s in range(world):
        m_s, total = TorchCompressor._region_metas(
            plans[s * rows:(s + 1) * rows], sizes[s * rows:(s + 1) * rows])
        for m in m_s:
            metas.append(dict(zeroed=m["zeroed"],
                              fse=(m["fse"][0] + base, m["fse"][1]),
                              huf=[(o + base, z) for o, z in m["huf"]],
                              raw=(m["raw"][0] + base, m["raw"][1])))
        base += total
    payloads = comp._finalize(plans, metas, np.concatenate(parts), arr, 0,
                              block_size, cparams)[:nb_blocks]
    for i, (payload, btype, blen) in enumerate(payloads):
        last = i == len(payloads) - 1
        if btype == BT_RLE:
            bh = int(last) | (BT_RLE << 1) | (blen << 3)
        else:
            bh = int(last) | (btype << 1) | (len(payload) << 3)
        out += bh.to_bytes(3, "little")
        out += payload
    if checksum:
        out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)
