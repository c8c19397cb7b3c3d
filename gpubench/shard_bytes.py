"""The bytes of the sharded stage A's and stage B's rooflines
(metrics/stage_a_roofline_pct.sharded.py, stage_b_roofline_pct.sharded.py):
what rank 0's part of each stage in parallel.zstdmt.compress_sharded must
move at the least, whatever implements it, and rank 0's share of the frame
(layout) from the program's counter.

Rank 0 holds the frame's first blocks. Each of its rows is read once: the
block's content and the halo in front of it (zstdmt's overlap, the window
context a worker loads before its job). Then, as roofline.stage_a_bytes
counts them, 12 B a sequence and 1 B a literal handed on to stage B, from
the frame's block headers. What the exchange moves is the collectives'
cost, not stage A's. Stage B reads those sequences and literals once and
writes the compressed blocks' payloads once, as roofline.stage_b_bytes
counts them, over rank 0's blocks.
"""

from __future__ import annotations

import ldm_bytes
import roofline

BLOCK = 128 * 1024          # compress_sharded's block at windows of 128 KiB up


def stage_a_bytes(frame: bytes, rows: int, halo: int,
                  block: int = BLOCK) -> int | None:
    """The least bytes rank 0's stage A moves for one frame: its `rows`
    blocks (the frame's first) read once with `halo` bytes in front of
    each, and their sequences and literals handed on. None where the frame
    declares no content size."""
    n = ldm_bytes.content_size(frame)
    if n is None:
        return None
    mine = roofline.blocks(frame)[:rows]
    read = sum(min(block, n - i * block) + halo for i in range(len(mine)))
    return read + sum(roofline.SEQ_BYTES * nseq + lits
                      for t, _, lits, nseq in mine if t == 2)


def stage_b_bytes(frame: bytes, rows: int) -> int:
    """The least bytes rank 0's stage B moves for one frame: the sequences
    and literals of its `rows` blocks (the frame's first) read once, and the
    compressed ones' payloads written once at their sizes."""
    return sum(roofline.SEQ_BYTES * nseq + lits + size
               for t, size, lits, nseq in roofline.blocks(frame)[:rows]
               if t == 2)


def layout() -> tuple[int, int] | None:
    """(rank 0's blocks a call, halo bytes a block) from zstdmt.COUNTS
    (blocks, halo_bytes and calls since the process started, every call on
    an input of the same size); None where the program has no such counter
    or its calls differ."""
    from zstd_tpu_torch.parallel import zstdmt
    c = getattr(zstdmt, "COUNTS", {})
    calls, blocks = c.get("calls"), c.get("blocks")
    if not calls or not blocks or "halo_bytes" not in c \
            or blocks % calls or c["halo_bytes"] % blocks:
        return None
    return blocks // calls, c["halo_bytes"] // blocks
