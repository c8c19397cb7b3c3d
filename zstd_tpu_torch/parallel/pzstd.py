"""pzstd-style multi-frame parallel (de)compression on the host.

Copy of pzstd_compress and pzstd_decompress in zstd_tpu/parallel/pzstd.py,
with content-defined (rsyncable) chunk boundaries. Same model as zstd's
contrib/pzstd/Pzstd.cpp:73 (asyncCompressChunks / asyncDecompressFrames):
the input is split into chunks compressed as INDEPENDENT frames, each
preceded by a 12-byte skippable frame whose 4-byte payload records the next
frame's compressed size, so a parallel decoder can partition the stream
without parsing it. The output is standard multi-frame zstd.

The chunks go through the host codec (format/codec.py). Compute parallelism
comes from a process pool (spawned workers import only the host codec) or a
thread pool: the C parsers run with the GIL released, the entropy stage in
Python does not.
"""

from __future__ import annotations

import concurrent.futures as _fut
import multiprocessing
import os

from ..constants import SKIPPABLE_MAGIC_MIN
from ..format.codec import compress as _compress, decompress as _decompress
from ..format.frame import is_skippable
from ..rsync import split_rsyncable

_HINT_VARIANT = 0  # pzstd uses the base skippable magic for its size hints


def _size_hint(frame_size: int) -> bytes:
    return ((SKIPPABLE_MAGIC_MIN + _HINT_VARIANT).to_bytes(4, "little")
            + (4).to_bytes(4, "little")
            + frame_size.to_bytes(4, "little"))


def _proc_encode(args: tuple[bytes, int, bool]) -> bytes:
    """Process-pool worker: compress one chunk into an independent frame."""
    chunk, level, checksum = args
    from zstd_tpu_torch.format.codec import compress
    return compress(chunk, level=level, checksum=checksum)


def pzstd_compress(data: bytes, level: int = 3, checksum: bool = False,
                   chunk_size: int | None = None, workers: int = 4,
                   shard_index: int = 0, shard_count: int = 1,
                   executor: str = "auto",
                   rsync_log: int | None = None) -> bytes:
    """Parallel multi-frame compression.

    shard_index/shard_count: multi-host mode — this host compresses only its
    contiguous chunk range; hosts concatenate outputs in shard order.
    executor: 'process' (spawned workers), 'thread', or 'auto' (a process
    pool when the machine has the cores and there are several chunks).
    rsync_log: when set, chunk boundaries are content-defined sync points
    with mean spacing 2^rsync_log (ZSTD_c_rsyncable analog: local edits
    re-synchronize the frame stream so rsync transfers only changed
    frames)."""
    if rsync_log is not None:
        chunks = split_rsyncable(data, avg_log=rsync_log) or [data]
    else:
        if chunk_size is None:
            chunk_size = max(1 << 22, len(data) // max(workers * 4, 1) or 1)
        chunks = [data[i : i + chunk_size]
                  for i in range(0, max(len(data), 1), chunk_size)]
    mine = chunks
    # preserve global order for multi-host: contiguous ranges, not strides
    if shard_count > 1:
        per = (len(chunks) + shard_count - 1) // shard_count
        mine = chunks[shard_index * per : (shard_index + 1) * per]

    if executor == "auto":
        executor = ("process" if (os.cpu_count() or 1) > 1 and len(mine) > 1
                    and workers > 1 else "thread")

    if executor == "process" and mine:
        with _fut.ProcessPoolExecutor(
                max_workers=min(workers, len(mine)),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            frames = list(ex.map(
                _proc_encode, [(c, level, checksum) for c in mine]))
    else:
        with _fut.ThreadPoolExecutor(max_workers=workers) as ex:
            frames = list(ex.map(
                lambda c: _compress(c, level=level, checksum=checksum),
                mine))
    out = bytearray()
    for f in frames:
        out += _size_hint(len(f))
        out += f
    return bytes(out)


def pzstd_decompress(data: bytes, workers: int = 4,
                     window_log_max: int = 27) -> bytes:
    """Parallel multi-frame decompression. Uses the size hints to partition;
    decodes sequentially when hints are absent."""
    spans: list[tuple[int, int]] = []
    pos = 0
    ok = True
    while pos < len(data):
        if not is_skippable(data, pos):
            ok = False
            break
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        if size != 4 or pos + 12 > len(data):
            ok = False
            break
        fsize = int.from_bytes(data[pos + 8 : pos + 12], "little")
        start = pos + 12
        if start + fsize > len(data):
            ok = False
            break
        spans.append((start, start + fsize))
        pos = start + fsize
    if not ok or not spans:
        return _decompress(data, window_log_max=window_log_max)

    def one(span: tuple[int, int]) -> bytes:
        return _decompress(data[span[0] : span[1]],
                           window_log_max=window_log_max)

    with _fut.ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(one, spans))
    return b"".join(parts)
