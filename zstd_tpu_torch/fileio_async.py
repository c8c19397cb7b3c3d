"""Async file I/O: read-ahead and write-behind around the codec.

Copy of zstd_tpu/fileio_async.py over the port's host codec and streaming.
Role of zstd's programs/fileio_asyncio.c (ReadPoolCtx_t / WritePoolCtx_t,
fileio_asyncio.h:40-90): dedicated threads decouple disk from
(de)compression so neither ever waits on the other. Here the reader thread
prefetches chunks into a bounded queue, the writer thread drains results,
and the caller's thread runs only the codec. Zero-run sparse writes on
decompression mirror fileio.c's sparse support (:285-296).
"""

from __future__ import annotations

import os
import queue
import threading

from .format.codec import compress
from .streaming import CompressStream, DecompressStream

_CHUNK = 4 * 1024 * 1024
_QDEPTH = 4
_SPARSE_MIN = 64 * 1024


class AsyncReader:
    """Read-ahead thread: file -> bounded chunk queue."""

    def __init__(self, path: str, chunk_size: int = _CHUNK,
                 depth: int = _QDEPTH):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._t = threading.Thread(target=self._run, args=(path, chunk_size),
                                   daemon=True)
        self._err: BaseException | None = None
        self._t.start()

    def _run(self, path: str, chunk_size: int) -> None:
        try:
            with open(path, "rb") as fh:
                while True:
                    b = fh.read(chunk_size)
                    if not b:
                        break
                    self._q.put(b)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item


class AsyncWriter:
    """Write-behind thread with optional sparse (zero-run seek) writes."""

    def __init__(self, path: str, sparse: bool = False,
                 depth: int = _QDEPTH):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._sparse = sparse
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._run, args=(path,),
                                   daemon=True)
        self._t.start()

    def _run(self, path: str) -> None:
        try:
            with open(path, "wb") as fh:
                while True:
                    b = self._q.get()
                    if b is None:
                        break
                    if self._sparse:
                        self._write_sparse(fh, b)
                    else:
                        fh.write(b)
                if self._sparse:
                    # materialize the final size even if the tail was a hole
                    fh.truncate(fh.tell())
        except BaseException as e:
            self._err = e
            # drain until the close() sentinel so producers blocked on the
            # bounded queue wake up and see the error (ENOSPC etc. must
            # surface, not deadlock write()/close())
            while self._q.get() is not None:
                pass

    @staticmethod
    def _write_sparse(fh, b: bytes) -> None:
        """Seek over long zero runs instead of writing them (fileio.c
        sparse-file support analog)."""
        pos = 0
        n = len(b)
        while pos < n:
            nz = b.find(b"\x00" * _SPARSE_MIN, pos)
            if nz < 0:
                fh.write(b[pos:])
                return
            if nz > pos:
                fh.write(b[pos:nz])
            end = nz
            while end < n and b[end] == 0:
                end += 1
            fh.seek(end - nz, os.SEEK_CUR)
            pos = end

    def write(self, b: bytes) -> None:
        while True:
            if self._err is not None:
                raise self._err
            try:
                self._q.put(b, timeout=0.2)
                return
            except queue.Full:
                continue

    def close(self) -> None:
        # always deliver the sentinel: the writer thread (or its error-path
        # drain loop) is consuming, so this put eventually succeeds
        while True:
            try:
                self._q.put(None, timeout=0.2)
                break
            except queue.Full:
                continue
        self._t.join()
        if self._err is not None:
            raise self._err


def _adapt_decide(input_starved: bool, input_waiting: bool,
                  out_backed_up: bool, level: int, lo: int, hi: int) -> int:
    """One --adapt correction, mirroring FIO_compressZstdFrame's signals
    (zstd's programs/fileio.c:1590-1666):
    - output can't flush what we produce, or input arrives slower than we
      compress -> time is free -> raise the level (better ratio);
    - input is queued up waiting on us while output keeps up -> compression
      is the bottleneck -> lower the level (more speed)."""
    if (out_backed_up or input_starved) and level < hi:
        return level + 1
    if input_waiting and not out_backed_up and level > lo:
        return level - 1
    return level


def compress_file_adaptive(src: str, dst: str, level: int = 3,
                           lo: int = 1, hi: int = 19,
                           checksum: bool = True,
                           window_log: int | None = None,
                           long_mode: bool = False,
                           chunk_size: int = _CHUNK) -> list[int]:
    """--adapt with real consumer/producer backpressure: the reader and
    writer queue fill levels are the speed feedback (fileio.c:1490's
    ZSTD_getFrameProgression loop; ours samples the async I/O queues the
    same way it samples flushed-vs-produced). Output is standard
    multi-frame zstd (one frame per chunk). Returns the per-chunk levels
    (observability / tests)."""
    level = min(max(level, lo), hi)
    r = AsyncReader(src, chunk_size=chunk_size)
    w = AsyncWriter(dst)
    levels: list[int] = []
    try:
        it = iter(r)
        while True:
            input_starved = r._q.qsize() == 0       # we'd wait on the disk
            try:
                chunk = next(it)
            except StopIteration:
                break
            input_waiting = r._q.full()             # disk is waiting on us
            levels.append(level)
            blob = compress(chunk, level=level, checksum=checksum,
                                     window_log=window_log,
                                     long_mode=long_mode)
            out_backed_up = w._q.qsize() >= w._q.maxsize - 1
            w.write(blob)
            if len(levels) >= 2:    # warm-up: let the queues reach steady
                level = _adapt_decide(input_starved, input_waiting,
                                      out_backed_up, level, lo, hi)
    finally:
        w.close()
    return levels


def compress_file_async(src: str, dst: str, level: int = 3,
                        checksum: bool = True) -> None:
    """Streaming compress with read-ahead + write-behind threads."""
    cs = CompressStream(level=level, checksum=checksum)
    w = AsyncWriter(dst)
    try:
        for chunk in AsyncReader(src):
            w.write(cs.write(chunk))
        w.write(cs.finish())
    finally:
        w.close()


def decompress_file_async(src: str, dst: str, window_log_max: int = 27,
                          sparse: bool = True) -> None:
    """Streaming decompress with read-ahead + sparse write-behind."""
    ds = DecompressStream(window_log_max=window_log_max)
    w = AsyncWriter(dst, sparse=sparse)
    try:
        for chunk in AsyncReader(src):
            w.write(ds.write(chunk))
        w.write(ds.finish())
    finally:
        w.close()
