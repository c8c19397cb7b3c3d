"""zstd_tpu_torch's multi-host pzstd on the CPU, against zstd_tpu's.

- `parallel.multihost.compress_my_shard` equals zstd_tpu's for the same
  (index, count) at levels 1, 3 and 19, with 64 KiB chunks over 320 KiB
  (zstd_tpu's on one thread). The port runs the thread executor with four
  threads, so level 19's two-pass portfolio runs on several chunks at once;
  the process executor (spawned workers) gives the same bytes.
- `decompress_stream` inverts the concatenation of every shard, a
  hint-less multi-frame stream, a single frame and a stream whose hints do
  not partition it.
"""

import concurrent.futures as fut
import sys

import pytest

from tests.bigcorpus import big_corpus
from zstd_tpu.format import codec as jcodec
from zstd_tpu.parallel import multihost as jmh
from zstd_tpu_torch.format import codec as tcodec
from zstd_tpu_torch.parallel import multihost as tmh
from zstd_tpu_torch.parallel import pzstd as tpz

DATA = big_corpus(320 * 1024)
CHUNK = 64 * 1024
SHARDS = ((0, 1), (0, 2), (1, 2), (2, 3))
LEVELS = (1, 3, 19)
_WANT = {}


def _want(level: int, index: int, count: int) -> bytes:
    key = (level, index, count)
    if key not in _WANT:
        _WANT[key] = jmh.compress_my_shard(
            DATA, level=level, chunk_size=CHUNK, process_index=index,
            process_count=count, workers=1)
    return _WANT[key]


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("level", LEVELS)
def test_compress_my_shard_equals_jax(level, shard):
    index, count = shard
    got = tmh.compress_my_shard(DATA, level=level, chunk_size=CHUNK,
                                process_index=index, process_count=count,
                                workers=4)
    assert got == _want(level, index, count)


@pytest.mark.parametrize("level", LEVELS)
def test_process_executor_equals_threads(level):
    got = tpz.pzstd_compress(DATA, level=level, chunk_size=CHUNK, workers=2,
                             shard_index=0, shard_count=2,
                             executor="process")
    assert got == _want(level, 0, 2)


def test_threads_keep_their_own_seeding_mode():
    """codec.compress at level 19 switches the DP's first-block seeding mode
    around its second encode and keeps the smaller frame. On these 8 KiB
    chunks the default mode's frame is the smaller, so a switch made by
    another thread during a chunk's first encode would change its bytes.
    The switch is per thread: 32 threads on a short switch interval give
    every chunk its serial frame."""
    chunks = [DATA[i * 4096:i * 4096 + 8192] for i in (1, 3, 4, 5, 6, 8, 9)]
    want = [tcodec.compress(c, level=19) for c in chunks]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with fut.ThreadPoolExecutor(max_workers=32) as ex:
            jobs = [ex.submit(tcodec.compress, c, level=19)
                    for _ in range(6) for c in chunks]
            got = [j.result(timeout=120) for j in jobs]
    finally:
        sys.setswitchinterval(old)
    assert got == want * 6


@pytest.mark.parametrize("count", (1, 2, 3))
def test_decompress_stream_inverts_the_shards(count):
    blob = b"".join(_want(19 if count == 3 else 1, i, count)
                    for i in range(count))
    assert tmh.decompress_stream(blob) == DATA


def test_decompress_stream_without_hints():
    frames = [jcodec.compress(DATA[i:i + 100_000], level=3)
              for i in range(0, len(DATA), 100_000)]
    assert tmh.decompress_stream(b"".join(frames)) == DATA
    one = tcodec.compress(DATA, level=5)
    assert tmh.decompress_stream(one) == DATA
    # a hint one byte too long no longer partitions the stream: decoded
    # frame by frame, the hints skipped as skippable frames
    bad = _want(1, 0, 1)
    bad = bad[:8] + (int.from_bytes(bad[8:12], "little") + 1).to_bytes(
        4, "little") + bad[12:]
    assert tmh.decompress_stream(bad) == DATA


def test_shard_of_no_chunks():
    """More processes than chunks: the last ones compress nothing, here and
    in zstd_tpu."""
    got = tmh.compress_my_shard(DATA[:CHUNK], level=1, chunk_size=CHUNK,
                                process_index=1, process_count=2)
    assert got == b"" == jmh.compress_my_shard(
        DATA[:CHUNK], level=1, chunk_size=CHUNK, process_index=1,
        process_count=2, workers=1)
