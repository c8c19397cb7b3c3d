"""zstd_tpu_torch.parallel.multihost on the CPU: init_distributed from its
arguments and the standard environment, and gather_and_concat in gloo
groups of 1 and 2 spawned ranks (tests/torchdist.py, job kind "gather":
rank 0 gets every shard in rank order, the other ranks None, and every
rank's init_distributed() returns its (rank, world)); compress_my_shard
with the index and count from a group of 2 (job kind "shard") against
zstd_tpu's for the same (index, count)."""

import pytest
import torch.distributed as dist

from tests.bigcorpus import big_corpus
from tests.refnative import reference_native
from tests.torchdist import run_groups
from zstd_tpu.parallel import multihost as jmh
from zstd_tpu_torch.parallel import multihost

SHARDS = [b"\x28\xb5\x2f\xfd" + bytes(range(40)), b"", b"x" * 70_001]
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
PZSTD = big_corpus(192 * 1024)


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    return run_groups((1, 2), str(tmp_path_factory.mktemp("gather")),
                      [("shards", "gather", dict(shards=SHARDS)),
                       ("pzstd", "shard", dict(data=PZSTD, level=3,
                                               chunk_size=64 * 1024,
                                               workers=1))])


def test_compress_my_shard_takes_rank_and_world_from_the_group(gathered):
    assert reference_native() is not None   # zstd_tpu's frames need its C
    got = gathered[2]["pzstd"]
    want = [jmh.compress_my_shard(PZSTD, level=3, chunk_size=64 * 1024,
                                  process_index=i, process_count=2,
                                  workers=1) for i in range(2)]
    assert got == want and all(want)
    assert multihost.decompress_stream(b"".join(got)) == PZSTD
    assert gathered[1]["pzstd"] == [jmh.compress_my_shard(
        PZSTD, level=3, chunk_size=64 * 1024, process_index=0,
        process_count=1, workers=1)]


@pytest.mark.parametrize("world", (1, 2))
def test_gather_and_concat_orders_on_rank_0(gathered, world):
    assert gathered[world]["shards"] == SHARDS[:world]


@pytest.fixture
def no_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()


def test_init_distributed_single_process(no_env):
    assert multihost.init_distributed() == (0, 1)
    assert not dist.is_initialized()


def test_init_distributed_world_of_one_from_env(no_env, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29999")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert multihost.init_distributed() == (0, 1)
    assert not dist.is_initialized()


def test_init_distributed_needs_a_rank(no_env):
    with pytest.raises(ValueError, match="RANK"):
        multihost.init_distributed("tcp://127.0.0.1:29999", 2)


def test_gather_single_process(no_env):
    assert multihost.gather_and_concat(SHARDS[0]) == [SHARDS[0]]
