"""Distributed execution: process groups, the one-frame sharded encode, the
sharded long-distance matcher and the multi-host runtime.

Counterpart of zstd_tpu/parallel/{shard_compress,zstdmt,ldm_sharded,
multihost}.py on torch.distributed. The JAX package shards over the `dp`
axis of a device mesh; here the work shards over the ranks of a process
group, one rank per card (NCCL), or gloo ranks on the CPU when the caller
asks for them:

- `shard_compress`: the group (`make_group`, `init_group`), its collectives
  (the ring halo exchange, ordered all_gathers) and the minimal sharded step
  (`sharded_extract_fn`, `compress_step`);
- `zstdmt`: `compress_sharded`, one zstd frame encoded by every rank of the
  group, with window halos across block and rank boundaries and the in-order
  stitch on rank 0;
- `ldm_sharded`: `ShardedLdmState`, the --long candidate discovery with each
  rank fingerprinting its own chunk (kernel csrc/ldm_fingerprint.cu) and
  owning a range of bucket keys (all_to_all, then kernel
  csrc/ldm_lookback.cu), and `compress_long_sharded`, the --long frame
  through it and the host frame encoder, the same on every rank;
- `multihost`: `init_distributed` (torch.distributed from the standard
  environment) and `gather_and_concat` (each process's shard on process 0).
"""

from .ldm_sharded import ShardedLdmState, compress_long_sharded
from .multihost import gather_and_concat, init_distributed
from .shard_compress import ShardGroup, init_group, make_group
from .zstdmt import compress_sharded

__all__ = ["ShardGroup", "ShardedLdmState", "compress_long_sharded",
           "compress_sharded", "gather_and_concat", "init_distributed",
           "init_group", "make_group"]
