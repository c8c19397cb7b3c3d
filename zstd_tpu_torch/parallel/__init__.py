"""Distributed execution: process groups and the one-frame sharded encode.

Counterpart of zstd_tpu/parallel/{shard_compress,zstdmt}.py on
torch.distributed. The JAX package shards a frame's blocks over the `dp` axis
of a device mesh; here they shard over the ranks of a process group, one rank
per card (NCCL), or gloo ranks on the CPU when the caller asks for them:

- `shard_compress`: the group (`make_group`, `init_group`), its collectives
  (the ring halo exchange, ordered all_gathers) and the minimal sharded step
  (`sharded_extract_fn`, `compress_step`);
- `zstdmt`: `compress_sharded`, one zstd frame encoded by every rank of the
  group, with window halos across block and rank boundaries and the in-order
  stitch on rank 0.
"""
