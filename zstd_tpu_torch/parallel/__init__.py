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
  environment), `gather_and_concat` (each process's shard on process 0),
  and `compress_my_shard` / `decompress_stream`, this process's chunk range
  as pzstd frames and their decode;
- `pzstd`: `pzstd_compress` / `pzstd_decompress`, independent frames with
  size hints over the host codec (format/codec.py), on a process or thread
  pool.
"""

import importlib

_ENTRY = {"ShardGroup": "shard_compress", "init_group": "shard_compress",
          "make_group": "shard_compress", "compress_sharded": "zstdmt",
          "ShardedLdmState": "ldm_sharded",
          "compress_long_sharded": "ldm_sharded",
          "compress_my_shard": "multihost", "decompress_stream": "multihost",
          "gather_and_concat": "multihost", "init_distributed": "multihost",
          "pzstd_compress": "pzstd", "pzstd_decompress": "pzstd"}

__all__ = sorted(_ENTRY)


def __getattr__(name: str):
    # loaded on first use: pzstd's spawned workers import this package but
    # need only the host codec, not torch
    if name not in _ENTRY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_ENTRY[name]}", __name__),
                   name)
