"""Host assembly of the sharded encode: parallel.zstdmt.stitch on rank 0
(TorchCompressor._region_metas, _finalize over every block from the ranks'
gathered parts, then write_blocks), host wall time per MiB of input, timed
by the benchmark's span in a stretch that runs without the profiler. The
program's own spans are `finalize` and `assemble`."""

LAYER = "host assembly"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "host_clock"
SPANS = {"stitch": ("zstd_tpu_torch.parallel.zstdmt", "stitch")}


def read(t):
    s = t.host_s.get("stitch")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
