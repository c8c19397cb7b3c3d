"""Long-match walk: ShardedLdmState.find_long_matches (the host's greedy
verify and commit of each block's long matches against the discovered
candidates), host wall time per MiB of input, timed by the benchmark's
span in a stretch that runs without the profiler. The program's own span is
`ldm_walk`."""

LAYER = "long-match walk"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "host_clock"
SPANS = {"ldm_walk": ("zstd_tpu_torch.parallel.ldm_sharded",
                      "ShardedLdmState.find_long_matches")}


def read(t):
    s = t.host_s.get("ldm_walk")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
