"""Long-distance discovery: ShardedLdmState's construction (the chunk's
upload, kernels ldm_fingerprint and ldm_lookback with the torch ops of the
route between them, the fetch and the host's sort), host wall time per MiB
of input, timed by the benchmark's span in a stretch that runs without the
profiler. The program's own span is `ldm_discover`."""

LAYER = "long-distance discovery"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "host_clock"
SPANS = {"ldm_discover": ("zstd_tpu_torch.parallel.ldm_sharded",
                          "ShardedLdmState.__init__")}


def read(t):
    s = t.host_s.get("ldm_discover")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
