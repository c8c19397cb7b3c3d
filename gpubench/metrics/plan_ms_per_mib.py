"""Host planning: TorchCompressor._build_plans' wall time per MiB of input
(the entropy planning from stage A's histograms, over format/fse,
format/huffman and the host C), timed by the benchmark's span in a stretch
that runs without the profiler."""

LAYER = "host planning"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "host_clock"
SPANS = {"plan": ("zstd_tpu_torch.pipeline", "TorchCompressor._build_plans")}


def read(t):
    s = t.host_s.get("plan")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
