"""Host assembly: TorchCompressor._finalize's wall time per MiB of input
(the blocks' sections and payloads from the fetched streams), timed by the
benchmark's span in a stretch that runs without the profiler."""

LAYER = "host assembly"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "host_clock"
SPANS = {"finalize": ("zstd_tpu_torch.pipeline", "TorchCompressor._finalize")}


def read(t):
    s = t.host_s.get("finalize")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
