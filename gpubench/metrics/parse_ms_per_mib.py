"""Host parse: device_decoder._parse_jobs' wall time per MiB of decoded
content (frame and block headers, literal sections, Huffman tables and the
FSE sequence decode with repcodes, in csrc/host/decode.c), timed by the
benchmark's span in a stretch that runs without the profiler."""

LAYER = "host parse"
UNIT = "ms/MiB"
MOVES = "call_p90_ms"
SOURCE = "host_clock"
SPANS = {"parse": ("zstd_tpu_torch.device_decoder", "_parse_jobs")}


def read(t):
    s = t.host_s.get("parse")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
