"""Host packing: device_decoder._group_inputs' wall time per MiB of decoded
content (the parsed frames merged into the padded arrays of one fused
decode), timed by the benchmark's span in a stretch that runs without the
profiler."""

LAYER = "host packing"
UNIT = "ms/MiB"
MOVES = "call_p90_ms"
SOURCE = "host_clock"
SPANS = {"group": ("zstd_tpu_torch.device_decoder", "_group_inputs")}


def read(t):
    s = t.host_s.get("group")
    if s is None or not t.in_bytes:
        return None
    return s * 1e3 / (t.in_bytes / 2**20)
