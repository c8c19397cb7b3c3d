"""The 1 MiB cell's rate: input bytes of the traced stretch's calls over
the stretch's wall by the host's clock, without the profiler. The window's
rate of 1 MiB calls swings with the host by more than an end-to-end bound
may allow, so it is read here, and the cell's latency is what it moves."""

LAYER = "driver"
UNIT = "MB/s"
MOVES = "call_p90_ms"
SOURCE = "host_clock"
SPANS = {}


def read(t):
    if not t.wall_s or not t.in_bytes:
        return None
    return t.in_bytes / 1e6 / t.wall_s
