"""The device's idle share over the traced stretch of whole compress calls:
1 - busy / wall, busy the union of the card's kernel and copy intervals in
the profiled run of the stretch, wall the same calls' wall time by the
host's clock without the profiler (whose own cost would lengthen it)."""

LAYER = "device"
UNIT = "%"
MOVES = "encode_mbps"
SOURCE = "device_trace"
SPANS = {}


def read(t):
    if not t.wall_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
