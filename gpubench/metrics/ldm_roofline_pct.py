"""Device discovery (ldm_sharded.discover: kernel ldm_fingerprint, the
torch ops that compact and sort the anchors by owner, kernel ldm_lookback):
the least time to move its bytes at the card's peak, as a share of the
device time of the work launched inside discover. Bytes:
ldm_bytes.discovery_bytes of each call's input, its size from the frame's
header, with the anchors a call keeps (the program's counter
ldm_sharded.COUNTS: anchors over calls since the process started, every
call on an input of the same pool). A program without that counter gives
no reading."""

import ldm_bytes
import roofline

LAYER = "device discovery"
UNIT = "%"
MOVES = "encode_mbps"
SOURCE = "device_trace"
SPANS = {"ldm_device": ("zstd_tpu_torch.parallel.ldm_sharded", "discover")}


def anchors_per_call() -> float | None:
    from zstd_tpu_torch.parallel import ldm_sharded
    counts = getattr(ldm_sharded, "COUNTS", {})
    if not counts.get("calls") or "anchors" not in counts:
        return None
    return counts["anchors"] / counts["calls"]


def read(t):
    sizes = [ldm_bytes.content_size(f) for f in t.frames]
    anchors = anchors_per_call()
    if not sizes or None in sizes or anchors is None:
        return None
    return roofline.share_pct(
        sum(ldm_bytes.discovery_bytes(n, anchors) for n in sizes),
        t.device_s.get("ldm_device"), t.kind)
