"""Stage A of the sharded encode on rank 0's card
(parallel.zstdmt.analyze_sharded: ops/seqextract.extract_batch_xla with
kernel xla_walk, the literal gather, the stats; the halo exchange before
it is left out): the least time to move its bytes at the card's peak, as a
share of the device time of the work launched inside analyze_sharded.
Bytes: shard_bytes.stage_a_bytes of each call's frame, with rank 0's
blocks a call and the halo a block from the program's counter
zstdmt.COUNTS (shard_bytes.layout). A program without that counter gives
no reading."""

import roofline
import shard_bytes

LAYER = "stage A"
UNIT = "%"
MOVES = "encode_mbps"
SOURCE = "device_trace"
SPANS = {"stage_a": ("zstd_tpu_torch.parallel.zstdmt", "analyze_sharded")}


def read(t):
    lay = shard_bytes.layout()
    if lay is None or not t.frames:
        return None
    nbytes = [shard_bytes.stage_a_bytes(f, *lay) for f in t.frames]
    if None in nbytes:
        return None
    return roofline.share_pct(sum(nbytes), t.device_s.get("stage_a"), t.kind)
