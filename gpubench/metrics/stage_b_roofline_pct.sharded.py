"""Stage B of the sharded encode on rank 0's card (pipeline._pack as
parallel.zstdmt calls it for the rank's own blocks: kernel fse_chain,
ops/bitpack, ops/huffman_enc, the compaction): the least time to move its
bytes at the card's peak, as a share of the device time of the work
launched inside that _pack. Bytes: shard_bytes.stage_b_bytes of each
call's frame over rank 0's blocks, their number from the program's
counter zstdmt.COUNTS (shard_bytes.layout). A program without that
counter gives no reading."""

import roofline
import shard_bytes

LAYER = "stage B"
UNIT = "%"
MOVES = "encode_mbps"
SOURCE = "device_trace"
SPANS = {"stage_b": ("zstd_tpu_torch.parallel.zstdmt", "_pack")}


def read(t):
    lay = shard_bytes.layout()
    if lay is None or not t.frames:
        return None
    nbytes = sum(shard_bytes.stage_b_bytes(f, lay[0]) for f in t.frames)
    return roofline.share_pct(nbytes, t.device_s.get("stage_b"), t.kind)
