"""Stage B (pipeline._pack: kernel fse_chain, ops/bitpack,
ops/huffman_enc, the compaction): the least time to move its bytes at the
card's peak, as a share of the device time of the work launched inside
_pack. Bytes: roofline.stage_b_bytes, from the frames' block headers."""

import roofline

LAYER = "stage B"
UNIT = "%"
MOVES = "encode_mbps"
SOURCE = "device_trace"
SPANS = {"pack": ("zstd_tpu_torch.pipeline", "_pack")}


def read(t):
    return roofline.share_pct(roofline.stage_b_bytes(t.frames),
                              t.device_s.get("pack"), t.kind)
