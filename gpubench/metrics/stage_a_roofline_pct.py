"""Stage A (pipeline._analyze: ops/match, ops/fastmatch, ops/seqextract,
ops/codes; kernels extract, lazy_resolve, seq_merge, seq_finish): the least
time to move its bytes at the card's peak, as a share of the device time of
the work launched inside _analyze. Bytes: roofline.stage_a_bytes, from the
inputs and the frames' block headers."""

import roofline

LAYER = "stage A"
UNIT = "%"
MOVES = "encode_mbps"
SOURCE = "device_trace"
SPANS = {"analyze": ("zstd_tpu_torch.pipeline", "_analyze")}


def read(t):
    return roofline.share_pct(roofline.stage_a_bytes(t.frames, t.in_bytes),
                              t.device_s.get("analyze"), t.kind)
