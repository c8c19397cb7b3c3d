"""The device decode (device_decoder._dispatch_group: the uploads and
ops/decode_dev.fused_frame_decode; kernels huf_decode and exec_seq): the
least time to move its bytes at the card's peak, as a share of the device
time of the work launched inside _dispatch_group. Bytes:
roofline.decode_bytes, from the frames' block headers and the decoded
content."""

import roofline

LAYER = "device decode"
UNIT = "%"
MOVES = "call_p90_ms"
SOURCE = "device_trace"
SPANS = {"dispatch": ("zstd_tpu_torch.device_decoder", "_dispatch_group")}


def read(t):
    return roofline.share_pct(roofline.decode_bytes(t.frames, t.in_bytes),
                              t.device_s.get("dispatch"), t.kind)
