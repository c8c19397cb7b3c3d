"""Collectives of the sharded encode on rank 0's card, per MiB of input:
the device time of the work launched inside parallel.zstdmt's halo_rows
(the ring: an all_gather of each rank's last block's tail), gather_rows
(the all_gathers of the stats rows and of the parts' sizes rows) and
gather_padded (the parts' lengths, then the parts padded to the longest):
the NCCL kernels, each holding the wait for the other ranks, the padding
and the concatenations of what they gathered. The host copies of what was
gathered come after these functions return, and are not counted. The
program's own spans are `halo_exchange`, `stats_gather` and
`parts_gather`."""

LAYER = "collectives"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "device_trace"
_ZSTDMT = "zstd_tpu_torch.parallel.zstdmt"
SPANS = {"halo_exchange": (_ZSTDMT, "halo_rows"),
         "gathers": (_ZSTDMT, "gather_rows"),
         "parts_gather": (_ZSTDMT, "gather_padded")}


def read(t):
    s = [t.device_s.get(k) for k in SPANS]
    if None in s or not t.in_bytes:
        return None
    return sum(s) * 1e3 / (t.in_bytes / 2**20)
