"""Gap parse: format/ldm.find_sequences_ldm less the long-match walk inside
it, that is the level's own match finder over the gaps between long
matches (the C of csrc/host through format/opt.py) and the block's
sequence store, host wall time per MiB of input, timed by the benchmark's
spans in a stretch that runs without the profiler. find_sequences_ldm is
wrapped where format/block.py calls it. The program's own span is
`gap_parse`."""

LAYER = "gap parse"
UNIT = "ms/MiB"
MOVES = "encode_mbps"
SOURCE = "host_clock"
SPANS = {"ldm_block": ("zstd_tpu_torch.format.block", "find_sequences_ldm"),
         "ldm_walk": ("zstd_tpu_torch.parallel.ldm_sharded",
                      "ShardedLdmState.find_long_matches")}


def read(t):
    block, walk = t.host_s.get("ldm_block"), t.host_s.get("ldm_walk")
    if block is None or walk is None or not t.in_bytes:
        return None
    return (block - walk) * 1e3 / (t.in_bytes / 2**20)
