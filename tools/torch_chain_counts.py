#!/usr/bin/env python3
"""Counts of the FSE chain kernel's cut-and-resolve walk on corpus blocks.

Runs the port's stage A and host planning on the CPU over 128 KiB blocks 0,
40, 43 and 100 of the 16 MiB big_corpus at level 1, then the Python model of
csrc/fse_chain.cu (tests/chainmodel.py) on the FSE inputs of stage B, for
windows of W = 64 and 128 steps. Per block and stream (LL, OF, ML) it prints
nb_seq, the segments, the longest segment, the most candidates at a cut, the
candidate walk steps per sequence and the critical path (2 x longest
segment + segments: candidate walk, replay and resolve, in dependent steps).
These are counts, not times.

    python3 tools/torch_chain_counts.py
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from bigcorpus import big_corpus  # noqa: E402
from chainmodel import chain_fields  # noqa: E402
from zstd_tpu_torch import pipeline  # noqa: E402
from zstd_tpu_torch.ops.fse_enc import T_LL, T_ML, T_OF  # noqa: E402
from zstd_tpu_torch.params import get_cparams  # noqa: E402

N_BLOCK = 128 * 1024
BLOCKS = (0, 40, 43, 100)
WINDOWS = (64, 128)
STREAMS = (("LL", T_LL), ("OF", T_OF), ("ML", T_ML))


def fse_args_cpu(corpus: bytes, blocks) -> tuple:
    """The numpy inputs of fse_fields for the given 128 KiB blocks, from the
    port's stage A and host planning on the CPU."""
    cp = get_cparams(1, len(corpus))
    mls = min(max(cp.min_match, 4), 8)
    arr = np.frombuffer(corpus, np.uint8)
    rows = torch.from_numpy(np.stack([arr[i * N_BLOCK:(i + 1) * N_BLOCK]
                                      for i in blocks]))
    lens = torch.full((len(blocks),), N_BLOCK, dtype=torch.int32)
    stats, resident = pipeline._analyze(rows, lens, cp.hash_log, mls,
                                        N_BLOCK // 8)
    comp = pipeline.TorchCompressor(level=1, device="cpu")
    _, blob, cap, *_ = comp._build_plans(stats.numpy(), lens.numpy(),
                                         cp.strategy, N_BLOCK)
    args = pipeline.fse_inputs(resident, torch.from_numpy(blob), cap)
    return tuple(a.numpy() for a in args)


def main() -> None:
    args = fse_args_cpu(big_corpus(16 * 1024 * 1024), BLOCKS)
    nb = args[6]
    for W in WINDOWS:
        _, _, counts = chain_fields(args, W)
        for k, blk in enumerate(BLOCKS):
            for name, t in STREAMS:
                segs, longest, most, walked = counts[k, t]
                print(f"block {blk} {name} W {W}: nb_seq {nb[k]}, segments "
                      f"{segs}, longest {longest}, most candidates {most}, "
                      f"candidate walk steps / nb_seq "
                      f"{walked / max(nb[k], 1):.2f}, critical path "
                      f"{2 * longest + segs}", flush=True)


if __name__ == "__main__":
    main()
