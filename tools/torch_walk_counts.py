#!/usr/bin/env python3
"""Counts of the extract kernel's segment-parallel walk on corpus blocks.

Runs the Python model of csrc/extract.cu's walk (tests/walkmodel.py) on the
CPU over 128 KiB blocks 0, 40 and 43 of the 16 MiB big_corpus at level 1,
for 32 and 128 segments, and prints per block: nb_seq, the longest
segment's speculative steps, the repair steps (in all, and the most for one
segment in one round) and the repair rounds. These are counts, not times.

    python3 tools/torch_walk_counts.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from bigcorpus import big_corpus  # noqa: E402
from walkmodel import propose_np, segment_walk  # noqa: E402
from zstd_tpu_torch.params import get_cparams  # noqa: E402

N_BLOCK = 128 * 1024
BLOCKS = (0, 40, 43)
SEGMENTS = (32, 128)


def main() -> None:
    corpus = big_corpus(16 * 1024 * 1024)
    cp = get_cparams(1, len(corpus))
    mls = min(max(cp.min_match, 4), 8)
    arr = np.frombuffer(corpus, np.uint8)
    rows = np.stack([arr[i * N_BLOCK:(i + 1) * N_BLOCK] for i in BLOCKS])
    lens = np.full(len(BLOCKS), N_BLOCK, np.int32)
    cands, nxt = propose_np(rows, lens, cp.hash_log, mls)
    for k, blk in enumerate(BLOCKS):
        for S in SEGMENTS:
            ll, *_, (longest, repair, rounds, worst) = segment_walk(
                rows[k].tobytes(), cands[k].tolist(), nxt[k].tolist(),
                N_BLOCK, N_BLOCK // 8, S)
            print(f"block {blk} S {S}: nb_seq {len(ll)}, longest segment "
                  f"{longest} steps, repair {repair} steps (most in one "
                  f"segment {worst}) in {rounds} rounds", flush=True)


if __name__ == "__main__":
    main()
