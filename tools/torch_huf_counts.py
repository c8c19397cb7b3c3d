#!/usr/bin/env python3
"""Counts of the Huffman kernel's segment-parallel decode on corpus lanes.

Compresses a prefix of the 16 MiB big_corpus at level 1 with the port on the
CPU (the main path's encode; about 3 s a MiB), parses the frame as the
device decoder does, and runs the Python model of csrc/huf_decode.cu
(tests/hufmodel.py) over its Huffman lanes for segments of K = 256, 512
and 1024 bit positions. Per K it prints the lanes, the segments a lane
(mean and most), the lanes that needed repair and the most repair rounds,
the longest speculative walk, and the critical path in dependent steps
(longest speculative walk + longest re-walk of each round + longest write
walk) against the longest lane's serial symbol count. These are counts,
not times.

    python3 tools/torch_huf_counts.py [MiB] [lanes]

MiB defaults to 16 (the main path's frame, about a minute to compress);
lanes, if given, models only every k-th lane so that about that many run.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from bigcorpus import big_corpus  # noqa: E402
from hufmodel import decode_lanes  # noqa: E402
from zstd_tpu_torch import device_decoder, pipeline  # noqa: E402

SEGMENTS = (256, 512, 1024)


def main() -> None:
    mib = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    corpus = big_corpus(16 * 1024 * 1024)[:mib * 1024 * 1024]
    frame = pipeline.compress(corpus, level=1, device="cpu")
    g = device_decoder._group_inputs(
        [device_decoder._parse_frame(frame, 0, 31)])
    nl = g["n_lanes"]
    step = max(nl // int(sys.argv[2]), 1) if len(sys.argv) > 2 else 1
    pick = np.arange(0, nl, step)
    nsy = g["n_syms"][pick]
    print(f"{mib} MiB -> {len(frame)} B: {nl} lanes (modelling {len(pick)}),"
          f" byte_cap {g['sb'].shape[1]}, longest lane {int(nsy.max())} "
          f"symbols, {int(g['start_bits'][pick].max())} bits", flush=True)
    for K in SEGMENTS:
        _, _, c = decode_lanes(g["sb"][pick], g["start_bits"][pick], nsy,
                               g["lut_sym"], g["lut_len"],
                               g["lane_tab"][pick], g["max_syms"], K)
        print(f"K {K}: segments a lane {c[:, 0].mean():.1f} (most "
              f"{c[:, 0].max()}), lanes repaired {int((c[:, 1] > 0).sum())},"
              f" most rounds {c[:, 1].max()}, longest speculative walk "
              f"{c[:, 2].max()} steps, critical path {c[:, 3].max()} steps "
              f"(serial {int(nsy.max())})", flush=True)


if __name__ == "__main__":
    main()
