#!/usr/bin/env python3
"""Compress small chunks at level 19 on many threads at once, with the host
codec of zstd_tpu and of zstd_tpu_torch, and count the frames that differ
from each chunk's serial frame.

    JAX_PLATFORMS=cpu python3 tools/twopass_race_probe.py [trials]

format/codec.compress switches the DP's first-block seeding mode (the
twopass knob of the C optimal parser) around its second encode. In
zstd_tpu the knob is process-global (native/opt.c), so another thread's
encode can run with the wrong mode; in zstd_tpu_torch it is thread-local
(zstd_tpu_torch/csrc/host/opt.c). The chunks are 8 KiB of
tests/bigcorpus.big_corpus on which the default mode's frame is the
smaller, so a wrong mode shows as a larger frame. Every frame is also
checked to decode. Runs on the CPU.
"""

from __future__ import annotations

import concurrent.futures as fut
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    from tests.bigcorpus import big_corpus
    from zstd_tpu.format import codec as jcodec
    from zstd_tpu_torch.format import codec as tcodec

    trials = int(argv[0]) if argv else 3
    data = big_corpus(320 * 1024)
    chunks = [data[i * 4096:i * 4096 + 8192] for i in (1, 3, 4, 5, 6, 8, 9)]
    sys.setswitchinterval(1e-6)
    for name, codec in (("zstd_tpu", jcodec), ("zstd_tpu_torch", tcodec)):
        want = [codec.compress(c, level=19) for c in chunks]
        for trial in range(trials):
            with fut.ThreadPoolExecutor(max_workers=32) as ex:
                got = list(ex.map(lambda c: codec.compress(c, level=19),
                                  chunks * 6))
            diff = [(k % len(chunks), len(g), len(w))
                    for k, (g, w) in enumerate(zip(got, want * 6)) if g != w]
            assert all(tcodec.decompress(g) == c
                       for g, c in zip(got, chunks * 6)), "a frame is corrupt"
            print(f"{name} trial {trial}: {len(diff)} of {len(got)} frames "
                  f"differ from the serial ones (chunk, bytes, serial "
                  f"bytes): {diff}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
