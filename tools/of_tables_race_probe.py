#!/usr/bin/env python3
"""Decode frames on many threads at the first decode of a fresh process,
with the host block decoder of zstd_tpu and of zstd_tpu_torch, and count
the decodes that differ from the input.

    JAX_PLATFORMS=cpu python3 tools/of_tables_race_probe.py [trials] [threads]

native/decode.c fills its offset-code value tables (OF_BASEV, OF_BITSV) on
the first decode of a sequences section, behind a check of OF_BASEV[1],
which it writes before entries 2-31. A thread that decodes its first
sequences section while another one fills the tables can read zeros there.
The C runs outside the GIL, so pzstd's decode threads may do just that.
zstd_tpu_torch/csrc/host/decode.c initialises the tables at compile time.

The window is open once per process, so each trial is a fresh process:
`threads` threads wait on a barrier, then each decodes the sequences of a
level-3 frame of tests/bigcorpus.big_corpus through the C (zstd_tpu: each
sequences section by `decode_sequences`, which reaches the tables after the
section's first bytes, on one decoder context a thread; zstd_tpu_torch: the
frame's blocks in one call of `parse_frame`) and the whole frame
(`format.frame.decompress_frame`). Runs on the CPU; prints, for each
library, the trials and the decodes that differed.
"""

from __future__ import annotations

import concurrent.futures as fut
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(lib: str, threads: int) -> int:
    """One trial: prints the number of decodes that differed."""
    sys.path.insert(0, ROOT)
    from tests.bigcorpus import big_corpus
    from tests.decodecases import sequence_sections
    from zstd_tpu_torch.format import codec as tcodec
    data = big_corpus(256 * 1024)
    frame = tcodec.compress(data, level=3)
    if lib == "zstd_tpu":
        from zstd_tpu.format.frame import decompress_frame, parse_frame_header
        from zstd_tpu.native import get_native
        nat = get_native()
        # the sections where the port's host parse cuts them
        sections = sequence_sections(
            frame[parse_frame_header(frame, 31).header_size:])

        def decode():
            # None where the C refuses a section (zstd_tpu's device decode
            # then raises "sequences section decode failed")
            ctx = nat.dctx_new()
            try:
                return [None if r is None else tuple(a.tolist() for a in r)
                        for r in (nat.decode_sequences(ctx, s)
                                  for s in sections)]
            finally:
                nat.dctx_free(ctx)
    else:
        from zstd_tpu_torch import native as nat
        from zstd_tpu_torch.format.frame import (decompress_frame,
                                                 parse_frame_header)
        body = parse_frame_header(frame, 31).header_size

        def decode():
            # a negative code where the C refuses the frame
            r = nat.parse_frame(frame, body, 1 << 62, 1 << 30)
            return r if isinstance(r, int) else \
                tuple(r[k].tolist() for k in ("ll", "ml", "off"))
    gate = threading.Barrier(threads)

    def one(k: int):
        gate.wait()
        if k % 2:
            # a block the C declines is decoded again by the Python branch,
            # so only a wrong content shows here
            return decompress_frame(frame, 0)[0] == data
        return decode()

    with fut.ThreadPoolExecutor(max_workers=threads) as ex:
        got = list(ex.map(one, range(threads)))
    # the serial sequences, decoded after the tables are filled
    want = decode()
    bad = sum(1 for k, g in enumerate(got)
              if ((g is not True) if k % 2 else (g != want)))
    print(bad)
    return 0


def main(argv: list[str]) -> int:
    if argv and argv[0] == "--child":
        return child(argv[1], int(argv[2]))
    trials = int(argv[0]) if argv else 200
    threads = int(argv[1]) if len(argv) > 1 else 16
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for lib in ("zstd_tpu", "zstd_tpu_torch"):
        def trial(_):
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", lib,
                 str(threads)], capture_output=True, text=True, env=env,
                timeout=300)
            if r.returncode:
                raise RuntimeError(r.stderr)
            return int(r.stdout.split()[-1])
        with fut.ThreadPoolExecutor(max_workers=4) as ex:
            bad = list(ex.map(trial, range(trials)))
        hit = [b for b in bad if b]
        print(f"{lib}: {len(hit)} of {trials} trials ({threads} threads "
              f"each) had decodes that differ from the serial ones; "
              f"{sum(bad)} decodes in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
