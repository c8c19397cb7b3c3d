#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py on the card, after building the
kernels and the host library: a shorter call than the whole script when
only those phases changed.

    python3 tools/torch_smoke_phases.py ldm pzstd

Phases: "lazy" (phase 7, chip_smoke.lazy_phase: the lazy engine's three
kernels against their plain versions, the level-5 encode and its A/B
against the plain seqstore tail, on the 16 MiB big_corpus), "ldm" (phase
9, chip_smoke.ldm_phase), "pzstd" (phase 10,
chip_smoke.pzstd_phase, on the 16 MiB big_corpus), "cli" (phase 12,
chip_smoke.cli_phase, on the same corpus) and "hostapi" (phase 13,
chip_smoke.hostapi_phase: the dictionary trainers, the seekable format and
the sequence producer, on the same corpus). Prints the card line
first and last, and each phase's output; exits non-zero if a check fails.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch

    import chip_smoke
    from bigcorpus import big_corpus
    from zstd_tpu_torch import _kernels

    if not torch.cuda.is_available():
        print("torch_smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    print(f"build: {_kernels.build_all():.1f} s (nvcc), "
          f"{_kernels.build_host():.1f} s (cc)", flush=True)
    for src, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    dev = torch.device("cuda")
    for phase in argv or ["ldm", "pzstd"]:
        if phase == "lazy":
            for k in chip_smoke.lazy_phase(
                    dev, big_corpus(chip_smoke.CORPUS_BYTES)):
                print(k, flush=True)
        elif phase == "ldm":
            chip_smoke.ldm_phase(dev)
        elif phase == "pzstd":
            chip_smoke.pzstd_phase(big_corpus(chip_smoke.CORPUS_BYTES))
        elif phase == "cli":
            chip_smoke.cli_phase(dev, big_corpus(chip_smoke.CORPUS_BYTES),
                                 ROOT)
        elif phase == "hostapi":
            chip_smoke.hostapi_phase(
                dev, big_corpus(chip_smoke.CORPUS_BYTES), ROOT)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
