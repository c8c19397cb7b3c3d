#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py on the card, after building the
kernels and the host library: a shorter call than the whole script when
only those phases changed.

    python3 tools/torch_smoke_phases.py ldm pzstd

Phases: "ldm" (phase 9, chip_smoke.ldm_phase) and "pzstd" (phase 10,
chip_smoke.pzstd_phase, on the 16 MiB big_corpus). Prints the card line
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
    dev = torch.device("cuda")
    for phase in argv or ["ldm", "pzstd"]:
        if phase == "ldm":
            chip_smoke.ldm_phase(dev)
        elif phase == "pzstd":
            chip_smoke.pzstd_phase(big_corpus(chip_smoke.CORPUS_BYTES))
        else:
            raise SystemExit(f"unknown phase {phase!r}")
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
