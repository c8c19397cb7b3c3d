#!/usr/bin/env python3
"""Time zstd_tpu_torch's level-1 encode of the 16 MiB corpus from one tree.

Compares two commits on one card in one call: unpack each into a directory
(for example with `git archive`) and run this script once per tree, in the
order parent, change, change, parent:

    python3 tools/torch_encode_ab.py build/parent

It builds that tree's kernels, encodes once to warm up, then prints one JSON
line: the frame size, three end-to-end rates (MB/s) and
`TorchCompressor.device_stage_mbps`. Needs one CUDA device.
"""

import json, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root); sys.path.insert(0, os.path.join(root, "tests"))
import torch
from bigcorpus import big_corpus
from zstd_tpu_torch import _kernels, pipeline
assert _kernels.__file__.startswith(root), _kernels.__file__
_kernels.build_all()
corpus = big_corpus(16 << 20)
dev = torch.device("cuda")
pipeline.compress(corpus, level=1, device=dev)
ts = []
for _ in range(3):
    t0 = time.perf_counter()
    f = pipeline.compress(corpus, level=1, device=dev)
    ts.append(time.perf_counter() - t0)
stage = pipeline.TorchCompressor(level=1, device=dev).device_stage_mbps(corpus)
print(json.dumps(dict(tree=sys.argv[1], frame=len(f),
                      mbps=[len(corpus) / t / 1e6 for t in ts],
                      stage_mbps=stage)), flush=True)
