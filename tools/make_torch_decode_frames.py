#!/usr/bin/env python3
"""Write the decode fixture frames of tests/data/torch_decode/.

The frames come from encoders other than zstd_tpu_torch's level-1 path, so
that the port's device decoder (and chip_smoke.py, which may not import
zstd_tpu) can be checked on literal and table modes that path never emits:

  - zstd_tpu.compress of big_corpus(192 KiB) at levels 3 and 19 (1-stream
    and treeless literals, FSE and repeat table modes), with checksums;
  - tests/framegen.gen_frame(400 ... 411): synthesized valid frames (RLE
    sequence tables, predefined tables, raw/RLE block mixes);
  - the multi-frame blob with a skippable frame of
    tests/test_device_decoder.py::test_device_decode_multiframe_and_skippable;
  - the zero-run-plus-random frame of
    tests/test_device_decoder.py::test_device_decode_rle_and_raw_blocks.

manifest.json maps each file to its decoded length and sha256. Run on the
CPU from the repository root (it imports zstd_tpu and JAX):

    JAX_PLATFORMS=cpu python3 tools/make_torch_decode_frames.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_decode")


def frames() -> dict[str, tuple[bytes, bytes]]:
    """name -> (blob, decoded content)."""
    import numpy as np

    import zstd_tpu
    from tests.bigcorpus import big_corpus
    from tests.conftest import gen_mixed, gen_text
    from tests.framegen import gen_frame

    out = {}
    data = big_corpus(192 * 1024)
    for level in (3, 19):
        out[f"corpus192k_l{level}.zst"] = (
            zstd_tpu.compress(data, level=level, checksum=True), data)
    for seed in range(400, 412):
        out[f"framegen_{seed}.zst"] = gen_frame(seed)
    data1 = gen_text(30_000, seed=1)
    data2 = gen_mixed(20_000, seed=2)
    skip = (0x184D2A50).to_bytes(4, "little") + (4).to_bytes(4, "little") \
        + b"abcd"
    out["multiframe_skippable.zst"] = (
        zstd_tpu.compress(data1, level=2) + skip +
        zstd_tpu.compress(data2, level=5), data1 + data2)
    rng = np.random.default_rng(0)
    data = b"\x00" * 50_000 + rng.integers(0, 256, 50_000,
                                           np.uint8).tobytes()
    out["rle_raw.zst"] = (zstd_tpu.compress(data, level=1, checksum=True),
                          data)
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  (pins JAX to the CPU)
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    total = 0
    for name, (blob, content) in sorted(frames().items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(blob)
        total += len(blob)
        manifest[name] = {"size": len(content),
                          "sha256": hashlib.sha256(content).hexdigest()}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} frames, {total} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
