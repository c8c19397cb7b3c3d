"""The port's host code on its plain versions: while `plain_branches()` is
open, every function of zstd_tpu_torch that calls the port's host C for the
entropy coders, the block decoder, the decode's sequence parse or XXH64
runs its Python branch instead (its `*_plain` counterpart), in every module
that holds a reference to it. The whole-frame C encoders of
csrc/host/cblock.c, the device encode's batch planner (csrc/host/plan.c)
and the C parsers are not swapped: they have no Python branch in the port.

Shared by tests/test_torch_host_c.py and chip_smoke.py, which time and
compare the two branches in one process. Imports neither JAX nor zstd_tpu.
"""

from __future__ import annotations

import contextlib


def _swaps():
    from zstd_tpu_torch import device_decoder, pipeline, xxhash64
    from zstd_tpu_torch.format import codec, frame, fse, huffman, sequences
    out = [(device_decoder, "_parse_frame", device_decoder._parse_frame_plain),
           (frame, "_split_points", frame._split_points_plain)]
    for mod in (frame, codec, device_decoder):
        out.append((mod, "decompress_frame", frame.decompress_frame_plain))
    for mod in (xxhash64, frame, pipeline, device_decoder):
        out.append((mod, "content_checksum", xxhash64.content_checksum_plain))
    for mod, names in ((fse, ("normalize_count", "write_ncount",
                              "build_ctable", "fse_compress_2state")),
                       (huffman, ("build_huf_ctable_with_tree",
                                  "huf_encode_1x", "huf_encode_4x")),
                       (sequences, ("encode_sequences",))):
        out += [(mod, name, getattr(mod, name + "_plain")) for name in names]
    return out


@contextlib.contextmanager
def plain_branches():
    swaps = _swaps()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
