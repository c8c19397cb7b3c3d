"""Decode inputs shared by tests/test_torch_decode.py and chip_smoke.py.

Imports neither JAX nor zstd_tpu, so chip_smoke.py may use it on the card.
"""

from __future__ import annotations

import numpy as np


def underrun_frame(frame: bytes) -> bytes:
    """The frame with its first literal stream's top 64 bytes zeroed and its
    sentinel moved to bit 0 of the last byte: the stream holds fewer bits
    and its first symbols decode to the longest code, so it under-runs."""
    from zstd_tpu_torch import device_decoder
    s = device_decoder._parse_frame(frame, 0, 31).lanes[0][0]
    end = frame.index(s) + len(s) - 1
    bad = bytearray(frame)
    bad[end - 64:end] = bytes(64)
    bad[end] = 1
    return bytes(bad)


def nested_data() -> bytes:
    """101 chunks of 256 bytes, each the previous one with one byte changed:
    its matches copy the previous chunk, so dependency chains run up to 100
    matches deep (7 doubling rounds and one more to see no change)."""
    rng = np.random.default_rng(5)
    chunk = bytearray(rng.integers(0, 256, 256, np.uint8).tobytes())
    out = bytearray(chunk)
    for c in range(100):
        chunk[(c * 37) % 256] ^= 0x5A
        out += chunk
    return bytes(out)
