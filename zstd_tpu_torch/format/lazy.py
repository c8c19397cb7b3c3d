"""Serial match helpers of the host long-distance matcher.

Copy of _ext_fwd and _off_base in zstd_tpu/format/lazy.py: the forward
extension of a verified candidate and the offset value of a match given the
repeat offsets (RFC 8878 "Repeat offsets").
"""

from __future__ import annotations

import numpy as np


def _ext_fwd(full: np.ndarray, a: int, b: int, limit: int) -> int:
    """Serial forward extension (only for cap-hitting winners)."""
    n = 0
    CHUNK = 512
    while n < limit:
        m = min(CHUNK, limit - n)
        x = full[a + n : a + n + m]
        y = full[b + n : b + n + m]
        neq = x != y
        if neq.any():
            return n + int(np.argmax(neq))
        n += m
    return limit


def _off_base(d: int, ll: int, reps: tuple) -> int:
    """Offset value encoding given current reps (spec 'Repeat offsets')."""
    r1, r2, r3 = reps
    if ll != 0:
        if d == r1:
            return 1
        if d == r2:
            return 2
        if d == r3:
            return 3
    else:
        if d == r2:
            return 1
        if d == r3:
            return 2
        if d == r1 - 1 and d > 0:
            return 3
    return d + 3
