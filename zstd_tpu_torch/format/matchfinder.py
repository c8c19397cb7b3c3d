"""Repeat-offset rules shared by the sequence decoders.

Copy of update_reps and resolve_offset in zstd_tpu/format/matchfinder.py
(RFC 8878 "Repeat offsets" and "Offset updates rules").
"""

from __future__ import annotations


def update_reps(reps: tuple[int, int, int], off_base: int, ll: int
                ) -> tuple[int, int, int]:
    """Repeat-offset update rule (spec 'Offset updates rules'); shared by
    encoder and decoder so both sides stay in lockstep."""
    r1, r2, r3 = reps
    if off_base > 3:
        return off_base - 3, r1, r2
    idx = off_base + (1 if ll == 0 else 0)
    if idx == 1:
        return r1, r2, r3
    if idx == 2:
        return r2, r1, r3
    if idx == 3:
        return r3, r1, r2
    # idx == 4: offBase 3 with ll == 0 -> rep1 - 1
    return r1 - 1, r1, r2


def resolve_offset(reps: tuple[int, int, int], off_base: int, ll: int) -> int:
    """Decoder-side offset resolution (spec 'Repeat offsets')."""
    if off_base > 3:
        return off_base - 3
    idx = off_base + (1 if ll == 0 else 0)
    if idx == 1:
        return reps[0]
    if idx == 2:
        return reps[1]
    if idx == 3:
        return reps[2]
    return reps[0] - 1
