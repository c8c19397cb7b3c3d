"""The controls and the planted faults that the judge has to catch.

Each is a wrapper for the timed call of a cell (harness.main's `wrap`),
which takes the call's input (a raw input to compress, a frame to
decompress) and returns its answer (a frame, or the decoded bytes). The
benchmark's own runs use none of them; gpubench/tests drive them. Each
operation names its control (ops/<op>.py, `control`).

control: the compress cells' control, the configuration's guarantee broken
    in the least visible way: a valid frame of the input with one byte
    changed (same size, same ratio).
unchanged: the call returns its input as it came.
half: half of the work left out: the answer to the input's first half (a
    decode refuses half a frame, so the call fails).
altered: one byte of the answer changed where it is produced. It is the
    decode cells' control: the decoded bytes with one byte changed, the
    same size, which only a comparison with the raw input sees.
"""

from __future__ import annotations


def _flip(data: bytes, at: int) -> bytes:
    b = bytearray(data)
    b[at] ^= 0x5A
    return bytes(b)


def control(call):
    return lambda data: call(_flip(data, len(data) // 3))


def unchanged(call):
    return lambda data: bytes(data)


def half(call):
    return lambda data: call(data[:len(data) // 2])


def altered(call):
    return lambda data: (lambda out: _flip(out, len(out) // 2))(call(data))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
