"""Forward little-endian bit writer for backward-read zstd streams.

Copy of BitWriter in zstd_tpu/format/bitstream.py. The writer appends
(value, nbBits) fields; after the last field it appends a 1-bit sentinel and
zero-pads to a byte boundary (RFC 8878 "Huffman-Coded Streams"). Its
arbitrary-precision accumulator is bit-for-bit equivalent to zstd's 64-bit
accumulator + flush scheme (lib/common/bitstream.h:67-105).
"""

from __future__ import annotations


class BitWriter:
    """Forward bit writer producing a backward-readable stream."""

    __slots__ = ("acc", "nbits")

    def __init__(self) -> None:
        self.acc = 0
        self.nbits = 0

    def add(self, value: int, nbits: int) -> None:
        """Append `nbits` low bits of `value` (BIT_addBits semantics: masked)."""
        if nbits:
            self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
            self.nbits += nbits

    def close(self) -> bytes:
        """Append the 1-bit sentinel, pad to byte boundary, return the bytes."""
        self.acc |= 1 << self.nbits
        self.nbits += 1
        nbytes = (self.nbits + 7) // 8
        return self.acc.to_bytes(nbytes, "little")
