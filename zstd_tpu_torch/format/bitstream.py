"""Backward little-endian bitstreams (RFC 8878 "Huffman-Coded Streams" /
"Decoding Sequences").

Copy of BitWriter, BitReader and ForwardBitReader in
zstd_tpu/format/bitstream.py. The writer appends (value, nbBits) fields;
after the last field it appends a 1-bit sentinel and zero-pads to a byte
boundary. Its arbitrary-precision accumulator is bit-for-bit equivalent to
zstd's 64-bit accumulator + flush scheme (lib/common/bitstream.h:67-105).
The backward reader starts at the final byte, strips the padding and the
sentinel, then consumes fields in reverse field order; the forward reader
parses FSE table descriptions. `pack_fields` writes the same bytes as a
BitWriter fed every field in order, in numpy: the encoders' streams are too
long for the writer's big-integer accumulator, whose cost grows with the
stream at every field.
"""

from __future__ import annotations

import numpy as np

from ..errors import Corruption


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


def pack_fields(values, nbits) -> bytes:
    """BitWriter.add(values[i], nbits[i]) for every i in order, then close():
    each field's low nbits[i] bits (at most 63), LSB first, then the 1-bit
    sentinel and zero padding to a byte boundary."""
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    ends = np.cumsum(nbits)
    total = int(ends[-1]) if len(ends) else 0
    starts = ends - nbits
    bits = np.zeros(total + 1, dtype=np.uint8)
    for j in range(int(nbits.max(initial=0))):
        sel = nbits > j
        bits[starts[sel] + j] = (values[sel] >> np.uint64(j)) & np.uint64(1)
    bits[total] = 1
    return np.packbits(bits, bitorder="little").tobytes()


class BitReader:
    """Backward bit reader (BIT_initDStream/BIT_readBits semantics)."""

    __slots__ = ("acc", "pos")

    def __init__(self, data: bytes) -> None:
        if len(data) == 0:
            raise Corruption("empty bitstream")
        last = data[-1]
        if last == 0:
            raise Corruption("bitstream last byte is 0 (no sentinel)")
        self.acc = int.from_bytes(data, "little")
        # strip the padding zeros and the sentinel 1-bit
        sentinel = last.bit_length() - 1  # index of highest set bit in last byte
        self.pos = 8 * (len(data) - 1) + sentinel  # number of useful bits

    def read(self, nbits: int) -> int:
        """Consume `nbits` bits moving backward; returns them as an LE value."""
        if nbits == 0:
            return 0
        self.pos -= nbits
        if self.pos < 0:
            raise Corruption("bitstream over-read")
        return (self.acc >> self.pos) & ((1 << nbits) - 1)

    def read_clamped(self, nbits: int) -> int:
        """Read allowing overflow past the start; missing bits are zero
        (the Huffman-weight FSE decode rule: "If updating state ... would
        require more bits than remain in the stream, it is assumed that
        extra bits are 0")."""
        if nbits == 0:
            return 0
        self.pos -= nbits
        if self.pos <= -nbits:
            return 0  # fully past the start: all-zero fill (value is discarded)
        if self.pos < 0:
            return (self.acc << (-self.pos)) & ((1 << nbits) - 1)
        return (self.acc >> self.pos) & ((1 << nbits) - 1)

    @property
    def overflowed(self) -> bool:
        return self.pos < 0


class ForwardBitReader:
    """Forward little-endian bit reader (used by FSE table descriptions)."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bitpos = 0

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        start_byte = self.bitpos >> 3
        end_byte = (self.bitpos + nbits + 7) >> 3
        if end_byte > len(self.data):
            # spec allows reading into padding of the last byte only
            chunk = self.data[start_byte:] + b"\x00" * (end_byte - len(self.data))
        else:
            chunk = self.data[start_byte:end_byte]
        v = int.from_bytes(chunk, "little")
        v >>= self.bitpos & 7
        self.bitpos += nbits
        return v & ((1 << nbits) - 1)

    def peek(self, nbits: int) -> int:
        save = self.bitpos
        v = self.read(nbits)
        self.bitpos = save
        return v

    def skip(self, nbits: int) -> None:
        self.bitpos += nbits

    @property
    def bytes_consumed(self) -> int:
        return (self.bitpos + 7) >> 3
