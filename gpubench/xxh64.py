"""The plain XXH64 that judges a frame's content checksum.

XXH64 (Yann Collet's xxHash, 64-bit), written for the benchmark from its
specification, in plain Python; it imports nothing of the program under
test. A Zstandard frame's content checksum is the low 32 bits of
XXH64(content, seed 0), stored little-endian as the frame's last 4 bytes.
"""

from __future__ import annotations

import struct

M64 = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & M64
    return (_rotl(acc, 31) * P1) & M64


def _merge(h: int, acc: int) -> int:
    return ((h ^ _round(0, acc)) * P1 + P4) & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data)
        v1 = (seed + P1 + P2) & M64
        v2 = (seed + P2) & M64
        v3 = seed & M64
        v4 = (seed - P1) & M64
        for j in range(0, 4 * stripes, 4):
            v1 = (v1 + lanes[j] * P2) & M64
            v1 = (((v1 << 31) | (v1 >> 33)) & M64) * P1 & M64
            v2 = (v2 + lanes[j + 1] * P2) & M64
            v2 = (((v2 << 31) | (v2 >> 33)) & M64) * P1 & M64
            v3 = (v3 + lanes[j + 2] * P2) & M64
            v3 = (((v3 << 31) | (v3 >> 33)) & M64) * P1 & M64
            v4 = (v4 + lanes[j + 3] * P2) & M64
            v4 = (((v4 << 31) | (v4 >> 33)) & M64) * P1 & M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
        i = 32 * stripes
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, i)
        h = (_rotl(h ^ _round(0, k), 27) * P1 + P4) & M64
        i += 8
    if i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl(h ^ (k * P1 & M64), 23) * P2 + P3) & M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (data[i] * P5 & M64), 11) * P1) & M64
        i += 1
    h ^= h >> 33
    h = (h * P2) & M64
    h ^= h >> 29
    h = (h * P3) & M64
    return h ^ (h >> 32)


def content_checksum(data: bytes) -> bytes:
    """The 4 bytes that end a Zstandard frame of `data` with a checksum."""
    return (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
