"""XXH64 content checksum (frame checksum = low 32 bits of XXH64, seed 0).

Copy of zstd_tpu/xxhash64.py: xxh64, content_checksum and the streaming
Xxh64 call the port's copy of native/xxh64.c (csrc/host/xxh64.c, through
native.xxh64 and native.xxh64_reset / _update / _digest) as zstd_tpu's do;
the pure-Python branches are their plain versions (_xxh64_py,
content_checksum_plain, Xxh64(plain=True)). Bit-exact with zstd's vendored
lib/common/xxhash.h.
"""

from __future__ import annotations

from . import native

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M = (1 << 64) - 1


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    return (_rotl(acc, 31) * _P1) & _M


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M


def _xxh64_py(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        limit = n - 32
        while p <= limit:
            v1 = _round(v1, int.from_bytes(data[p:p + 8], "little")); p += 8
            v2 = _round(v2, int.from_bytes(data[p:p + 8], "little")); p += 8
            v3 = _round(v3, int.from_bytes(data[p:p + 8], "little")); p += 8
            v4 = _round(v4, int.from_bytes(data[p:p + 8], "little")); p += 8
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + _P5) & _M

    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        p += 1

    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def content_checksum(data: bytes) -> int:
    """Frame Content_Checksum: low 32 bits of XXH64(data, 0)."""
    return native.xxh64(data, 0) & 0xFFFFFFFF


def content_checksum_plain(data: bytes) -> int:
    """content_checksum through the pure-Python branch."""
    return _xxh64_py(bytes(data), 0) & 0xFFFFFFFF


class Xxh64:
    """Incremental XXH64 (reset/update/digest), O(1) memory.

    Parity: XXH64_reset/update/digest, the streaming API zstd's decoder
    runs per block (lib/decompress/zstd_decompress.c:1032). The state is
    the C one; plain=True keeps the Python state instead (v1..v4 plus a
    tail of under 32 bytes), the plain version.
    """

    def __init__(self, seed: int = 0, plain: bool = False):
        self._seed = seed
        self._plain = plain
        if not plain:
            self._state = native.xxh64_state()
        self.reset(seed)

    def reset(self, seed: int | None = None) -> None:
        if seed is not None:
            self._seed = seed
        s = self._seed
        if not self._plain:
            native.xxh64_reset(self._state, s)
            return
        self._v1 = (s + _P1 + _P2) & _M
        self._v2 = (s + _P2) & _M
        self._v3 = s & _M
        self._v4 = (s - _P1) & _M
        self._tail = b""
        self._total = 0

    def update(self, data: bytes | bytearray | memoryview) -> None:
        data = bytes(data)
        if not self._plain:
            native.xxh64_update(self._state, data)
            return
        self._total += len(data)
        buf = self._tail + data
        p = 0
        limit = len(buf) - 32
        v1, v2, v3, v4 = self._v1, self._v2, self._v3, self._v4
        while p <= limit:
            v1 = _round(v1, int.from_bytes(buf[p:p + 8], "little")); p += 8
            v2 = _round(v2, int.from_bytes(buf[p:p + 8], "little")); p += 8
            v3 = _round(v3, int.from_bytes(buf[p:p + 8], "little")); p += 8
            v4 = _round(v4, int.from_bytes(buf[p:p + 8], "little")); p += 8
        self._v1, self._v2, self._v3, self._v4 = v1, v2, v3, v4
        self._tail = buf[p:]

    def digest(self) -> int:
        if not self._plain:
            return native.xxh64_digest(self._state)
        n = self._total
        tail = self._tail
        if n >= 32:
            h = (_rotl(self._v1, 1) + _rotl(self._v2, 7)
                 + _rotl(self._v3, 12) + _rotl(self._v4, 18)) & _M
            h = _merge(h, self._v1)
            h = _merge(h, self._v2)
            h = _merge(h, self._v3)
            h = _merge(h, self._v4)
        else:
            h = (self._seed + _P5) & _M
        h = (h + n) & _M
        p = 0
        while p + 8 <= len(tail):
            h ^= _round(0, int.from_bytes(tail[p:p + 8], "little"))
            h = (_rotl(h, 27) * _P1 + _P4) & _M
            p += 8
        if p + 4 <= len(tail):
            h ^= (int.from_bytes(tail[p:p + 4], "little") * _P1) & _M
            h = (_rotl(h, 23) * _P2 + _P3) & _M
            p += 4
        while p < len(tail):
            h ^= (tail[p] * _P5) & _M
            h = (_rotl(h, 11) * _P1) & _M
            p += 1
        h ^= h >> 33
        h = (h * _P2) & _M
        h ^= h >> 29
        h = (h * _P3) & _M
        h ^= h >> 32
        return h


def xxh64(data: bytes | bytearray | memoryview, seed: int = 0) -> int:
    return native.xxh64(bytes(data), seed)
