"""The bytes of the long-distance discovery's roofline
(metrics/ldm_roofline_pct.py): what the discovery of an n-byte input must
move at the least, whatever implements it.

The input is read once. Each anchor kept is one entry that the fingerprint
hands the look-back (in the sharded layout, the entry a rank sends the
anchor's owner): its 8-byte (key, position) written once and read once,
as one pass of 8 bytes, and its position (4 B) and 4 candidates (16 B)
written. What a design keeps for every position (the current kernels'
anchor flag and bucket key) or for every padded slot of the exchange is
its own cost, not the work's, and is left out.
"""

from __future__ import annotations

ENTRY_BYTES = 8 + 4 + 16


def discovery_bytes(n: int, anchors: float) -> float:
    """The least bytes the discovery of an n-byte input with `anchors`
    anchors kept moves."""
    return n + ENTRY_BYTES * anchors


def content_size(frame: bytes) -> int | None:
    """The content size a zstd frame's header declares, None where it
    declares none."""
    fhd = frame[4]
    single = bool(fhd & 0x20)
    p = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
    code = fhd >> 6
    if code == 0:
        return frame[p] if single else None
    size = int.from_bytes(frame[p:p + (2, 4, 8)[code - 1]], "little")
    return size + 256 if code == 1 else size
