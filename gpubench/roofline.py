"""The table of peaks and the byte counts of the rooflines.

Each count is what a stage must move at the least, counted from the
benchmark's own inputs and from the frames' headers, so that it is the same
whatever implements the stage: every input byte read once, every output
byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet: 80 GB of HBM3 at 3.35 TB/s (700 W)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}
# a sequence handed from stage A to stage B: literal length, match length
# and offset, 4 bytes each
SEQ_BYTES = 12


def peak_bytes_per_s(kind: str) -> float | None:
    """The device memory rate of a card by its name, None for a card not in
    the table (its rooflines are then not read)."""
    entry = PEAKS.get(kind)
    return entry["hbm_bytes_per_s"] if entry else None


def _header_end(frame: bytes, pos: int) -> tuple[int, bool]:
    """(position after the frame header, checksum flag)."""
    fhd = frame[pos + 4]
    single = bool(fhd & 0x20)
    p = pos + 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
    p += (1 if single else 0, 2, 4, 8)[fhd >> 6]
    return p, bool(fhd & 0x04)


def _literals(frame: bytes, p: int) -> tuple[int, int]:
    """(regenerated size, bytes of the literal section) at p."""
    b0 = frame[p]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        lh = (1, 2, 1, 3)[fmt]
        h = int.from_bytes(frame[p:p + lh], "little")
        regen = h >> (3 if lh == 1 else 4)
        return regen, lh + (regen if kind == 0 else 1)
    lh = (3, 3, 4, 5)[fmt]
    h = int.from_bytes(frame[p:p + lh], "little")
    bits = (10, 10, 14, 18)[fmt]
    regen = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    return regen, lh + csize


def _nb_seq(frame: bytes, p: int) -> int:
    b0 = frame[p]
    if b0 < 128:
        return b0
    if b0 < 255:
        return ((b0 - 128) << 8) + frame[p + 1]
    return frame[p + 1] + (frame[p + 2] << 8) + 0x7F00


def blocks(frame: bytes) -> list:
    """(type, size, literals, sequences) of every block of every frame in
    `frame`; literals and sequences are 0 outside compressed blocks."""
    out = []
    pos = 0
    while pos < len(frame):
        p, checksum = _header_end(frame, pos)
        last = False
        while not last:
            bh = int.from_bytes(frame[p:p + 3], "little")
            last, btype, bsize = bool(bh & 1), (bh >> 1) & 3, bh >> 3
            p += 3
            if btype == 2:
                regen, used = _literals(frame, p)
                out.append((btype, bsize, regen, _nb_seq(frame, p + used)))
            else:
                out.append((btype, bsize, 0, 0))
            p += 1 if btype == 1 else bsize
        pos = p + (4 if checksum else 0)
    return out


def handed_on(frames) -> int:
    """The sequences and literals of the frames' compressed blocks."""
    return sum(SEQ_BYTES * nseq + lits
               for f in frames for t, _, lits, nseq in blocks(f) if t == 2)


def stage_a_bytes(frames, input_bytes: int) -> int:
    """Stage A: the blocks read once, the sequences and literals that it
    hands on written once."""
    return input_bytes + handed_on(frames)


def stage_b_bytes(frames) -> int:
    """Stage B: the sequences and literals read once, the compressed blocks'
    payloads written once at their sizes in the frame."""
    return handed_on(frames) + sum(size for f in frames
                                   for t, size, _, _ in blocks(f) if t == 2)


def decode_bytes(frames, content_bytes: int) -> int:
    """The decode: every block's payload read once at its size in the frame
    (an RLE block's one byte), the sequences and literals handed from the
    literal decode to the sequence executor once, and the decoded content
    written once."""
    return sum(1 if t == 1 else size for f in frames
               for t, size, _, _ in blocks(f)) \
        + handed_on(frames) + content_bytes


def share_pct(nbytes: int, seconds: float, kind: str) -> float | None:
    """The least time to move nbytes at the card's peak, as a share of
    `seconds` in %; None where there is no time or no peak for the card."""
    peak = peak_bytes_per_s(kind)
    if not seconds or peak is None or not nbytes:
        return None
    return 100.0 * nbytes / peak / seconds
