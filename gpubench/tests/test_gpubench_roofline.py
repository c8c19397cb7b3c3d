"""The byte counts of the rooflines, on a hand-made frame and on real
frames."""

from __future__ import annotations

import pytest

import corpus
import refdecode
import roofline
import zstd_tpu_torch


def handmade() -> bytes:
    """A frame of four blocks: raw (5 B), RLE (1,000 B), compressed with
    raw literals (12 of them) and 300 sequences (the 2-byte count), and a
    last compressed block with RLE literals (20) and no sequences. Only
    the headers are well formed: the counts read nothing else."""
    fhd = 0x00                         # no content size, window descriptor
    out = bytearray((0xFD2FB528).to_bytes(4, "little") + bytes([fhd, 0x00]))

    def block(btype, size, body, last=False):
        out.extend((int(last) | (btype << 1) | (size << 3)).to_bytes(3,
                                                                    "little"))
        out.extend(body)
    block(0, 5, b"abcde")
    block(1, 1000, b"z")
    lits = bytes([12 << 3]) + b"L" * 12                  # raw, 1-byte header
    seqs = bytes([128 + (300 >> 8), 300 & 0xFF, 0x00]) + b"\x99" * 20
    block(2, len(lits) + len(seqs), lits + seqs)
    lits = bytes([1 | (20 << 3)]) + b"q"                 # RLE, 1-byte header
    block(2, len(lits) + 1, lits + b"\x00", last=True)
    return bytes(out)


def test_blocks_of_a_handmade_frame():
    assert roofline.blocks(handmade()) == [
        (0, 5, 0, 0), (1, 1000, 0, 0), (2, 13 + 23, 12, 300), (2, 3, 20, 0)]


def test_byte_counts_of_a_handmade_frame():
    f = handmade()
    handed = 12 * 300 + 12 + 20
    assert roofline.handed_on([f]) == handed
    assert roofline.stage_a_bytes([f], 1097) == 1097 + handed
    assert roofline.stage_b_bytes([f]) == handed + 36 + 3
    # payloads at their sizes in the frame: 5 raw, 1 for the RLE block's
    # 1,000, 36 and 3 compressed; then the content, here 2,000 bytes
    assert roofline.decode_bytes([f], 2000) == 5 + 1 + 36 + 3 + handed + 2000
    assert roofline.decode_bytes([f, f], 4000) == \
        2 * (5 + 1 + 36 + 3 + handed) + 4000


@pytest.mark.parametrize("level", [1, 5])
def test_counts_agree_with_the_reference_parse(level):
    data = corpus.big_corpus(300 * 1024, seed=4)
    frame = zstd_tpu_torch.compress(data, level=level, checksum=True)
    tables, streams, seqs = [], [], []
    parsed = refdecode._parse_frame(frame, 0, tables, streams, seqs)
    nb = [s[2] for s in seqs]
    got = [b for b in roofline.blocks(frame) if b[0] == 2]
    assert sum(b[3] for b in got) == sum(nb)
    assert sum(b[2] for b in got) == sum(step[3] for step in parsed["plan"]
                                         if step[0] == "seq")


def test_share_needs_a_time_and_a_peak():
    assert roofline.share_pct(3.35e9, 1.0, "NVIDIA H100 80GB HBM3") \
        == pytest.approx(0.1)
    assert roofline.share_pct(10, 0.0, "NVIDIA H100 80GB HBM3") is None
    assert roofline.share_pct(10, 1.0, "cpu") is None
