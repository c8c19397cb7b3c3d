"""The plain reference that judges the frames, held to the port's host
decoder on the port's host-codec frames."""

from __future__ import annotations

import pytest

import corpus
import refdecode
import zstd_tpu_torch

DATA = corpus.big_corpus(400 * 1024, seed=11)   # inside every level's window


@pytest.mark.parametrize("level", [1, 3, 5, -1, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_reference_equals_the_host_decoder(level, checksum):
    frame = zstd_tpu_torch.compress(DATA, level=level, checksum=checksum)
    assert refdecode.decode(frame) == zstd_tpu_torch.decompress(frame) \
        == DATA


@pytest.mark.parametrize("data", [b"", b"a", b"ab" * 40, bytes(300000),
                                  bytes(range(256)) * 700])
def test_small_and_uniform_inputs(data):
    frame = zstd_tpu_torch.compress(data, level=1)
    assert refdecode.decode(frame) == data


def test_many_frames_decode_together():
    parts = [DATA[i:i + 100000] for i in range(0, len(DATA), 100000)]
    frames = [zstd_tpu_torch.compress(p, level=lv)
              for p, lv in zip(parts, (1, 3, 5, 9, 1))]
    assert refdecode.decode_each(frames) == parts
    skip = b"\x50\x2a\x4d\x18" + (3).to_bytes(4, "little") + b"xyz"
    assert refdecode.decode(frames[0] + skip + frames[1]) == parts[0] \
        + parts[1]
    with pytest.raises(refdecode.FormatError):
        refdecode.decode_each([frames[0] + frames[1]])


@pytest.mark.parametrize("at", [0.2, 0.5, 0.8, 0.97])
def test_a_flipped_byte_fails(at):
    frame = bytearray(zstd_tpu_torch.compress(DATA, level=3))
    frame[int(len(frame) * at)] ^= 0x20
    try:
        out = refdecode.decode(bytes(frame))
    except Exception:          # refused: the judge counts the call wrong
        return
    assert out != DATA


def test_truncated_frame_fails():
    frame = zstd_tpu_torch.compress(DATA, level=1)
    with pytest.raises(refdecode.FormatError):
        refdecode.decode(frame[:-100])


def test_host_codec_writes_offsets_beyond_its_window():
    """A fault of the program, pinned: at 1 MiB of the seeded corpus the
    host codec's level-1 frame declares a 512 KiB window and holds a longer
    offset. The port's device decoder refuses it, as the reference does;
    its host decoder takes it."""
    from zstd_tpu_torch import device_decoder
    from zstd_tpu_torch.errors import Corruption
    data = corpus.big_corpus(16 << 20, seed=5)[:1 << 20]
    frame = zstd_tpu_torch.compress(data, level=1)
    assert refdecode._frame_header(frame, 0)[1] == 1 << 19
    assert zstd_tpu_torch.decompress(frame) == data
    with pytest.raises(refdecode.FormatError, match="window"):
        refdecode.decode(frame)
    with pytest.raises(Corruption, match="beyond window"):
        device_decoder._parse_jobs(frame, 31)
