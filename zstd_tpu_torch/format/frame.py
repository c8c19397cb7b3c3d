"""Frame header serialization.

Copy of write_frame_header in zstd_tpu/format/frame.py (zstd's
lib/compress/zstd_compress.c ZSTD_writeFrameHeader:4626).
"""

from __future__ import annotations

from ..constants import ZSTD_MAGIC


def write_frame_header(src_size: int, window_log: int, checksum: bool,
                       content_size_flag: bool = True, dict_id: int = 0,
                       window_must_cover: int | None = None) -> bytes:
    """ZSTD_writeFrameHeader. src_size is the pledged content size (>= 0).

    window_must_cover: minimum window the DECODER must end up with (e.g.
    prefix + content for --patch-from frames). Single-segment mode sets
    the decoder's window to the content size, which would strand matches
    reaching into the prefix — so it is only taken when the content size
    alone covers the requirement."""
    window_size = 1 << window_log
    need = max(src_size, window_must_cover or 0)
    single_segment = (content_size_flag and window_size >= src_size
                      and src_size >= need)
    if content_size_flag:
        fcs_code = (src_size >= 256) + (src_size >= 65536 + 256) + (src_size > 0xFFFFFFFF)
    else:
        fcs_code = 0
    if dict_id == 0:
        did_code = 0
    elif dict_id < 256:
        did_code = 1
    elif dict_id < 65536:
        did_code = 2
    else:
        did_code = 3
    fhd = did_code + (int(checksum) << 2) + (int(single_segment) << 5) + (fcs_code << 6)
    out = bytearray(ZSTD_MAGIC.to_bytes(4, "little"))
    out.append(fhd)
    if not single_segment:
        out.append((window_log - 10) << 3)  # exponent only; mantissa 0
    if did_code == 1:
        out += dict_id.to_bytes(1, "little")
    elif did_code == 2:
        out += dict_id.to_bytes(2, "little")
    elif did_code == 3:
        out += dict_id.to_bytes(4, "little")
    if fcs_code == 0:
        if single_segment:
            out.append(src_size)
    elif fcs_code == 1:
        out += (src_size - 256).to_bytes(2, "little")
    elif fcs_code == 2:
        out += src_size.to_bytes(4, "little")
    else:
        out += src_size.to_bytes(8, "little")
    return bytes(out)
