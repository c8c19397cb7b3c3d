"""Device 4-stream Huffman literal encoding, batched over blocks.

Counterpart of huf_pack_4x_block in zstd_tpu/ops/huffman_enc.py (zstd's
lib/compress/huf_compress.c HUF_compress4X_usingCTable:1168): each of the 4
streams of a block encodes its symbols last-to-first through a 256-entry
(nbits, value) table, then a (1, 1) sentinel; ops.bitpack packs the fields.
In single-stream mode everything goes to stream 0 and streams 1-3 hold only
their sentinel.
"""

from __future__ import annotations

import torch

from .bitpack import pack_bits


def huf_pack_4x(lits: torch.Tensor, nb_lit: torch.Tensor,
                nb_lut: torch.Tensor, val_lut: torch.Tensor,
                single: torch.Tensor, seg_cap: int, out_words: int):
    """lits u8[B, L], nb_lit i32[B], LUTs i32[B, 256], single bool[B].
    Returns (words int64[B, 4, out_words], total_bits int32[B, 4])."""
    B, L = lits.shape
    dev = lits.device
    nb = nb_lit.to(torch.int64)[:, None]                   # [B, 1]
    seg4 = (nb + 3) // 4
    s = torch.arange(4, device=dev)[None, :]               # [1, 4]
    sgl = single[:, None]
    start = torch.where(sgl, 0, s * seg4)
    len4 = torch.where(s < 3, seg4, nb - 3 * seg4)
    seg_len = torch.where(sgl, torch.where(s == 0, nb, 0), len4)   # [B, 4]
    j = torch.arange(seg_cap + 1, device=dev)
    byte_idx = start[:, :, None] + seg_len[:, :, None] - 1 - j     # [B, 4, S]
    in_seg = j < seg_len[:, :, None]
    byte = lits.long().gather(1, byte_idx.clamp(0, L - 1).reshape(B, -1))
    values = torch.where(in_seg.reshape(B, -1), val_lut.gather(1, byte), 0)
    nbits = torch.where(in_seg.reshape(B, -1), nb_lut.gather(1, byte), 0)
    sentinel = (j == seg_len[:, :, None]).reshape(B, -1)
    values = torch.where(sentinel, 1, values).to(torch.int32)
    nbits = torch.where(sentinel, 1, nbits).to(torch.int32)
    words, bits = pack_bits(values.reshape(B * 4, -1), nbits.reshape(B * 4, -1),
                            out_words)
    return words.reshape(B, 4, out_words), bits.reshape(B, 4)
