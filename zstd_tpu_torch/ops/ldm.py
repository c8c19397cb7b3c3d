"""Device steps of the sharded long-distance matcher (parallel/ldm_sharded).

Counterpart of the per-shard arithmetic of zstd_tpu/parallel/ldm_sharded.py
`_discover`:

- `anchor_keys`: the gear fingerprint of every position of a chunk (four
  strided 8-byte words times PRIME64, the top 32 bits), the anchor
  predicate and the bucket key; on a card one launch of
  csrc/ldm_fingerprint.cu, on the CPU `anchor_keys_plain`, whose
  `fingerprint_plain` is the JAX module's 16-bit limb arithmetic in int64;
- `lookback`: from an owner's entries sorted by (key, pos) to each
  anchor's LDM_BUCKET candidates, 12 entries back; on a card one launch of
  csrc/ldm_lookback.cu, on the CPU `lookback_plain`, the JAX loop.

Torch on the CPU has no uint32 shifts, so u32 values live in int64 here.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..format.ldm import _PRIME64, LDM_BUCKET

SPAN = 64              # fingerprint window (matches format/ldm.py)
HASH_LOG = 20
RATE_LOG = 7
LOOKBACK = 12          # sorted-neighbor scan depth for candidate recovery
SENT_KEY = 1 << HASH_LOG   # an empty slot's key in the owner's sort: last
_SENT_ENTRY = (SENT_KEY << 32) | 0x7FFFFFFF
_INT32_MAX = (1 << 31) - 1
_SLICE = 1 << 18
_P16 = [(int(_PRIME64) >> (16 * j)) & 0xFFFF for j in range(4)]


def _mulp_hi32(vlo: torch.Tensor, vhi: torch.Tensor) -> torch.Tensor:
    """High 32 bits of (v * PRIME64) mod 2^64, for v given as two u32 words
    (int64 tensors): the JAX module's 16-bit-limb long multiplication. Every
    product is below 2^32 and every column sum below 2^20."""
    a = [vlo & 0xFFFF, vlo >> 16, vhi & 0xFFFF, vhi >> 16]
    cols = [None, None, None, None]
    for i in range(4):
        for j in range(4 - i):
            prod = a[i] * _P16[j]
            c = i + j
            lo = prod & 0xFFFF
            cols[c] = lo if cols[c] is None else cols[c] + lo
            if c + 1 < 4:
                hi = prod >> 16
                cols[c + 1] = hi if cols[c + 1] is None else cols[c + 1] + hi
    r0 = cols[0]
    r1 = cols[1] + (r0 >> 16)
    r2 = cols[2] + (r1 >> 16)
    r3 = cols[3] + (r2 >> 16)
    return (r2 & 0xFFFF) | ((r3 & 0xFFFF) << 16)


def _pack32(ext: torch.Tensor, start: int, n_pos: int) -> torch.Tensor:
    """u32 LE word at ext[p+start .. p+start+4) for p in [0, n_pos)."""
    w = ext[start:start + n_pos].long()
    for k in range(1, 4):
        w = w | (ext[start + k:start + k + n_pos].long() << (8 * k))
    return w


def fingerprint_plain(ext: torch.Tensor, m: int) -> torch.Tensor:
    """int64[m]: the top 32 bits of format/ldm.py's fingerprint of each of
    the first m positions of ext u8[>= m + SPAN - 8], in slices of _SLICE
    positions (the limbs' temporaries, 8 bytes a position each, then stay
    in the host's caches)."""
    out = torch.empty(m, dtype=torch.int64, device=ext.device)
    for a in range(0, m, _SLICE):
        n = min(_SLICE, m - a)
        words = _pack32(ext, a, n + 52)      # the u32 word at every offset
        h = None
        for off, sh in ((0, 0), (16, 3), (32, 7), (48, 13)):
            w = _mulp_hi32(words[off:off + n], words[off + 4:off + 4 + n]) >> sh
            h = w if h is None else h ^ w
        out[a:a + n] = h
    return out


def anchor_keys_plain(ext: torch.Tensor, valid: int):
    """(flag u8[m], key int32[m]) of ext u8[m + SPAN]: flag 1 where position
    p < valid is an anchor (the fingerprint's top RATE_LOG bits are 0), key
    the HASH_LOG bits below them."""
    m = ext.numel() - SPAN
    h = fingerprint_plain(ext, m)
    p = torch.arange(m, device=ext.device)
    flag = ((h >> (32 - RATE_LOG)) == 0) & (p < valid)
    key = (h >> (32 - RATE_LOG - HASH_LOG)) & ((1 << HASH_LOG) - 1)
    return flag.to(torch.uint8), key.to(torch.int32)


def _check(name: str, t, dtype, dev) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != 1 \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor "
                         f"on {dev}")


def anchor_keys(ext: torch.Tensor, valid: int):
    """`anchor_keys_plain` of ext u8[m + SPAN]. CPU tensors take the plain
    version; CUDA tensors launch csrc/ldm_fingerprint.cu or raise."""
    if ext.device.type == "cpu":
        return anchor_keys_plain(ext, valid)
    dev = ext.device
    if dev.type != "cuda":
        raise ValueError(f"anchor_keys: unsupported device {dev}")
    _check("anchor_keys: ext", ext, torch.uint8, dev)
    m = ext.numel() - SPAN
    if m < 0 or not 0 <= valid <= m:
        raise ValueError(f"anchor_keys: {ext.numel()} bytes hold no "
                         f"{valid} positions and their {SPAN}-byte window")
    if ext.data_ptr() % 4:
        raise ValueError("anchor_keys: ext must be 4-byte aligned")
    flag = torch.empty(m, dtype=torch.uint8, device=dev)
    key = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return flag, key
    lib = _kernels.get("ldm_fingerprint.cu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldm_fingerprint_launch(ext.data_ptr(), m, valid,
                                         flag.data_ptr(), key.data_ptr(),
                                         ctypes.c_void_p(stream))
    _kernels.check(err, "ldm_fingerprint_launch")
    _kernels.LAUNCHES["ldm_fingerprint"] += 1
    return flag, key


def owner_entries(key: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 sort keys of an owner's received entries, (key << 32) | pos for
    a real one (pos >= 0), the sentinel (SENT_KEY << 32) | 0x7FFFFFFF for an
    empty slot (pos -1): ascending order is the JAX module's two-key sort
    of (key u32, pos with -1 as 0x7FFFFFFF)."""
    real = (key.long() << 32) | pos.long()
    return torch.where(pos >= 0, real, torch.full_like(real, _SENT_ENTRY))


def lookback_plain(entries: torch.Tensor, block_size: int, window: int):
    """(pos_out int32[n_e], cand int32[n_e, LDM_BUCKET]) of an owner's sorted
    entries int64[n_e] (`owner_entries`, sorted): for each real entry the
    positions of the first LDM_BUCKET of the LOOKBACK entries before it that
    have its key, lie before its block (multiples of block_size) and within
    `window` bytes, nearest first (-1 = none); pos_out is the entry's
    position, -1 for the sentinel."""
    key = entries >> 32
    pos = entries & 0xFFFFFFFF
    real = key != SENT_KEY
    cutoff = (pos // block_size) * block_size
    n_e = entries.numel()
    ranks = torch.zeros(n_e, dtype=torch.int64, device=entries.device)
    slot = torch.full((LDM_BUCKET, n_e), -1, dtype=torch.int64,
                      device=entries.device)
    for k in range(1, LOOKBACK + 1):
        kk = torch.cat([torch.full((min(k, n_e),), SENT_KEY,
                                   dtype=torch.int64, device=entries.device),
                        key[:-k]])
        pk = torch.cat([torch.full((min(k, n_e),), -1, dtype=torch.int64,
                                   device=entries.device), pos[:-k]])
        ok = (kk == key) & real & (pk >= 0) & (pk < cutoff) \
            & (pos - pk <= window)
        for b in range(LDM_BUCKET):
            slot[b] = torch.where(ok & (ranks == b), pk, slot[b])
        ranks = ranks + ok.long()
    pos_out = torch.where(real, pos, -1)
    return pos_out.to(torch.int32), slot.T.contiguous().to(torch.int32)


def lookback(entries: torch.Tensor, block_size: int, window: int):
    """`lookback_plain` of entries int64[n_e]. CPU tensors take the plain
    version; CUDA tensors launch csrc/ldm_lookback.cu or raise."""
    if entries.device.type == "cpu":
        return lookback_plain(entries, block_size, window)
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"lookback: unsupported device {dev}")
    _check("lookback: entries", entries, torch.int64, dev)
    if not 0 < block_size <= _INT32_MAX:
        raise ValueError(f"lookback: block_size {block_size}")
    n_e = entries.numel()
    pos_out = torch.empty(n_e, dtype=torch.int32, device=dev)
    cand = torch.empty((n_e, LDM_BUCKET), dtype=torch.int32, device=dev)
    if n_e == 0:
        return pos_out, cand
    lib = _kernels.get("ldm_lookback.cu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldm_lookback_launch(entries.data_ptr(), n_e, block_size,
                                      min(window, _INT32_MAX),
                                      pos_out.data_ptr(), cand.data_ptr(),
                                      ctypes.c_void_p(stream))
    _kernels.check(err, "ldm_lookback_launch")
    _kernels.LAUNCHES["ldm_lookback"] += 1
    return pos_out, cand
