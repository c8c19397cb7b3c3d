"""Serial greedy match commit ("resolve") that emits the full seqstore.

Counterpart of zstd_tpu/ops/resolve_pallas.py (the Pallas `_extract_kernel`
behind `extract_compact`). Per block row, at position ip with candidate
c = cand[ip]: take the match iff lcp(ip, c, vl - ip) >= 4 (while
ip < vl - 8 and fewer than `cap` sequences were written); extend it backward
while the previous bytes match (down to the previous match end and to
offset d); copy the literal run into a compacted row; write
(ll, off = d, ml) and jump to ip + l. Otherwise jump to
max(nxt[min(ip + 1, vl - 8)], ip + 1). The trailing literals from the last
anchor close the row.

Layout (the port's own; the public functions of seqextract keep the JAX
one): bytes u8[B, N], cands / nxt i32[B, N], valid_lens i32[B]. Outputs:
ll / off / ml i32[B, cap] (zero past nb_seq), lits u8[B, N] (zero past
nb_lit), nb_seq i32[B], nb_lit i32[B].

`extract_compact` launches csrc/extract.cu for CUDA tensors and runs
`extract_plain`, the same scan written once in Python, for CPU tensors.
The kernel cuts each row's chain into segments walked in parallel and
repaired where a segment's speculative start was wrong (the design is in
the source); tests/walkmodel.py models it in Python.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels

PAD = 256   # zero bytes past N that the kernel's 128-byte compares may read


def _lcp(buf: bytes, p: int, c: int, limit: int) -> int:
    """Common prefix length of buf[p:] and buf[c:], capped at limit."""
    l, step = 0, 16
    while l < limit:
        n = min(step, limit - l)
        if buf[p + l:p + l + n] == buf[c + l:c + l + n]:
            l += n
            step = min(step * 2, 4096)
            continue
        lo, hi = 0, n - 1          # first mismatch lies in [lo, hi]
        while lo < hi:
            mid = (lo + hi) // 2
            if buf[p + l:p + l + mid + 1] == buf[c + l:c + l + mid + 1]:
                lo = mid + 1
            else:
                hi = mid
        return l + lo
    return limit


def _extract_row(buf: bytes, cand: list, nxt: list, vl: int, cap: int):
    ll, off, ml = [], [], []
    lits = bytearray()
    ip = anchor = 0
    limit_pos = vl - 8
    while ip < limit_pos and len(ll) < cap:
        c = cand[ip]
        l = _lcp(buf, ip, c, vl - ip) if c >= 0 else 0
        if l >= 4:
            d = ip - c
            s = ip
            while s > anchor and s > d and buf[s - 1] == buf[s - 1 - d]:
                s -= 1
            lits += buf[anchor:s]
            ll.append(s - anchor)
            off.append(d)
            ml.append(l + ip - s)
            ip = anchor = ip + l
        else:
            ip = max(nxt[min(ip + 1, limit_pos)], ip + 1)
    lits += buf[anchor:max(vl, anchor)]
    return ll, off, ml, bytes(lits)


def extract_plain(blocks: torch.Tensor, cands: torch.Tensor, nxt: torch.Tensor,
                  valid_lens: torch.Tensor, cap: int):
    """The serial scan, row by row on the host. Same contract as
    `extract_compact`; results land on the inputs' device."""
    B, N = blocks.shape
    bl = blocks.cpu().numpy()
    cd = cands.cpu().numpy()
    nx = nxt.cpu().numpy()
    vls = valid_lens.cpu().numpy()
    ll = np.zeros((B, cap), np.int32)
    off = np.zeros((B, cap), np.int32)
    ml = np.zeros((B, cap), np.int32)
    lits = np.zeros((B, N), np.uint8)
    nb = np.zeros(B, np.int32)
    nb_lit = np.zeros(B, np.int32)
    for b in range(B):
        r_ll, r_off, r_ml, r_lits = _extract_row(
            bl[b].tobytes(), cd[b].tolist(), nx[b].tolist(), int(vls[b]), cap)
        k = len(r_ll)
        ll[b, :k], off[b, :k], ml[b, :k] = r_ll, r_off, r_ml
        lits[b, :len(r_lits)] = np.frombuffer(r_lits, np.uint8)
        nb[b], nb_lit[b] = k, len(r_lits)
    dev = blocks.device
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (ll, off, ml, lits, nb, nb_lit))


def extract_compact(blocks: torch.Tensor, cands: torch.Tensor,
                    nxt: torch.Tensor, valid_lens: torch.Tensor, cap: int):
    """(ll, off, ml i32[B, cap], lits u8[B, N], nb_seq i32[B],
    nb_lit i32[B]). CPU tensors take `extract_plain`; CUDA tensors launch
    csrc/extract.cu (one CTA per row, its chain walked in 32 segments) or
    raise. nxt must be `next_possible(blocks, cands)`, as ops.seqextract
    builds it: the kernel walks one step per match through it."""
    if blocks.device.type == "cpu":
        return extract_plain(blocks, cands, nxt, valid_lens, cap)
    return _extract_cuda(blocks, cands, nxt, valid_lens, cap, None)


def extract_compact_stats(blocks: torch.Tensor, cands: torch.Tensor,
                          nxt: torch.Tensor, valid_lens: torch.Tensor,
                          cap: int):
    """`extract_compact` on CUDA tensors, plus i32[B, 8] counts per row from
    the kernel: the longest segment's speculative steps, the repair steps,
    the repair rounds, the matches found before the cap, the row's SM
    cycles, and the longest warp's cycles in the speculate, repair and emit
    phases."""
    if blocks.device.type == "cpu":
        raise ValueError("extract_compact_stats: the counts come from the CUDA "
                         "kernel; CPU tensors take extract_compact")
    stats = torch.empty((blocks.shape[0], 8), dtype=torch.int32,
                        device=blocks.device)
    return _extract_cuda(blocks, cands, nxt, valid_lens, cap, stats), stats


def _extract_cuda(blocks, cands, nxt, valid_lens, cap, stats):
    B, N = blocks.shape
    if blocks.device.type != "cuda":
        raise ValueError(f"extract_compact: unsupported device {blocks.device}")
    for name, t, dt, shape in (("blocks", blocks, torch.uint8, (B, N)),
                               ("cands", cands, torch.int32, (B, N)),
                               ("nxt", nxt, torch.int32, (B, N)),
                               ("valid_lens", valid_lens, torch.int32, (B,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != blocks.device \
                or not t.is_contiguous():
            raise ValueError(f"extract_compact: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {blocks.device}")
    lib = _kernels.get("extract.cu")
    if lib.extract_smem_bytes(N) > _kernels.SMEM_LIMIT:
        raise ValueError(f"extract_compact: row of {N} bytes exceeds shared memory")
    dev = blocks.device
    ll = torch.empty((B, cap), dtype=torch.int32, device=dev)
    off = torch.empty_like(ll)
    ml = torch.empty_like(ll)
    lits = torch.empty((B, N), dtype=torch.uint8, device=dev)
    nb = torch.empty(B, dtype=torch.int32, device=dev)
    nb_lit = torch.empty_like(nb)
    scratch = torch.empty(B * lib.extract_scratch_bytes(N), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.extract_launch(
            blocks.data_ptr(), cands.data_ptr(), nxt.data_ptr(),
            valid_lens.data_ptr(), ll.data_ptr(), off.data_ptr(),
            ml.data_ptr(), lits.data_ptr(), nb.data_ptr(), nb_lit.data_ptr(),
            scratch.data_ptr(), 0 if stats is None else stats.data_ptr(),
            B, N, cap, ctypes.c_void_p(stream))
    _kernels.check(err, "extract_launch")
    _kernels.LAUNCHES["extract"] += 1
    return ll, off, ml, lits, nb, nb_lit
