"""Device 3-state interleaved FSE sequence encoding.

Counterpart of fse_pack_block in zstd_tpu/ops/fse_enc.py (zstd's
lib/compress/zstd_compress_sequences.c ZSTD_encodeSequences_body:291),
batched over blocks. The state chain is `fse_fields`: csrc/fse_chain.cu for
CUDA tensors, `fse_fields_plain` (a loop over the sequences on [B]-vectors
of torch ops) for CPU tensors. The kernel cuts each chain at its narrowest
steps and resolves the cuts (the design is in the source);
tests/chainmodel.py models it in Python. ops.bitpack packs the fields.

Field order per block (M = 6 * cap + 4 fields, the scan's order in
zstd_tpu): step k = 0..cap-1 handles sequence i = cap-1-k and writes
[OF state, ML state, LL state, LL extra, ML extra, OF extra]; padding steps
(i >= nb_seq) come first with nbits 0; the step i == nb_seq-1 sets the init
states and writes only its extras; then the ML, OF, LL flushes and the
(1, 1) sentinel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..constants import LL_BITS, ML_BITS
from . import device_table
from .bitpack import pack_bits

T_LL, T_OF, T_ML = 0, 1, 2
STATE_TABLE_PAD = 512  # 2^max(LLFSELog, MLFSELog)
SYM_PAD = 64


def _check_inputs(codes, nb, st, dn, df, tl):
    B, cap = codes[0].shape
    dev = codes[0].device
    want = [(c, (B, cap)) for c in codes] + [
        (nb, (B,)), (st, (B, 3, STATE_TABLE_PAD)), (dn, (B, 3, SYM_PAD)),
        (df, (B, 3, SYM_PAD)), (tl, (B, 3))]
    for t, shape in want:
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"fse_fields: expected a contiguous int32 tensor "
                             f"of shape {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def fse_fields_plain(llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl):
    """The field list computed with torch ops: the state-independent fields
    for all steps at once, then one loop step per sequence for the states.
    Same contract as `fse_fields`."""
    B, cap = llc.shape
    dev = llc.device
    nb64 = nb.to(torch.int64)
    i = cap - 1 - torch.arange(cap, device=dev)            # sequence of step k
    valid = i[None, :] < nb64[:, None]                       # [B, cap]
    llb = device_table(LL_BITS, dev)[llc.clamp(0, 35).flip(1).long()]
    mlbits = device_table(ML_BITS, dev)[mlc.clamp(0, 52).flip(1).long()]
    z = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    vals = torch.stack([z, z, z,
                        torch.where(valid, llx.flip(1), 0),
                        torch.where(valid, mlb.flip(1), 0),
                        torch.where(valid, ob.flip(1), 0)], dim=2)
    nbits = torch.stack([z, z, z,
                         torch.where(valid, llb, 0),
                         torch.where(valid, mlbits, 0),
                         torch.where(valid, ofc.flip(1), 0)], dim=2)

    # the three chains side by side in field order [OF, ML, LL]: symbols,
    # their delta_nb / delta_fs and the state table of each, gathered once
    order = (T_OF, T_ML, T_LL)
    sym = torch.stack([c.long() for c in (ofc, mlc, llc)], dim=1)  # [B,3,cap]
    sym = sym.clamp(0, SYM_PAD - 1)
    d_nb = torch.stack([dn[:, t].long() for t in order], 1).gather(2, sym)
    d_fs = torch.stack([df[:, t].long() for t in order], 1).gather(2, sym)
    tab = torch.stack([st[:, t].long() for t in order], 1)   # [B, 3, 512]

    def next_state(state_idx):
        return tab.gather(2, state_idx.clamp(0, STATE_TABLE_PAD - 1)[:, :, None]
                          )[:, :, 0]

    # init states, from the last sequence's symbols (FSE_initCState2)
    last = (nb64 - 1).clamp(min=0)[:, None, None].expand(B, 3, 1)
    d0 = d_nb.gather(2, last)[:, :, 0]
    nb0 = (d0 + (1 << 15)) >> 16
    init = next_state((((nb0 << 16) - d0) >> nb0.clamp(0, 31))
                      + d_fs.gather(2, last)[:, :, 0])

    state = torch.zeros((B, 3), dtype=torch.int64, device=dev)
    n_steps = int(nb64.max()) if B else 0
    for seq in range(n_steps - 1, -1, -1):
        k = cap - 1 - seq
        is_init = (nb64 == seq + 1)[:, None]
        emit = ((seq < nb64)[:, None]) & ~is_init
        nb_out = (state + d_nb[:, :, seq]) >> 16
        new = next_state((state >> nb_out.clamp(0, 31)) + d_fs[:, :, seq])
        vals[:, k, :3] = torch.where(emit, state, 0)
        nbits[:, k, :3] = torch.where(emit, nb_out, 0)
        state = torch.where(is_init, init, torch.where(emit, new, state))
    has = nb64 > 0
    s_of, s_ml, s_ll = state.unbind(1)
    tail_v = torch.stack([torch.where(has, s_ml, 0),
                          torch.where(has, s_of, 0),
                          torch.where(has, s_ll, 0),
                          torch.ones_like(nb64)], dim=1)
    tl64 = tl.long()
    tail_n = torch.stack([torch.where(has, tl64[:, T_ML], 0),
                          torch.where(has, tl64[:, T_OF], 0),
                          torch.where(has, tl64[:, T_LL], 0),
                          torch.ones_like(nb64)], dim=1)
    return (torch.cat([vals.reshape(B, -1), tail_v.to(torch.int32)], dim=1),
            torch.cat([nbits.reshape(B, -1), tail_n.to(torch.int32)], dim=1))


def fse_fields(llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl):
    """Codes/extras i32[B, cap], nb i32[B] (<= cap), tables st i32[B, 3, 512],
    dn/df i32[B, 3, 64], table logs tl i32[B, 3]. Returns (values, nbits)
    i32[B, 6 * cap + 4]. CPU tensors take `fse_fields_plain`; CUDA tensors
    launch csrc/fse_chain.cu (a cut-and-resolve chain, one CTA per block and
    stream) or raise."""
    args = (llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl)
    if llc.device.type == "cpu":
        return fse_fields_plain(*args)
    return _fse_cuda(args, None)


def fse_fields_stats(llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl):
    """`fse_fields` on CUDA tensors, plus i32[B, 3, 10] counts per block and
    stream (LL, OF, ML) from the kernel: segments, longest segment, most
    candidates at a cut, candidate walk steps (as tests/chainmodel.py counts
    them), then the SM cycles of its stage, cut, candidate walk, resolve,
    replay and write phases."""
    if llc.device.type == "cpu":
        raise ValueError("fse_fields_stats: the counts come from the CUDA "
                         "kernel; CPU tensors take fse_fields")
    stats = torch.empty((llc.shape[0], 3, 10), dtype=torch.int32,
                        device=llc.device)
    args = (llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl)
    return _fse_cuda(args, stats), stats


def _fse_cuda(args, stats):
    llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl = args
    if llc.device.type != "cuda":
        raise ValueError(f"fse_fields: unsupported device {llc.device}")
    _check_inputs((llc, mlc, ofc, llx, mlb, ob), nb, st, dn, df, tl)
    B, cap = llc.shape
    lib = _kernels.get("fse_chain.cu")
    if lib.fse_chain_smem_bytes(cap) > _kernels.SMEM_LIMIT:
        raise ValueError(f"fse_fields: cap {cap} exceeds shared memory")
    vals = torch.empty((B, 6 * cap + 4), dtype=torch.int32, device=llc.device)
    nbits = torch.empty_like(vals)
    # candidate maps of a CTA whose maps do not fit in shared memory
    scratch = torch.empty(3 * B * lib.fse_chain_scratch_bytes(cap),
                          dtype=torch.uint8, device=llc.device)
    with torch.cuda.device(llc.device):
        stream = torch.cuda.current_stream(llc.device).cuda_stream
        err = lib.fse_chain_launch(
            *(a.data_ptr() for a in args), vals.data_ptr(), nbits.data_ptr(),
            scratch.data_ptr(), 0 if stats is None else stats.data_ptr(),
            B, cap, ctypes.c_void_p(stream))
    _kernels.check(err, "fse_chain_launch")
    _kernels.LAUNCHES["fse_chain"] += 1
    return vals, nbits


def fse_pack(llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl, out_words):
    """Batched fse_pack_block: (words int64[B, out_words], total_bits
    int32[B])."""
    vals, nbits = fse_fields(llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl)
    return pack_bits(vals, nbits, out_words)
