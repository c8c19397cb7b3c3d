"""The lazy and v3 device match engines, batched over rows [B, n].

Counterpart of zstd_tpu/ops/fastmatch.py: bytes combine into f32 "tri"
words (3 bytes, exact below 2^24), a prime-mod linear form in f32 buckets
every position, one stable sort per row gives each position its previous
same-bucket positions, 3-byte compares quantize each candidate's match
length, a lockstep greedy commit over 512-byte chunks picks the matches
(`select_resolve`: on a card one launch of csrc/lazy_resolve.cu scores the
candidates and walks the chunks; on the CPU the plain chain `lazy_mlen` or
`capped_mlen`, `next_matchable`, `resolve_plain`), and two more launches
turn them into the seqstore: `seq_merge` (csrc/seq_merge.cu; on the CPU
`compact`, `rep_rewrite`, `merge_chains`) and `finish_sequences`
(csrc/seq_finish.cu; on the CPU `finish_sequences_plain`).

- `extract_batch_lazy`, the engine of every level whose strategy is >= 3:
  `LAZY_DEPTH` rows of candidates on the mls hash and 2 on a 4-byte hash,
  scored by an approximate bit gain, with a one- or two-byte deferral.
- `extract_batch_v3`: one candidate on the mls hash, lengths from
  `MLEN_PASSES` with the economics filter.

The JAX module reads three settings from the environment; here they are
constants at their defaults: the economics filter is on
(`ZSTD_TPU_NOECON` unset), `MLEN_PASSES` is (4, 7, 10)
(`ZSTD_TPU_MLEN_PASSES` unset) and `LAZY_DEPTH` is 8
(`ZSTD_TPU_DEV_ROW_WIDTH` unset). Nothing here takes `emit_from` or
`halo_ok`: every caller of the JAX engines leaves them at 0 and True.

The plain versions run the JAX `while_loop`s of `_rep_rewrite` and
`_finish_sequences` as a fixed number of passes of torch ops: each pass
carries the previous pass's `eq`/`ok` as its `active` mask, so the passes
after the JAX loop would have stopped change nothing. The kernels run each
sequence's loop in one thread and stop it where the mask goes false.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels

MIN_EMIT = 4
CAP_MLEN = 19
MLEN_PASSES = (4, 7, 10)
LAZY_PASSES = (4, 7, 10, 13, 16, 19)
LAZY_DEPTH = 8
LAZY_ROWS = LAZY_DEPTH + 2       # then 2 rows on the 4-byte hash
RESOLVE_CHUNK = 512
RESOLVE_STEPS = 160
REP_PASSES = 6                   # j = 0, 3, ..., 15: the JAX loop stops at 18
EXT3_PASSES, EXT1_PASSES, BACK3_PASSES, BACK1_PASSES = 7, 2, 5, 2

_PRIMES = {11: 2039, 12: 4093, 13: 8191, 14: 16381, 15: 32749, 16: 65521,
           17: 131071}
_NO_GAIN = -1e9


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[:, k:] followed by k zeros."""
    return torch.nn.functional.pad(a[:, k:], (0, k)) if k else a


def _check_cuda(what, dev, specs):
    """Raise unless each (name, tensor, dtype, shape) of specs is a
    contiguous tensor of that dtype and shape on dev, and dev is a CUDA
    device (a kernel's inputs; checked in that order)."""
    for name, t, dtype, shape in specs:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {tuple(shape)} on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")


def tri_arrays(blocks: torch.Tensor):
    """blocks u8[B, n] -> f32[B, n] each: tri[i] = b[i] + 256 b[i+1] +
    65536 b[i+2], b3[i] = b[i+3], tri3[i] = tri[i+3], b6[i] = b[i+6]
    (zeros past the end)."""
    n = blocks.shape[1]
    bp = torch.nn.functional.pad(blocks.to(torch.float32), (0, 16))
    tri = bp[:, 0:n] + 256.0 * bp[:, 1:n + 1] + 65536.0 * bp[:, 2:n + 2]
    tri3 = bp[:, 3:n + 3] + 256.0 * bp[:, 4:n + 4] + 65536.0 * bp[:, 5:n + 5]
    return tri, bp[:, 3:n + 3], tri3, bp[:, 6:n + 6]


def hash_f32(tri, tri3, b3, b6, hash_log: int, mls: int) -> torch.Tensor:
    """int32[B, n] bucket ids in [0, prime), equal to the JAX `_hash_f32`.

    The linear forms round in f32 op by op. The JAX program on the CPU
    computes mod_p's `x - q * prime` as one fused multiply-add, so it is
    rounded once here too: exact in float64 (q * prime < 2^48), then cast.
    Above hash_log 19 the products pass 2^24 and the two roundings differ.
    """
    prime = _PRIMES.get(hash_log, (1 << hash_log) - 5)

    def mod_p(x):
        q = torch.floor(x / prime)
        return (x.to(torch.float64) - q.to(torch.float64) * prime).to(
            torch.float32)

    t_hi = torch.floor(tri / 4096.0)
    t_lo = tri - t_hi * 4096.0
    x = mod_p(t_lo * 739.0 + t_hi * 523.0)
    x = mod_p(x * 31.0 + b3 * 173.0)
    if mls >= 5:
        b4 = torch.floor(tri3 / 256.0) - torch.floor(tri3 / 65536.0) * 256.0
        x = mod_p(x * 17.0 + b4 * 101.0)
    if mls >= 6:
        x = mod_p(x * 13.0 + torch.floor(tri3 / 65536.0) * 61.0)
    if mls >= 7:
        x = mod_p(x * 11.0 + b6 * 43.0)
    return x.clamp(0, prime - 1).to(torch.int32)


def candidate_rows(h: torch.Tensor, valid_lens: torch.Tensor,
                   width: int, out: torch.Tensor | None = None) -> list:
    """The `width` previous same-bucket positions of every position: a list
    of int32[B, n], the k-th (k = 1..width) the sorted order shifted by k
    (-1 = none, and at or past valid_len). With `out` (int32[width, B, n])
    the k-th is written into out[k - 1] and the list holds those views."""
    B, n = h.shape
    pos = torch.arange(n, device=h.device)
    invalid = pos[None, :] >= valid_lens[:, None]
    hv = torch.where(invalid, 1 << 30, h)
    h_sorted, order = torch.sort(hv, dim=1, stable=True)
    order32 = order.to(torch.int32)
    rows = []
    for k in range(1, width + 1):
        prev = torch.where(h_sorted[:, k:] == h_sorted[:, :-k],
                           order32[:, :-k], -1)
        ck = torch.empty((B, n), dtype=torch.int32, device=h.device) \
            if out is None else out[k - 1]
        ck.fill_(-1)
        ck.scatter_(1, order[:, k:], prev)
        rows.append(ck.masked_fill_(invalid, -1))
    return rows


def _run_lengths(tri, b3, cand, passes):
    """(quantized match length vs cand, 4 + 3 per verified 3-byte pass;
    cand clamped to >= 0 as int64)."""
    n = tri.shape[1]
    c = cand.clamp(min=0).to(torch.int64)
    run = torch.where((cand >= 0) & (tri.gather(1, c) == tri)
                      & (b3.gather(1, c) == b3), 4, 0).to(torch.int32)
    still = run > 0
    for k in passes:
        still = still & (tri.gather(1, (c + k).clamp(max=n - 1))
                         == _shift(tri, k))
        run = run + torch.where(still, 3, 0).to(torch.int32)
    return run, c


def _tail_clip(mlen, valid_lens):
    """No match starts in a row's last 16 bytes; lengths end at valid_len."""
    pos = torch.arange(mlen.shape[1], device=mlen.device)[None, :]
    vl = valid_lens[:, None]
    mlen = torch.where(pos < vl - 16, mlen, 0)
    return torch.minimum(mlen, (vl - pos).clamp(min=0)).to(torch.int32)


def capped_mlen_at(tri, b3, cand, valid_lens) -> torch.Tensor:
    """The lazy engine's lengths vs an arbitrary candidate row: `LAZY_PASSES`,
    no economics filter (the JAX `_capped_mlen_at`)."""
    return _tail_clip(_run_lengths(tri, b3, cand, LAZY_PASSES)[0], valid_lens)


def capped_mlen(tri, b3, cand, valid_lens) -> torch.Tensor:
    """The v3 engine's lengths (the JAX `_capped_mlen`): `MLEN_PASSES`, then
    the economics filter, a short match at a far offset counting as none."""
    mlen, c = _run_lengths(tri, b3, cand, MLEN_PASSES)
    dist = torch.arange(mlen.shape[1], device=mlen.device)[None, :] - c
    weak = ((mlen < 6) & (dist > 1024)) | ((mlen < 5) & (dist > 64))
    return _tail_clip(torch.where(weak, 0, mlen), valid_lens)


def next_matchable(mlen: torch.Tensor) -> torch.Tensor:
    """int32[B, n]: the first position >= i whose mlen >= MIN_EMIT, else 2n
    (a reverse running minimum)."""
    n = mlen.shape[1]
    pos = torch.arange(n, device=mlen.device, dtype=torch.int32)
    cand_pos = torch.where(mlen >= MIN_EMIT, pos, 2 * n)
    return torch.cummin(cand_pos.flip(1), dim=1).values.flip(1)


# ---- the chunked greedy resolve: kernel and plain version ---------------

def resolve_plain(mlen: torch.Tensor, nxt: torch.Tensor,
                  steps: torch.Tensor | None = None):
    """The lockstep greedy commit over 512-byte chunks, RESOLVE_STEPS steps
    (the JAX `_resolve`, batched). Returns (yp, yl) int32[B, L * 160]: the
    slots of chunk c at [c * 160, (c + 1) * 160), slot t written by step t,
    (-1, 0) where the step took no match. If `steps` (int32[B, L]) is given,
    it receives the steps each chunk ran with ip < end."""
    B, n = mlen.shape
    L = n // RESOLVE_CHUNK
    dev = mlen.device
    base = torch.arange(L, device=dev, dtype=torch.int64) * RESOLVE_CHUNK
    end = (base + RESOLVE_CHUNK)[None, :]
    nxt64 = nxt.to(torch.int64)
    ip = torch.minimum(nxt64[:, base.clamp(max=n - 1)], end)
    yp = torch.empty((B, RESOLVE_STEPS, L), dtype=torch.int32, device=dev)
    yl = torch.empty_like(yp)
    active = torch.zeros((B, L), dtype=torch.int32, device=dev)
    for t in range(RESOLVE_STEPS):
        live = ip < end
        l = torch.minimum(mlen.gather(1, ip.clamp(max=n - 1)), end - ip)
        take = live & (l >= MIN_EMIT)
        nip = nxt64.gather(1, (ip + torch.where(take, l, 1)).clamp(max=n - 1))
        yp[:, t] = torch.where(take, ip, -1)
        yl[:, t] = torch.where(take, l, 0)
        active += live
        ip = torch.where(live, torch.minimum(nip, end), ip)
    if steps is not None:
        steps.copy_(active)
    return (yp.transpose(1, 2).reshape(B, L * RESOLVE_STEPS),
            yl.transpose(1, 2).reshape(B, L * RESOLVE_STEPS))


def resolve(mlen: torch.Tensor, nxt: torch.Tensor):
    """(yp, yl) of `resolve_plain`, for CPU tensors only: on a card the walk
    runs inside `select_resolve`'s kernel, which also computes its mlen and
    nxt."""
    if mlen.device.type != "cpu":
        raise ValueError(f"resolve: unsupported device {mlen.device}; on a "
                         "card the walk runs inside select_resolve")
    return resolve_plain(mlen, nxt)


# ---- scoring and resolve in one: the kernel and its plain chain ----------

MODES = ("lazy", "v3")


def select_resolve_plain(blocks, rows, valid_lens, mode: str,
                         steps: torch.Tensor | None = None):
    """The committed slots of one engine from the block bytes and its
    candidate rows: (yp, yl, cand), yp and yl as `resolve_plain` gives them,
    cand the candidate each position's match takes. mode "lazy": rows are
    the LAZY_ROWS rows (`lazy_mlen`: best gain, deferral; cand its best
    candidate); "v3": one row (`capped_mlen`; cand that row). If `steps`
    (int32[B, L]) is given, it receives the walk's active steps a chunk."""
    tri, b3, _, _ = tri_arrays(blocks)
    if mode == "lazy":
        mlen, cand = lazy_mlen(tri, b3, rows, valid_lens)
    elif mode == "v3":
        cand = rows[0]
        mlen = capped_mlen(tri, b3, cand, valid_lens)
    else:
        raise ValueError(f"select_resolve: unknown mode {mode!r}")
    yp, yl = resolve_plain(mlen, next_matchable(mlen), steps)
    return yp, yl, cand


def select_resolve(blocks, rows, valid_lens, mode: str):
    """(yp, yl, cand) of `select_resolve_plain`. blocks u8[B, n], rows
    int32[R, B, n] (R = LAZY_ROWS in mode "lazy", 1 in "v3"), valid_lens
    int32[B] (<= n). CPU tensors take the plain chain; CUDA tensors launch
    csrc/lazy_resolve.cu or raise."""
    if blocks.device.type == "cpu":
        return select_resolve_plain(blocks, rows, valid_lens, mode)
    return _select_resolve_cuda(blocks, rows, valid_lens, mode, None)


def select_resolve_stats(blocks, rows, valid_lens, mode: str):
    """`select_resolve` on CUDA tensors, plus the kernel's int32[B, L] count
    of the steps each chunk ran with ip < end."""
    if blocks.device.type == "cpu":
        raise ValueError("select_resolve_stats: the counts come from the CUDA "
                         "kernel; CPU tensors take select_resolve_plain(..., "
                         "steps=)")
    steps = torch.empty((blocks.shape[0], blocks.shape[1] // RESOLVE_CHUNK),
                        dtype=torch.int32, device=blocks.device)
    return _select_resolve_cuda(blocks, rows, valid_lens, mode, steps), steps


def _select_resolve_cuda(blocks, rows, valid_lens, mode, steps):
    B, n = blocks.shape
    dev = blocks.device
    if mode not in MODES:
        raise ValueError(f"select_resolve: unknown mode {mode!r}")
    R = LAZY_ROWS if mode == "lazy" else 1
    _check_cuda("select_resolve", dev, (
        ("blocks", blocks, torch.uint8, (B, n)),
        ("rows", rows, torch.int32, (R, B, n)),
        ("valid_lens", valid_lens, torch.int32, (B,))))
    if blocks.data_ptr() % 8:
        raise ValueError("select_resolve: blocks must be 8-byte aligned")
    L = n // RESOLVE_CHUNK
    yp = torch.empty((B, L * RESOLVE_STEPS), dtype=torch.int32, device=dev)
    yl = torch.empty_like(yp)
    cand = torch.empty((B, n), dtype=torch.int32, device=dev) \
        if mode == "lazy" else rows[0]
    if B * n == 0:
        return yp, yl, cand
    lib = _kernels.get("lazy_resolve.cu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lazy_resolve_launch(
            blocks.data_ptr(), rows.data_ptr(), valid_lens.data_ptr(),
            yp.data_ptr(), yl.data_ptr(),
            cand.data_ptr() if mode == "lazy" else 0,
            0 if steps is None else steps.data_ptr(), B, n, R,
            MODES.index(mode), ctypes.c_void_p(stream))
    _kernels.check(err, "lazy_resolve_launch")
    _kernels.LAUNCHES["lazy_resolve"] += 1
    return yp, yl, cand


# ---- from commits to the seqstore -----------------------------------------

def _group_reduce(gidx, cap, n, length, pos, dist):
    """Per-group (sum of length, min of pos, max of dist) over groups
    [0, cap); gidx == cap is dropped."""
    B = gidx.shape[0]
    dev = gidx.device
    glen = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
    glen.scatter_add_(1, gidx, length)
    gpos = torch.full((B, cap + 1), n, dtype=torch.int32, device=dev)
    gpos.scatter_reduce_(1, gidx, pos, "amin", include_self=True)
    gdist = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
    gdist.scatter_reduce_(1, gidx, dist, "amax", include_self=True)
    return gpos[:, :cap], glen[:, :cap], gdist[:, :cap]


def compact(yp, yl, cand, seq_cap: int, n: int):
    """Merge contiguous same-distance commits on the slot array and compact
    the group leaders into [B, seq_cap] (the JAX `_compact`). Returns (pos,
    len, dist, nb)."""
    valid = yl > 0
    dist = torch.where(valid, yp - cand.gather(1, yp.clamp(min=0).to(
        torch.int64)), 0)
    end = torch.where(valid, yp + yl, 0)
    M = yp.shape[1]
    idx = torch.arange(M, device=yp.device)
    last = torch.cummax(torch.where(valid, idx, -1), dim=1).values
    prev = torch.nn.functional.pad(last[:, :-1], (1, 0), value=-1)
    pv = prev >= 0
    pc = prev.clamp(min=0)
    mergeable = valid & pv & (yp == end.gather(1, pc)) \
        & (dist == dist.gather(1, pc))
    is_start = valid & ~mergeable
    group = torch.cumsum(is_start, dim=1) - 1
    gidx = torch.where(valid & (group < seq_cap) & (group >= 0), group,
                       seq_cap)
    gpos, glen, gdist = _group_reduce(gidx, seq_cap, n, yl, yp, dist)
    nb = is_start.sum(1).clamp(max=seq_cap).to(torch.int32)
    return gpos, glen, gdist, nb


def rep_rewrite(tri, pos_c, len_c, dist_c, nb, n: int) -> torch.Tensor:
    """The previous sequence's distance where sequence k also matches there
    over its whole length (<= 18, verified in 3-byte windows); the JAX
    `_rep_rewrite`, its loop as REP_PASSES passes of torch ops. A plain
    step of `seq_merge_plain`; on a card csrc/seq_merge.cu computes it."""
    cap = pos_c.shape[1]
    k = torch.arange(cap, device=pos_c.device)[None, :]
    d_prev = torch.roll(dist_c, 1, dims=1)
    candidate = (k < nb[:, None]) & (k > 0) & (d_prev > 0) \
        & (dist_c != d_prev) & (pos_c - d_prev >= 0)
    still = candidate
    for j in range(0, 3 * REP_PASSES, 3):
        ia = (pos_c + j).clamp(max=n - 1).to(torch.int64)
        ib = (pos_c - d_prev + j).clamp(max=n - 1).clamp(min=0).to(
            torch.int64)
        eq = tri.gather(1, ia) == tri.gather(1, ib)
        still = still & (eq | (j >= len_c))
    ok = candidate & still & (len_c <= 18)
    return torch.where(ok, d_prev, dist_c)


def merge_chains(pos_c, len_c, dist_c, nb, seq_cap: int, n: int):
    """Merge contiguous same-distance sequences (the JAX `_merge_chains`).
    Returns (pos, len, dist, nb)."""
    k = torch.arange(seq_cap, device=pos_c.device)[None, :]
    vmask = k < nb[:, None]
    mergeable = vmask & (k > 0) \
        & (pos_c == torch.roll(pos_c + len_c, 1, dims=1)) \
        & (dist_c == torch.roll(dist_c, 1, dims=1))
    group = torch.cumsum(~mergeable, dim=1) - 1
    gidx = torch.where(vmask, group.clamp(max=seq_cap - 1), seq_cap)
    gpos, glen, gdist = _group_reduce(gidx, seq_cap, n, len_c, pos_c, dist_c)
    gnb = (~mergeable & vmask).sum(1).clamp(max=seq_cap).to(torch.int32)
    return gpos, glen, gdist, gnb


def seq_merge_plain(yp, yl, cand, blocks, tri, seq_cap: int):
    """`compact`, `rep_rewrite` and `merge_chains` in turn, as torch ops:
    the merged sequences (pos, len, dist int32[B, seq_cap], nb int32[B])
    from the resolve's slots. `blocks` gives n; the rewrite reads `tri`."""
    n = blocks.shape[1]
    c_pos, c_len, c_dist, c_nb = compact(yp, yl, cand, seq_cap, n)
    c_dist = rep_rewrite(tri, c_pos, c_len, c_dist, c_nb, n)
    return merge_chains(c_pos, c_len, c_dist, c_nb, seq_cap, n)


_TAIL_CLUSTERS: dict = {}


def tail_ctas(kernel: str, B: int, n: int, seq_cap: int, device) -> int:
    """CTAs a row (2-4) for a launch of `kernel` ("seq_merge" or
    "seq_finish") over B rows of n bytes at seq_cap:
    `_kernels.fewest_waves` of `tail_clusters`, among the sizes that hold
    the row in shared memory where any does (`tail_held`)."""
    return _kernels.fewest_waves(B, tail_clusters(kernel, n, seq_cap, device),
                                 tail_held(kernel, n, seq_cap))


def tail_clusters(kernel: str, n: int, seq_cap: int, device) -> list:
    """The clusters of 2, 3 and 4 CTAs that the card holds at once for
    `kernel` on rows of n bytes at seq_cap (its occupancy query, once per
    device and shape)."""
    key = (kernel, torch.device(device).index, n, seq_cap)
    if key not in _TAIL_CLUSTERS:
        lib = _kernels.get(kernel + ".cu")
        if kernel == "seq_merge":
            M = (n // RESOLVE_CHUNK) * RESOLVE_STEPS
            query = functools.partial(lib.seq_merge_max_clusters, n, M)
        else:
            query = functools.partial(lib.seq_finish_max_clusters, n)
        with torch.cuda.device(device):
            _TAIL_CLUSTERS[key] = [query(seq_cap, c) for c in _kernels.CTAS]
    return _TAIL_CLUSTERS[key]


def tail_held(kernel: str, n: int, seq_cap: int) -> list:
    """Whether `kernel` keeps a row of n bytes at seq_cap in shared memory
    at 2, 3 and 4 CTAs a row (no global scratch: the faster route)."""
    lib = _kernels.get(kernel + ".cu")
    if kernel == "seq_merge":
        M = (n // RESOLVE_CHUNK) * RESOLVE_STEPS
        return [lib.seq_merge_scratch_ints(n, M, seq_cap, c) == 0
                for c in _kernels.CTAS]
    return [lib.seq_finish_scratch_ints(n, seq_cap, c) == 0
            for c in _kernels.CTAS]


# the phases a CTA of each tail kernel reports the end of, in SM cycles
# from its start (`seq_merge_cycles`, `finish_sequences_cycles`)
MERGE_STAMPS = ("stage", "pass 1", "exchange 1", "pass 2", "groups placed",
                "rewrite", "merge starts", "exchange 2", "writes")
FINISH_STAMPS = ("stage", "forward", "backward", "local ranks", "exchange",
                 "lit_idx")


def _cycles_args(name: str, blocks, ctas) -> None:
    if blocks.device.type == "cpu":
        raise ValueError(f"{name}_cycles: the cycles come from the CUDA "
                         f"kernel; CPU tensors take {name}")
    if ctas is not None and ctas not in _kernels.CTAS:
        raise ValueError(f"{name}_cycles: ctas must be one of "
                         f"{_kernels.CTAS}, not {ctas!r}")


def seq_merge(yp, yl, cand, blocks, tri, seq_cap: int):
    """(pos, len, dist, nb) of `seq_merge_plain`. yp, yl int32[B, L * 160]
    (L = n // 512) and cand int32[B, n] as `select_resolve` gives them
    (yp < n where yl > 0), blocks u8[B, n], tri f32[B, n] (its 3-byte
    words; the kernel compares the bytes). CPU tensors take the plain
    version; CUDA tensors launch csrc/seq_merge.cu (clusters of
    `tail_ctas` CTAs a row) or raise."""
    if blocks.device.type == "cpu":
        return seq_merge_plain(yp, yl, cand, blocks, tri, seq_cap)
    return _seq_merge_cuda(yp, yl, cand, blocks, tri, seq_cap, None)[0]


def seq_merge_cycles(yp, yl, cand, blocks, tri, seq_cap: int, ctas=None):
    """`seq_merge` on CUDA tensors at `ctas` CTAs a row (2-4; `tail_ctas`
    by default), and int64[B, C, len(MERGE_STAMPS)]: each CTA's SM cycles
    from its start to the end of each phase."""
    _cycles_args("seq_merge", blocks, ctas)
    return _seq_merge_cuda(yp, yl, cand, blocks, tri, seq_cap, ctas, True)


def _seq_merge_cuda(yp, yl, cand, blocks, tri, seq_cap, ctas, cycles=False):
    B, n = blocks.shape
    M = (n // RESOLVE_CHUNK) * RESOLVE_STEPS
    dev = blocks.device
    _check_cuda("seq_merge", dev, (
        ("yp", yp, torch.int32, (B, M)), ("yl", yl, torch.int32, (B, M)),
        ("cand", cand, torch.int32, (B, n)),
        ("blocks", blocks, torch.uint8, (B, n)),
        ("tri", tri, torch.float32, (B, n))))
    if yp.data_ptr() % 16 or yl.data_ptr() % 16:
        raise ValueError("seq_merge: yp and yl must be 16-byte aligned")
    out = tuple(torch.empty((B, seq_cap), dtype=torch.int32, device=dev)
                for _ in range(3)) \
        + (torch.empty((B,), dtype=torch.int32, device=dev),)
    if B == 0:
        return out, torch.zeros((0, 0, len(MERGE_STAMPS)), dtype=torch.int64,
                                device=dev)
    lib = _kernels.get("seq_merge.cu")
    ctas = ctas or tail_ctas("seq_merge", B, n, seq_cap, dev)
    stamps = torch.zeros((B, ctas, len(MERGE_STAMPS)), dtype=torch.int64,
                         device=dev) if cycles else None
    scratch = torch.empty(
        B * lib.seq_merge_scratch_ints(n, M, seq_cap, ctas),
        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seq_merge_launch(
            yp.data_ptr(), yl.data_ptr(), cand.data_ptr(), blocks.data_ptr(),
            *(t.data_ptr() for t in out),
            scratch.data_ptr() if scratch.numel() else 0,
            0 if stamps is None else stamps.data_ptr(), B, n, M, seq_cap,
            ctas, ctypes.c_void_p(stream))
    _kernels.check(err, "seq_merge_launch")
    _kernels.LAUNCHES["seq_merge"] += 1
    return out, stamps


def finish_sequences_plain(blocks, tri, seq_pos, seq_len, seq_off, nb_seq,
                           valid_lens, seq_cap: int) -> dict:
    """Exact forward then backward extension of the merged matches and the
    literal derivation, as torch ops (the JAX `_finish_sequences`; its four
    loops as EXT3, EXT1, BACK3 and BACK1 passes). Returns the seqstore:
    nb_seq, ll, off, ml, lit_idx (n - 1 past nb_lit), nb_lit, overflow. The
    plain version of `finish_sequences` (csrc/seq_finish.cu on a card)."""
    B, n = blocks.shape
    dev = blocks.device
    k = torch.arange(seq_cap, device=dev)[None, :]
    vmask = k < nb_seq[:, None]
    vl = valid_lens[:, None]
    next_start = torch.where(k + 1 < nb_seq[:, None],
                             torch.roll(seq_pos, -1, dims=1),
                             vl.clamp(max=n))
    room = torch.where(vmask, (next_start - (seq_pos + seq_len)).clamp(min=0),
                       0)
    bf = blocks.to(torch.int32)
    src = (seq_pos - seq_off).to(torch.int64)
    pos64 = seq_pos.to(torch.int64)
    limit = seq_len + room

    def fwd(vals, step, passes, ln):
        active = vmask & (room > 0)
        for _ in range(passes):
            ia = (pos64 + ln).clamp(max=n - 1)
            ib = (src + ln).clamp(max=n - 1).clamp(min=0)
            fits = ln + 3 <= limit if step == 3 else ln < limit
            active = (vals.gather(1, ia) == vals.gather(1, ib)) & active & fits
            ln = ln + torch.where(active, step, 0).to(torch.int32)
        return ln

    ln = fwd(bf, 1, EXT1_PASSES, fwd(tri, 3, EXT3_PASSES, seq_len))
    sl = torch.where(vmask, ln, 0)
    sp = seq_pos

    # backward: grow starts down while bytes match, never below the
    # previous sequence's end (sp + sl is unchanged by a pass)
    def back(vals, step, passes, sp, sl):
        active = vmask
        for _ in range(passes):
            prev_end = torch.where(k == 0, 0, torch.roll(sp + sl, 1, dims=1))
            ia = (sp - step).clamp(min=0).to(torch.int64)
            ib = (sp - seq_off - step).clamp(min=0).to(torch.int64)
            if step == 3:
                room_ok = (sp - 3 >= prev_end) & (sp - seq_off - 3 >= 0)
            else:
                room_ok = (sp > prev_end) & (sp - seq_off > 0)
            active = active & room_ok & (vals.gather(1, ia)
                                         == vals.gather(1, ib))
            d = torch.where(active, step, 0).to(torch.int32)
            sp, sl = sp - d, sl + d
        return sp, sl

    sp, sl = back(tri, 3, BACK3_PASSES, sp, sl)
    sp, sl = back(bf, 1, BACK1_PASSES, sp, sl)
    sl = torch.where(vmask, sl, 0)

    prev_end = torch.where(k == 0, 0, torch.roll(sp + sl, 1, dims=1))
    ll = torch.where(vmask, sp - prev_end, 0)
    ml = torch.where(vmask, sl, 0)
    off = torch.where(vmask, seq_off, 0)

    # literals: every position in [0, valid_len) no match covers
    def at(x):
        x = torch.where(vmask, x, n).to(torch.int64)
        return torch.where(x > n, n + 1, x)        # past n: dropped

    delta = torch.zeros((B, n + 2), dtype=torch.int32, device=dev)
    ones = torch.ones_like(sp)
    delta.scatter_add_(1, at(sp), ones)
    delta.scatter_add_(1, at(sp + sl), -ones)
    covered = torch.cumsum(delta[:, :n], dim=1) > 0
    pos = torch.arange(n, device=dev)[None, :]
    is_lit = ~covered & (pos < vl)
    nb_lit = is_lit.sum(1).to(torch.int32)
    lit_rank = torch.cumsum(is_lit, dim=1) - 1
    lit_idx = torch.full((B, n + 1), n - 1, dtype=torch.int32, device=dev)
    lit_idx.scatter_(1, torch.where(is_lit, lit_rank, n),
                     pos.expand(B, n).to(torch.int32))
    return dict(nb_seq=nb_seq, ll=ll, off=off, ml=ml,
                lit_idx=lit_idx[:, :n], nb_lit=nb_lit,
                overflow=nb_seq >= seq_cap)


def finish_sequences(blocks, tri, seq_pos, seq_len, seq_off, nb_seq,
                     valid_lens, seq_cap: int) -> dict:
    """The seqstore of `finish_sequences_plain` from the merged sequences:
    blocks u8[B, n], tri f32[B, n] (its 3-byte words; the kernel compares
    the bytes), seq_pos, seq_len, seq_off int32[B, seq_cap], nb_seq and
    valid_lens int32[B] (nb_seq <= seq_cap, valid_len <= n, as
    `seq_merge` gives them). CPU tensors take the plain version; CUDA
    tensors launch csrc/seq_finish.cu (clusters of `tail_ctas` CTAs a row)
    or raise."""
    if blocks.device.type == "cpu":
        return finish_sequences_plain(blocks, tri, seq_pos, seq_len, seq_off,
                                      nb_seq, valid_lens, seq_cap)
    return _finish_cuda(blocks, tri, seq_pos, seq_len, seq_off, nb_seq,
                        valid_lens, seq_cap, None)[0]


def finish_sequences_cycles(blocks, tri, seq_pos, seq_len, seq_off, nb_seq,
                            valid_lens, seq_cap: int, ctas=None):
    """`finish_sequences` on CUDA tensors at `ctas` CTAs a row (2-4;
    `tail_ctas` by default), and int64[B, C, len(FINISH_STAMPS)]: each
    CTA's SM cycles from its start to the end of each phase."""
    _cycles_args("finish_sequences", blocks, ctas)
    return _finish_cuda(blocks, tri, seq_pos, seq_len, seq_off, nb_seq,
                        valid_lens, seq_cap, ctas, True)


def _finish_cuda(blocks, tri, seq_pos, seq_len, seq_off, nb_seq, valid_lens,
                 seq_cap, ctas, cycles=False):
    B, n = blocks.shape
    dev = blocks.device
    _check_cuda("finish_sequences", dev, (
        ("blocks", blocks, torch.uint8, (B, n)),
        ("tri", tri, torch.float32, (B, n)),
        ("seq_pos", seq_pos, torch.int32, (B, seq_cap)),
        ("seq_len", seq_len, torch.int32, (B, seq_cap)),
        ("seq_off", seq_off, torch.int32, (B, seq_cap)),
        ("nb_seq", nb_seq, torch.int32, (B,)),
        ("valid_lens", valid_lens, torch.int32, (B,))))
    out = dict(nb_seq=nb_seq)
    for name in ("ll", "off", "ml"):
        out[name] = torch.empty((B, seq_cap), dtype=torch.int32, device=dev)
    out["lit_idx"] = torch.empty((B, n), dtype=torch.int32, device=dev)
    out["nb_lit"] = torch.empty((B,), dtype=torch.int32, device=dev)
    out["overflow"] = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return out, torch.zeros((0, 0, len(FINISH_STAMPS)),
                                dtype=torch.int64, device=dev)
    lib = _kernels.get("seq_finish.cu")
    ctas = ctas or tail_ctas("seq_finish", B, n, seq_cap, dev)
    stamps = torch.zeros((B, ctas, len(FINISH_STAMPS)), dtype=torch.int64,
                         device=dev) if cycles else None
    scratch = torch.empty(B * lib.seq_finish_scratch_ints(n, seq_cap, ctas),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seq_finish_launch(
            blocks.data_ptr(), seq_pos.data_ptr(), seq_len.data_ptr(),
            seq_off.data_ptr(), nb_seq.data_ptr(), valid_lens.data_ptr(),
            out["ll"].data_ptr(), out["off"].data_ptr(), out["ml"].data_ptr(),
            out["lit_idx"].data_ptr(), out["nb_lit"].data_ptr(),
            out["overflow"].data_ptr(),
            scratch.data_ptr() if scratch.numel() else 0,
            0 if stamps is None else stamps.data_ptr(), B, n, seq_cap, ctas,
            ctypes.c_void_p(stream))
    _kernels.check(err, "seq_finish_launch")
    _kernels.LAUNCHES["seq_finish"] += 1
    return out, stamps


def _seqstore(blocks, tri, rows, valid_lens, seq_cap, mode):
    """The shared back half of both engines: lengths, selection and resolve
    (`select_resolve`), compact, repcode rewrite and chain merge
    (`seq_merge`), extension and literals (`finish_sequences`)."""
    yp, yl, cand = select_resolve(blocks, rows, valid_lens, mode)
    seq = seq_merge(yp, yl, cand, blocks, tri, seq_cap)
    return finish_sequences(blocks, tri, *seq, valid_lens, seq_cap)


def gain(ml: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """f32 approximate bit gain of a match: 7.5 a byte less 8 + ceil(log2(d
    + 1)), where ceil(log2(d + 1)) is the bit length of the distance d >= 1
    (frexp's exponent, exact); -1e9 where there is no match."""
    pos = torch.arange(ml.shape[1], device=ml.device)[None, :]
    d = (pos - cand).clamp(min=1).to(torch.float32)
    cost = 8.0 + torch.frexp(d).exponent.to(torch.float32)
    g = 7.5 * ml.to(torch.float32) - cost
    return torch.where((ml >= 4) & (cand >= 0), g, _NO_GAIN)


def lazy_mlen(tri, b3, rows, valid_lens):
    """(mlen, cand) of the lazy engine: the candidate of the best gain over
    `rows` (the nearer one on ties), its length where the gain is positive,
    0 where a match 1 or 2 bytes later gains more than this one plus the
    stepped-over literals."""
    best_gain = torch.full(tri.shape, _NO_GAIN, dtype=torch.float32,
                           device=tri.device)
    best_len = torch.zeros(tri.shape, dtype=torch.int32, device=tri.device)
    best_cand = torch.full(tri.shape, -1, dtype=torch.int32, device=tri.device)
    for cand in rows:
        ml = capped_mlen_at(tri, b3, cand, valid_lens)
        g = gain(ml, cand)
        take = g > best_gain
        best_gain = torch.where(take, g, best_gain)
        best_len = torch.where(take, ml, best_len)
        best_cand = torch.where(take, cand, best_cand)
    mlen = torch.where(best_gain > 0.0, best_len, 0)
    g1 = torch.nn.functional.pad(best_gain[:, 1:], (0, 1), value=_NO_GAIN)
    g2 = torch.nn.functional.pad(best_gain[:, 2:], (0, 2), value=_NO_GAIN)
    defer = (g1 > best_gain + 7.5) | (g2 > best_gain + 15.0)
    return torch.where(defer, 0, mlen), best_cand


def engine_rows(blocks: torch.Tensor, valid_lens: torch.Tensor,
                hash_log: int, mls: int, mode: str):
    """(tri, rows): the tri words and the candidate rows int32[R, B, n] of
    an engine, "lazy": LAZY_DEPTH rows on the mls hash, then 2 on the
    4-byte hash; "v3": one row on the mls hash."""
    tri, b3, tri3, b6 = tri_arrays(blocks)
    h = hash_f32(tri, tri3, b3, b6, hash_log, mls)
    if mode == "lazy":
        h4 = h if mls == 4 else hash_f32(tri, tri3, b3, b6, hash_log, 4)
        parts = ((h, LAZY_DEPTH), (h4, 2))
    else:
        parts = ((h, 1),)
    rows = torch.empty((sum(w for _, w in parts), *blocks.shape),
                       dtype=torch.int32, device=blocks.device)
    k = 0
    for hk, width in parts:
        candidate_rows(hk, valid_lens, width, out=rows[k:k + width])
        k += width
    return tri, rows


def extract_batch_lazy(blocks: torch.Tensor, valid_lens: torch.Tensor,
                       hash_log: int, mls: int, seq_cap: int) -> dict:
    """blocks u8[B, n], valid_lens i32[B]: the seqstore of the lazy engine
    (the JAX `extract_batch_lazy` at depth LAZY_DEPTH)."""
    tri, rows = engine_rows(blocks, valid_lens, hash_log, mls, "lazy")
    return _seqstore(blocks, tri, rows, valid_lens, seq_cap, "lazy")


def extract_batch_v3(blocks: torch.Tensor, valid_lens: torch.Tensor,
                     hash_log: int, mls: int, seq_cap: int) -> dict:
    """The seqstore of the v3 engine (the JAX `extract_batch_v3`)."""
    tri, rows = engine_rows(blocks, valid_lens, hash_log, mls, "v3")
    return _seqstore(blocks, tri, rows, valid_lens, seq_cap, "v3")
