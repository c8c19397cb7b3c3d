#!/usr/bin/env python3
"""On-card smoke test of zstd_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from zstd_tpu_torch/csrc/ with nvcc, holds each
kernel against its plain version at the main path's shapes (exact equality:
zstd is an exact codec; the FSE chain also on synthetic table sets, and its
walk counts against tests/chainmodel.py), drives the level-1 encode of the
16 MiB corpus through both encode kernels, checks the frame against the CPU
path's on a 1 MiB prefix, then decodes that frame on the card through both
decode kernels (phase 6: the Huffman lanes in both layouts, the literal
pool and the sequence executor, each against its plain version on the
frame's group and on adversarial inputs, with the kernels' counts; the
over-read, literal-overrun and depth errors; the fixture frames of
tests/data/torch_decode), and drives the lazy engine (phase 7: the fused
scoring-and-resolve kernel against its plain chain in the lazy and v3
modes, the seqstore tail's two kernels, seq_merge and seq_finish, against
their plain torch ops, the 16 MiB level-5 encode with its profile and
stage times and an A/B against the plain tail, the 1 MiB prefix's frames
at levels 5 and 9 and under the v3 engine against the CPU path, and the
level-5 frame decoded on the card), drives the xla
engine and the sharded encode (phase 8: the xla_walk kernel, from the
candidates to the seqstore and the literal index in one launch, against
its plain chain and its counts against tests/xlaextractmodel.py, the 16 MiB
level-1 encode under engine="xla", and
parallel.zstdmt.compress_sharded in an NCCL group of one rank against a
gloo group on the CPU, its 16 MiB frame decoded on the card), drives the
sharded long-distance matcher and compress_long_sharded at levels 1, 3
and 19 (phase 9), and the multi-host pzstd, compress_my_shard and
decompress_stream, on the host codec (phase 10), holds the host C under the
host halves (the decode's sequence parse, the block decoder, XXH64, the
entropy planning and encoders) against their plain Python branches and
times both (phase 11), drives the command line, python -m
zstd_tpu_torch.cli, through the device encode and decode and every host
feature it reaches (phase 12), drives the rest of the host API, the
dictionary trainers, the seekable format and the external sequence
producer, with their frames decoded on the card (phase 13), and prints one
JSON line of kernel timings before its last line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result. Any failed check raises, so the exit code is then non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
N_BLOCK = 128 * 1024           # main path: 128 KiB blocks
CORPUS_BYTES = 16 * 1024 * 1024
PREFIX_BYTES = 1024 * 1024
LEVEL5_FRAME_BYTES = 5501989           # the corpus's level-5 frame
LONG_BYTES = 64 * 1024 * 1024          # phase 9: discovery
LONG_FRAME_BYTES = 16 * 1024 * 1024    # phase 9: compress_long_sharded
LONG_PREFIX_BYTES = 4 * 1024 * 1024
LONG_L19_BYTES = 2 * 1024 * 1024       # phase 9: the level-19 leg
PZSTD_L19_BYTES = 2 * 1024 * 1024      # phase 10: level 19 and the decode
CLI_L19_BYTES = 2 * 1024 * 1024        # phase 12: -19
CLI_DICT_BYTES = 1024 * 1024           # phase 12: -D (its decoder is Python)
CLI_PATCH_BYTES = 4 * 1024 * 1024      # phase 12: --patch-from
TRAIN_BYTES = 2 * 1024 * 1024          # phase 13: the trainers' samples
TRAIN_SAMPLE = 4096                    # phase 13: 512 samples of 4 KiB
TRAIN_OPT_BYTES = 512 * 1024           # phase 13: --optimize-cover if slow
TRAIN_DICT_BYTES = 1024 * 1024         # phase 13: -D with the trained dict
SEEK_FRAME = 1024 * 1024               # phase 13: seekable frame size
DEVICE = "cuda"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches, after one warm run. The
    launches queue behind a sleep kernel and run back to back, so the
    wrapper's host time between them is not counted."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)       # about 10 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 5) -> float:
    """Device time of one fn() call without its host launch overhead: fn()
    is captured once into a CUDA graph after a warm call, and the graph's
    replays are timed with CUDA events (mean of reps)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(a: tuple, b: tuple) -> int:
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype differ: {x.shape} {x.dtype} "
                                 f"vs {y.shape} {y.dtype}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def frame_blocks(frame: bytes) -> int:
    """Walk a frame's block headers (RFC 8878); returns the block count and
    checks that the last block ends where the frame (and checksum) ends."""
    fhd = frame[4]
    single = bool(fhd & 0x20)
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + \
        (1 if single else 0, 2, 4, 8)[fhd >> 6]
    count = 0
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        btype, bsize = (bh >> 1) & 3, bh >> 3
        assert btype != 3, "reserved block type"
        pos += 3 + (1 if btype == 1 else bsize)
        count += 1
        if bh & 1:
            break
    assert pos + (4 if fhd & 4 else 0) == len(frame), (pos, len(frame))
    return count


def print_walk(walk, nb_seq) -> None:
    """The extract kernel's counts per row (extract_compact_stats): the
    walk's steps and repair, and the SM cycles of the row and of the longest
    warp in each phase."""
    w = walk.cpu().tolist()
    for i, (st, rep, rnd, tot, cta, spec, fix, emit) in enumerate(w):
        print(f"  row {i}: longest segment {st} steps, repair {rep} steps in "
              f"{rnd} rounds, {tot} matches, nb_seq {int(nb_seq[i])}; cycles "
              f"{cta} (longest warp: speculate {spec}, repair {fix}, emit "
              f"{emit})")
    slow = max(w, key=lambda r: r[4])
    print(f"  slowest row: {slow[4]} cycles; longest warp: speculate "
          f"{slow[5]}, repair {slow[6]}, emit {slow[7]}", flush=True)


def print_chain(stats, rows: int) -> None:
    """The FSE chain kernel's counts per block and stream (fse_fields_stats):
    segments, longest segment, most candidates, candidate walk steps, and
    the SM cycles of its stage, cut, walk, resolve, replay and write
    phases; then the slowest CTA's phases."""
    s = stats.cpu().tolist()
    for i in range(rows):
        print(f"  row {i}: " + "; ".join(
            f"{name} {c[0]} seg, longest {c[1]}, cands {c[2]}, walk {c[3]}, "
            f"cycles {c[4:]}" for name, c in zip(("LL", "OF", "ML"), s[i])))
    slow = max((c for r in s for c in r), key=lambda c: sum(c[4:]))
    print("  slowest CTA cycles: " + ", ".join(
        f"{n} {v}" for n, v in zip(("stage", "cut", "walk", "resolve",
                                    "replay", "write"), slow[4:])),
          flush=True)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# finish_sequences' seqstore, in the order its kernel is compared
SEQSTORE_KEYS = ("nb_seq", "ll", "off", "ml", "lit_idx", "nb_lit",
                 "overflow")


def plain_tail_call(fn, *args):
    """fn(*args) with the lazy and v3 engines' seqstore tail on its plain
    torch ops: ops/fastmatch's seq_merge and finish_sequences swapped for
    seq_merge_plain and finish_sequences_plain while it runs (the pattern
    of tests/hostplain.plain_branches), then restored."""
    from zstd_tpu_torch.ops import fastmatch as fm
    saved = fm.seq_merge, fm.finish_sequences
    fm.seq_merge, fm.finish_sequences = (fm.seq_merge_plain,
                                         fm.finish_sequences_plain)
    try:
        return fn(*args)
    finally:
        fm.seq_merge, fm.finish_sequences = saved


class timed_calls:
    """Within the block, calls of each (owner, attribute) add their host
    wall time to `seconds[label]`."""

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {}

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in self.targets]
        for (obj, name, fn), (_, _, label) in zip(self.saved, self.targets):
            def run(*args, _fn=fn, _label=label, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.seconds[_label] = self.seconds.get(_label, 0.0) \
                        + time.perf_counter() - t0
            setattr(obj, name, run)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def profile_run(fn, retries: int = 6) -> dict:
    """Run fn() once under torch.profiler: the host wall time, the device's
    busy time (union of its kernel and copy intervals) and the device time
    by kernel name, in ms. A profiler session on the card now and then
    records no device activity at all; fn() then runs again in a new
    session (reported), up to `retries` times. Busy time is 0 if every
    session saw no device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(retries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
        print(f"  profiler session {attempt + 1} recorded no device "
              "activity", flush=True)
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy += max(e - max(s, end), 0)
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    return dict(wall_ms=wall * 1e3, busy_ms=busy / 1e3, by_name=by_name)


def profiled_encode(pipeline, dev, corpus: bytes, level: int,
                    encode=None, label: str | None = None) -> None:
    """One profiled encode of the corpus at `level` (or one call of
    `encode()`): the host halves timed by wrapping them on the compressor
    class, the device's busy time, idle share and the top kernels by device
    time."""
    cls = pipeline.TorchCompressor
    split = timed_calls([(cls, name, name)
                         for name in ("_build_plans", "_finalize")])
    if encode is None:
        comp = pipeline.TorchCompressor(level=level, device=dev)
        encode = lambda: comp.compress(corpus)       # noqa: E731
    label = label or f"level {level}"

    def run():
        split.seconds.clear()        # a rerun session counts once
        encode()

    with split:
        prof = profile_run(run)
    host_s = split.seconds
    print(f"{label} host: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in host_s.items()), flush=True)
    if prof["busy_ms"] <= 0:
        print(f"{label} profile: the profiler recorded no device "
              "activity; device busy time not measured", flush=True)
        return
    print(f"{label} profile: wall {prof['wall_ms']:.1f} ms, device "
          f"busy {prof['busy_ms']:.1f} ms, idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.5f}", flush=True)
    for kern in ("extract_kernel", "fse_chain_kernel", "lazy_resolve_kernel",
                 "seq_merge_kernel", "seq_finish_kernel", "xla_walk_kernel"):
        ms = sum(v for k, v in prof["by_name"].items() if kern in k)
        print(f"  {kern}: {ms:.3f} ms of device time", flush=True)
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:100]}")


def device_ms(fn, reps: int = 3) -> float:
    """Device busy time of one fn() call (union of its kernels and copies),
    the mean of reps profiled calls after a warm one. The decode wrappers
    check their inputs with a host sync before they launch, so events
    around back-to-back calls would also count host time. Raises if the
    profiler saw no device activity."""
    fn()
    busy = [profile_run(fn)["busy_ms"] for _ in range(reps)]
    if min(busy) <= 0:
        raise RuntimeError("the profiler recorded no device activity; "
                           "device time not measured")
    return sum(busy) / reps


def huf_counts(st) -> str:
    """Kernel 3's counts over the lanes (huf_decode_stats)."""
    s = st.cpu()
    act = s[:, 0] > 0
    return (f"segments {int(s[:, 0].sum())} (a lane: most {int(s[:, 0].max())}"
            f"), lanes repaired {int((s[:, 1] > 0).sum())} of "
            f"{int(act.sum())}, most repair rounds {int(s[:, 1].max())}, "
            f"longest speculative walk {int(s[:, 2].max())} steps, critical "
            f"path {int(s[:, 3].max())} steps")


def exec_counts(st) -> str:
    """Kernel 4's counts (exec_sequences_stats): hops, passes and their
    worklists, the pointers each out-of-place round changes, phase times."""
    from zstd_tpu_torch.ops.decode_dev import EXEC_CLASSES
    s = st.tolist()
    r, passes = s[0], s[3]
    cls = s[EXEC_CLASSES:EXEC_CLASSES + 32]
    changed = [sum(cls[c + 1:]) for c in range(r)]
    return (f"most hops {s[2]}, {passes} passes, worklist per pass "
            f"{s[4:4 + passes]}; pointers changed per round {changed}; "
            f"phases place/passes/gather {s[-4] / 1e3:.1f}/"
            f"{s[-3] / 1e3:.1f}/{s[-2] / 1e3:.1f} us (grid {s[-1]})")


def check_huf(dd, a: dict, label: str) -> int:
    """Kernel 3 in both layouts against huf_decode_plain and
    assemble_pool(huf_decode_plain(...)) on the lanes of `a` (tensors on the
    card); the pool is compared below nb_lit. Returns max_abs_err."""
    import torch
    lane = [a[k] for k in ("sb", "start_bits", "n_syms", "lut_sym",
                           "lut_len", "lane_tab")]
    segs = [a[k] for k in ("seg_start", "seg_lane", "seg_src", "seg_is_dev",
                           "host_lits")]
    ms = a["max_syms"]
    syms, final, st = dd.huf_decode_stats(*lane, ms)
    pool, pfinal = dd.literal_pool(*lane, *segs, a["nb_lit"], ms, a["npad"])
    torch.cuda.synchronize()
    want_syms, want_final = dd.huf_decode_plain(*lane, ms)
    want_pool = dd.assemble_pool(want_syms, *segs, a["npad"])
    n = a["n_syms"].clamp(0, ms)[:, None]
    below = torch.arange(ms, device=syms.device)[None, :] < n
    nb = a["nb_lit"]
    err = max(int(((syms.long() - want_syms.long()).abs() * below).max()),
              max_abs_err((final, pfinal), (want_final, want_final)),
              max_abs_err((pool[:nb],), (want_pool[:nb],)))
    print(f"huf_decode {label}: max_abs_err {err} (syms below n_syms, final,"
          f" pool below nb_lit {nb}); {huf_counts(st)}", flush=True)
    assert err == 0, f"huf_decode kernel disagrees with its plain ({label})"
    return err


def check_exec(dd, lits, ll, ml, off, nb_seq, out_len, n, hist, rounds,
               label: str):
    """Kernel 4 against exec_prepare + exec_resolve_plain on out, ok and the
    rounds run. Returns (max_abs_err, out, stats)."""
    import torch
    out, ok, r, st = dd.exec_sequences_stats(lits, ll, ml, off, nb_seq,
                                             out_len, n, hist, rounds)
    torch.cuda.synchronize()
    ptr, in_match, placed = dd.exec_prepare(lits, ll, ml, off, nb_seq,
                                            out_len, n)
    want, want_ok, want_r = dd.exec_resolve_plain(ptr, in_match, placed,
                                                  hist, out_len, rounds)
    err = max_abs_err((out,), (want,))
    same = bool(ok) == bool(want_ok) and int(r) == want_r
    print(f"exec_seq {label}: max_abs_err {err}, ok {bool(ok)}/"
          f"{bool(want_ok)}, rounds {int(r)}/{want_r} (kernel/plain); "
          f"{exec_counts(st)}", flush=True)
    assert err == 0 and same, f"exec_seq kernel disagrees ({label})"
    return err, out, st


def decode_phase(dev, corpus: bytes, frame: bytes, root: str) -> list:
    """Phase 6: the device decode of the main path's frame through both
    decode kernels, each kernel against its plain version on that frame's
    whole group and on adversarial inputs, the error paths, the fixture
    frames, and the timings. Returns the two kernels' entries of the
    kernels line."""
    import hashlib

    import numpy as np
    import torch
    from decodecases import (adversarial_group, exec_case, nested_data,
                             overrun_frame, underrun_frame)
    from hufmodel import decode_lanes
    from zstd_tpu_torch import _kernels, device_decoder, pipeline
    from zstd_tpu_torch.errors import Corruption
    from zstd_tpu_torch.ops import decode_dev as dd

    def on_card(g: dict) -> dict:
        return {k: torch.from_numpy(v).to(dev) if hasattr(v, "shape") else v
                for k, v in g.items()}

    # ---- the main path: decode the 16 MiB frame --------------------------
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    device_decoder.COUNTS["host_frames"] = 0
    times = []
    t0 = time.perf_counter()
    out = device_decoder.device_decompress(frame, device=dev)
    times.append(time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    host_frames = device_decoder.COUNTS["host_frames"]
    assert out == corpus, "device decode of the main path's frame differs"
    assert host_frames == 0, f"{host_frames} frames went to the host decoder"
    for k in ("huf_decode", "exec_seq"):
        assert launches[k] > 0, f"kernel {k} was not launched on the decode"
    t0 = time.perf_counter()
    out2 = device_decoder.device_decompress(frame, device=dev)
    times.append(time.perf_counter() - t0)
    assert out2 == corpus
    mbps = len(corpus) / min(times) / 1e6
    print(f"decode: {len(frame)} B -> {len(out)} B == corpus, {mbps:.2f} MB/s "
          f"(best of 2: {times[0]:.3f} s, {times[1]:.3f} s), launches "
          f"{launches}, host-decoded frames {host_frames}", flush=True)

    # ---- host parse, and the group's inputs on the card -------------------
    t0 = time.perf_counter()
    jobs = device_decoder._parse_jobs(frame, 31)
    parse_ms = (time.perf_counter() - t0) * 1e3
    pfs = [pf for _, pf, _ in jobs]
    g = device_decoder._group_inputs(pfs)
    g["npad"] = g["n"]
    a = on_card(g)
    nl = g["n_lanes"]
    nsy = g["n_syms"]
    print(f"decode group: {nl} lanes (bucket {g['sb'].shape[0]}), byte_cap "
          f"{g['sb'].shape[1]}, max_syms {g['max_syms']}, longest lane "
          f"{int(nsy.max())} symbols, {g['nb_seq']} sequences, n "
          f"{g['out_len']} (bucket {g['n']}); host parse {parse_ms:.1f} ms",
          flush=True)

    # ---- kernel 3 vs plain, both layouts -----------------------------------
    lane = [a[k] for k in ("sb", "start_bits", "n_syms", "lut_sym",
                           "lut_len", "lane_tab")]
    segs = [a[k] for k in ("seg_start", "seg_lane", "seg_src", "seg_is_dev",
                           "host_lits")]
    err_h = check_huf(dd, a, "16 MiB group")
    _, final_k, st = dd.huf_decode_stats(*lane, g["max_syms"])
    assert int(final_k[:nl].abs().max()) == 0, "a lane did not end at bit 0"
    # the kernel's counts against tests/hufmodel.py on four lanes
    pick = np.array([0, 1, nl // 2, nl - 1])
    _, _, m_counts = decode_lanes(
        *(g[k][pick] for k in ("sb", "start_bits", "n_syms")), g["lut_sym"],
        g["lut_len"], g["lane_tab"][pick], g["max_syms"])
    k_counts = st[torch.from_numpy(pick).to(dev)].cpu().numpy()
    print(f"  lanes {pick.tolist()}: kernel counts {k_counts.tolist()}, "
          f"model {m_counts.tolist()}", flush=True)
    assert (k_counts == m_counts).all(), "huf_decode counts differ from model"
    adv = on_card(adversarial_group(g))
    err_h = max(err_h, check_huf(dd, adv, "adversarial lanes"))
    # the decode path's layout: literal_pool (the lane-base scatter, the
    # pool's memset, pool_host_kernel and huf_lane_kernel)
    p_ms = device_ms(lambda: dd.literal_pool(*lane, *segs, g["nb_lit"],
                                             g["max_syms"], g["n"]))
    h_ms = device_ms(lambda: dd.huf_decode_streams(*lane, g["max_syms"]))
    p_plain_ms = host_ms(lambda: dd.assemble_pool(
        dd.huf_decode_plain(*lane, g["max_syms"])[0], *segs, g["n"]))
    # bytes of literal_pool, each once: the streams, start/n_syms/table of
    # each lane and its final, the tables the lanes use, the segments, the
    # host literals read, the pool's nb_lit bytes written
    nb_lit = g["nb_lit"]
    stream_bytes = sum(len(s) for pf in pfs for s, _ in pf.lanes)
    n_tabs = len(set(g["lane_tab"][:nl].tolist()))
    n_segs = int((g["seg_start"] < g["n"]).sum())
    host_bytes = nb_lit - int(nsy[:nl].sum())
    h_bytes = stream_bytes + 16 * nl + 2 * (1 << dd.MAX_TLOG) * n_tabs \
        + 13 * n_segs + host_bytes + nb_lit
    h_bound = h_bytes / HBM_BYTES_PER_S * 1e3
    print(f"huf_decode: literal_pool {p_ms:.4f} ms device (the decode's "
          f"layout: two kernels, a scatter and a memset), huf_decode_streams "
          f"{h_ms:.4f} ms device, plain literal_pool {p_plain_ms:.1f} ms, "
          f"bound {h_bound * 1e3:.2f} us ({h_bytes} B: {stream_bytes} B of "
          f"streams, {n_tabs} tables, {n_segs} segments, {host_bytes} host "
          f"literals, {nb_lit} pool bytes)", flush=True)

    # ---- kernel 4 vs plain --------------------------------------------------
    hist = torch.zeros(1, dtype=torch.uint8, device=dev)
    pool, _ = dd.literal_pool(*lane, *segs, g["nb_lit"], g["max_syms"],
                              g["n"])
    e_args = (pool, a["lls"], a["mls"], a["offs"], g["nb_seq"],
              g["out_len"], g["n"], hist)
    err_e, out_k, e_st = check_exec(dd, *e_args, None, "16 MiB group")
    assert out_k[:len(corpus)].cpu().numpy().tobytes() == corpus
    for seed, h, cut in ((1, 64, 100), (2, 300, 7)):
        lits, ll, ml, off, nb_seq, out_len, hist_np = exec_case(
            seed, 1 << 20, h, cut)
        c = [torch.from_numpy(x).to(dev) for x in (lits, ll, ml, off,
                                                   hist_np)]
        err_e = max(err_e, check_exec(
            dd, c[0], c[1], c[2], c[3], nb_seq, out_len, 1 << 20, c[4], None,
            f"1 MiB random, history {h}, out_len total - {cut}")[0])
    nested = nested_data()
    ng = on_card(device_decoder._group_inputs([device_decoder._parse_frame(
        pipeline.compress(nested, level=1, device=dev), 0, 31)]))
    npool, _ = dd.literal_pool(*(ng[k] for k in (
        "sb", "start_bits", "n_syms", "lut_sym", "lut_len", "lane_tab",
        "seg_start", "seg_lane", "seg_src", "seg_is_dev", "host_lits")),
        ng["nb_lit"], ng["max_syms"], ng["n"])
    for rounds in (1, 2, 3):
        err_e = max(err_e, check_exec(
            dd, npool, ng["lls"], ng["mls"], ng["offs"], ng["nb_seq"],
            ng["out_len"], ng["n"], hist, rounds,
            f"nested chains, round limit {rounds}")[0])
    e_ms = device_ms(lambda: dd.exec_sequences(*e_args))

    def plain_exec():
        ptr, in_match, placed = dd.exec_prepare(*e_args[:-1])
        return dd.exec_resolve_plain(ptr, in_match, placed, hist,
                                     g["out_len"])

    e_plain_ms = host_ms(plain_exec)
    # bytes of exec_sequences, each once: the literals the sequences read
    # (the sum of their literal lengths), 12 a sequence, the history, the
    # out_len bytes of output
    lit_total = int(g["lls"].sum(dtype=np.int64))
    e_bytes = lit_total + 12 * g["nb_seq"] + nbytes(hist) + g["out_len"]
    e_bound = e_bytes / HBM_BYTES_PER_S * 1e3
    s = e_st.tolist()
    wl_bytes = 4 * s[4] + 12 * g["n"] + sum(40 * x for x in s[4:4 + s[3]])
    print(f"exec_seq: exec_sequences {e_ms:.4f} ms device, plain "
          f"{e_plain_ms:.1f} ms, bound {e_bound * 1e3:.2f} us ({e_bytes} B: "
          f"{lit_total} literals, {g['nb_seq']} sequences, history, "
          f"{g['out_len']} out); pointers and worklists about {wl_bytes} B "
          f"= {wl_bytes / HBM_BYTES_PER_S * 1e6:.1f} us", flush=True)

    # ---- the device program of one already-parsed group ------------------
    device_decoder._dispatch_group(pfs, dev)          # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = device_decoder._dispatch_group(pfs, dev)
    end.record()
    torch.cuda.synchronize()
    group_host_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = start.elapsed_time(end)
    assert bool(res[1])
    # its parts: the host packing alone, and the fused decode between
    # events with its inputs already on the card (the wrappers' checks
    # included)
    t0 = time.perf_counter()
    device_decoder._group_inputs(pfs)
    pack_ms = (time.perf_counter() - t0) * 1e3
    fused_args = {k: v for k, v in a.items() if k != "npad"}
    start.record()
    dd.fused_frame_decode(**fused_args)
    end.record()
    torch.cuda.synchronize()
    fused_ms = start.elapsed_time(end)
    print(f"decode device program: {dev_ms:.1f} ms between events around "
          f"_dispatch_group ({group_host_ms:.1f} ms host wall, inputs "
          f"packed and uploaded; _group_inputs alone {pack_ms:.1f} ms on "
          f"the host, fused_frame_decode of inputs on the card {fused_ms:.1f}"
          f" ms between events); 132.4 ms with the scans (PERF.md)",
          flush=True)
    prof = profile_run(lambda: device_decoder.device_decompress(frame,
                                                                device=dev))
    if prof["busy_ms"] > 0:
        print(f"decode profile: wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['busy_ms']:.1f} ms, idle share "
              f"{1 - prof['busy_ms'] / prof['wall_ms']:.5f}", flush=True)
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:10]
        for name, ms in top:
            print(f"  {ms:9.3f} ms  {name[:100]}")
        # by kernel name, as PR 4's decode profile gave huf_decode_kernel
        # 8.682 ms and exec_seq_kernel 0.827 ms (PERF.md)
        for kern in ("huf_lane_kernel", "pool_host_kernel",
                     "exec_seq_kernel"):
            ms = sum(v for k, v in prof["by_name"].items() if kern in k)
            print(f"  {kern}: {ms:.4f} ms of device time", flush=True)
        # torch's cummax runs as a scan "with indices"
        scans = [k for k in prof["by_name"]
                 if "cummax" in k.lower() or "with_indices" in k]
        assert not scans, f"the decode still runs {scans}"
    else:
        print("decode profile: the profiler recorded no device activity; "
              "device busy time not measured", flush=True)

    # ---- error paths ------------------------------------------------------
    prefix = corpus[:PREFIX_BYTES]
    bad = underrun_frame(pipeline.compress(prefix, level=1, device=dev))
    for where in (dev, "cpu"):
        try:
            device_decoder.device_decompress(bad, device=where)
        except Corruption as e:
            assert "huffman stream over-read" in str(e), e
        else:
            raise AssertionError(f"under-run not detected on {where}")
    _, _, ok = device_decoder.device_decompress_resident(bad, device=dev)
    assert not bool(ok) and ok.error_kind() == "over-read"
    over = overrun_frame(pipeline.compress(prefix, level=1, device=dev))
    for where in (dev, "cpu"):
        try:
            device_decoder.device_decompress(over, device=where)
        except Corruption as e:
            assert "literal buffer overrun" in str(e), e
        else:
            raise AssertionError(f"literal overrun not refused on {where}")
    nframe = pipeline.compress(nested, level=1, device=dev)
    assert device_decoder.device_decompress(nframe, device=dev) == nested
    saved, dd.EXEC_ROUNDS = dd.EXEC_ROUNDS, 2
    try:
        _, n_out, ok = device_decoder.device_decompress_resident(nframe,
                                                                 device=dev)
        kind = ok.error_kind()
    finally:
        dd.EXEC_ROUNDS = saved
    assert n_out == len(nested) and not bool(ok) and kind == "exec-depth", \
        (bool(ok), kind)
    f_ck = pipeline.compress(prefix, level=1, checksum=True, device=dev)
    d_gpu = device_decoder.device_decompress(f_ck, device=dev)
    d_cpu = device_decoder.device_decompress(f_ck, device="cpu")
    assert d_gpu == d_cpu == prefix, "1 MiB prefix: cuda and cpu decodes"
    print("decode checks: under-run raises over-read and literal lengths past "
          "the literals raise literal buffer overrun on cuda and cpu; depth "
          "limit 2 gives exec-depth; 1 MiB checksum frame cuda == cpu",
          flush=True)

    # ---- fixture frames of other encoders -----------------------------------
    fdir = os.path.join(root, "tests", "data", "torch_decode")
    with open(os.path.join(fdir, "manifest.json")) as f:
        manifest = json.load(f)
    device_decoder.COUNTS["host_frames"] = 0
    for name, want in sorted(manifest.items()):
        with open(os.path.join(fdir, name), "rb") as f:
            got = device_decoder.device_decompress(f.read(), device=dev)
        assert len(got) == want["size"] and \
            hashlib.sha256(got).hexdigest() == want["sha256"], name
    print(f"decode fixtures: {len(manifest)} frames equal their digests "
          f"(host-decoded frames {device_decoder.COUNTS['host_frames']})",
          flush=True)

    return [
        dict(name="huf_decode", route="cuda",
             source="zstd_tpu_torch/csrc/huf_decode.cu",
             replaces="zstd_tpu/ops/decode_dev.py:59 and :93",
             launches=launches["huf_decode"], max_abs_err=err_h, ms=p_ms,
             plain_ms=p_plain_ms, bound_ms=h_bound, bound_by="bytes",
             library_ms=None),
        dict(name="exec_seq", route="cuda",
             source="zstd_tpu_torch/csrc/exec_seq.cu",
             replaces="zstd_tpu/ops/decode_dev.py:150",
             launches=launches["exec_seq"], max_abs_err=err_e, ms=e_ms,
             plain_ms=e_plain_ms, bound_ms=e_bound, bound_by="bytes",
             library_ms=None),
    ]


def lazy_phase(dev, corpus: bytes) -> list:
    """Phase 7: the lazy engine. The fused scoring-and-resolve kernel
    against its plain chain (lazy_mlen or capped_mlen, next_matchable,
    resolve_plain) in lazy mode on batch 0 at level 5 and on zero, period-4,
    random and short-valid_len rows, in v3 mode on batch 0 and the short
    rows, with its active steps a chunk, and on each of those slot sets the
    seqstore tail's kernels, seq_merge and seq_finish, against their plain
    torch ops (also at seq_cap 64 on lazy batch 0, where compact drops
    groups, and on rows of 262,144 and 9,001 B); each kernel's time, bound and its plain version's; each stage
    of the engine on batch 0; the 16 MiB level-5 encode (launches, rate,
    profile) and its A/B against the plain tail in this call; the 1 MiB
    prefix's frames at levels 5 and 9 (hash_log 21) and under the v3 engine
    against the CPU path, and the level-5 one decoded on the card. Returns
    the three kernels' entries of the kernels line."""
    import numpy as np
    import torch
    from zstd_tpu_torch import _kernels, device_decoder, pipeline
    from zstd_tpu_torch.ops import fastmatch as fm
    from zstd_tpu_torch.params import get_cparams

    cp = get_cparams(5, len(corpus))
    mls = min(max(cp.min_match, 4), 8)
    seq_cap = N_BLOCK // 8
    arr = np.frombuffer(corpus, np.uint8)

    def candidates(blocks, lens, mode="lazy"):
        """(tri words, candidate rows [R, B, n]) of an engine."""
        return fm.engine_rows(blocks, lens, cp.hash_log, mls, mode)

    # ---- kernel vs plain chain: batch 0 and synthetic rows ---------------
    rng = np.random.default_rng(0)
    b0 = torch.from_numpy(arr[:32 * N_BLOCK].reshape(32, N_BLOCK).copy()).to(dev)
    lens = torch.full((32,), N_BLOCK, dtype=torch.int32, device=dev)
    short = (b0[:2].contiguous(),
             torch.tensor([100_003, 77_777], dtype=torch.int32, device=dev))
    cases = {("lazy", "batch 0"): (b0, lens),
             ("lazy", "zero row"): np.zeros(N_BLOCK, np.uint8),
             ("lazy", "period-4 row"): np.tile(
                 rng.integers(0, 256, 4, dtype=np.uint8), N_BLOCK // 4),
             ("lazy", "random row"): rng.integers(0, 256, N_BLOCK,
                                                  dtype=np.uint8),
             ("lazy", "valid_len 100,003 and 77,777 rows"): short,
             ("v3", "batch 0"): (b0, lens),
             ("v3", "valid_len 100,003 and 77,777 rows"): short}
    err = 0
    tail_err = {"seq_merge": 0, "seq_finish": 0}

    def check_tail(blocks, tri, yp, yl, cand, c_lens, cap, label):
        """seq_merge and seq_finish against their plain versions on one
        set of slots (both finishes on the merged sequences, once the two
        merges agree)."""
        merged = fm.seq_merge(yp, yl, cand, blocks, tri, cap)
        torch.cuda.synchronize()
        want_m = fm.seq_merge_plain(yp, yl, cand, blocks, tri, cap)
        e_m = max_abs_err(merged, want_m)
        assert e_m == 0, f"seq_merge kernel disagrees with its plain ({label})"
        fin = fm.finish_sequences(blocks, tri, *merged, c_lens, cap)
        torch.cuda.synchronize()
        want_f = fm.finish_sequences_plain(blocks, tri, *merged, c_lens, cap)
        e_f = max_abs_err(tuple(fin[k] for k in SEQSTORE_KEYS),
                          tuple(want_f[k] for k in SEQSTORE_KEYS))
        print(f"  seq_merge, seq_finish {label} (seq_cap {cap}): max_abs_err "
              f"{e_m} (pos, len, dist, nb), {e_f} ({', '.join(SEQSTORE_KEYS)}"
              f"); nb_seq {merged[3].tolist()[:4]}, nb_lit "
              f"{fin['nb_lit'].tolist()[:4]}, overflow "
              f"{int(fin['overflow'].sum())} of {blocks.shape[0]} rows",
              flush=True)
        assert e_f == 0, f"seq_finish kernel disagrees with its plain ({label})"
        tail_err["seq_merge"] = max(tail_err["seq_merge"], e_m)
        tail_err["seq_finish"] = max(tail_err["seq_finish"], e_f)

    for (mode, name), case in cases.items():
        if not isinstance(case, tuple):
            case = (torch.from_numpy(case[None].copy()).to(dev), lens[:1])
        blocks, c_lens = case
        c_tri, rows = candidates(blocks, c_lens, mode)
        (yp, yl, cand), steps = fm.select_resolve_stats(blocks, rows, c_lens,
                                                        mode)
        torch.cuda.synchronize()
        want_steps = torch.empty_like(steps)
        want = fm.select_resolve_plain(blocks, rows, c_lens, mode, want_steps)
        e = max_abs_err((yp, yl, cand, steps), (*want, want_steps))
        print(f"lazy_resolve {mode} {name}: max_abs_err {e} (yp, yl, cand, "
              f"steps); most active steps a chunk {int(steps.max())} of "
              f"{fm.RESOLVE_STEPS}, {int((yl > 0).sum())} matches taken",
              flush=True)
        assert e == 0, f"lazy_resolve kernel disagrees with its plain ({name})"
        err = max(err, e)
        check_tail(blocks, c_tri, yp, yl, cand, c_lens, seq_cap,
                   f"{mode} {name}")
        if (mode, name) == ("lazy", "batch 0"):
            # the overflow case: compact drops groups past the cap
            check_tail(blocks, c_tri, yp, yl, cand, c_lens, 64,
                       f"{mode} {name}")
    # rows the main path never makes, for the kernels' other paths: 262,144
    # B (the groups and the row's bytes do not fit in shared memory: global
    # scratch) and 9,001 B (byte staging, unaligned rows, scalar lit_idx
    # stores), on the plain resolve's slots
    for n_odd, v_odd in ((2 * N_BLOCK, (2 * N_BLOCK, 200_001)),
                         (9001, (9001, 8901))):
        blocks = torch.from_numpy(arr[:2 * n_odd].reshape(2, n_odd).copy()
                                  ).to(dev)
        c_lens = torch.tensor(v_odd, dtype=torch.int32, device=dev)
        c_tri, rows = candidates(blocks, c_lens)
        slots = fm.select_resolve_plain(blocks, rows, c_lens, "lazy")
        check_tail(blocks, c_tri, *slots, c_lens, n_odd // 8,
                   f"lazy rows of {n_odd} B, valid_len {v_odd}")
    tri, rows = candidates(b0, lens)
    r_args = (b0, rows, lens, "lazy")
    r_ms = cuda_ms(lambda: fm.select_resolve(*r_args))
    r_plain_ms = host_ms(lambda: fm.select_resolve_plain(*r_args))
    r_plain_dev = graph_ms(lambda: fm.select_resolve_plain(*r_args))
    yp, yl, cand = fm.select_resolve(*r_args)
    # each input read once, each output written once
    r_bytes = nbytes(b0, rows, lens, yp, yl, cand)
    r_bound = r_bytes / HBM_BYTES_PER_S * 1e3
    print(f"lazy_resolve lazy batch 0: kernel {r_ms:.4f} ms, bound "
          f"{r_bound * 1e3:.2f} us ({r_bytes} B: blocks, 10 candidate rows, "
          f"valid_lens read, yp, yl, cand written); plain chain (lazy_mlen, "
          f"next_matchable, resolve_plain) {r_plain_dev:.4f} ms device (CUDA "
          f"graph), {r_plain_ms:.1f} ms host wall", flush=True)
    v_rows = candidates(b0, lens, "v3")[1]
    v_args = (b0, v_rows, lens, "v3")
    v_ms = cuda_ms(lambda: fm.select_resolve(*v_args))
    v_plain_ms = host_ms(lambda: fm.select_resolve_plain(*v_args))
    vy = fm.select_resolve(*v_args)
    v_bytes = nbytes(b0, v_rows, lens, *vy[:2])
    print(f"lazy_resolve v3 batch 0: kernel {v_ms:.4f} ms, bound "
          f"{v_bytes / HBM_BYTES_PER_S * 1e6:.2f} us ({v_bytes} B), plain "
          f"chain {v_plain_ms:.1f} ms host wall", flush=True)

    # ---- the seqstore tail's kernels on batch 0 ------------------------------
    m_args = (yp, yl, cand, b0, tri, seq_cap)
    merged = fm.seq_merge(*m_args)
    f_args = (b0, tri, *merged, lens, seq_cap)
    fin = fm.finish_sequences(*f_args)
    # each input read once, each output written once (the kernels read the
    # bytes, not the tri words; nb_seq passes through finish_sequences)
    tail = {
        "seq_merge": (lambda: fm.seq_merge(*m_args),
                      lambda: fm.seq_merge_plain(*m_args),
                      nbytes(yp, yl, cand, b0, *merged),
                      "yp, yl, cand, blocks read; pos, len, dist, nb "
                      "written"),
        "seq_finish": (lambda: fm.finish_sequences(*f_args),
                       lambda: fm.finish_sequences_plain(*f_args),
                       nbytes(b0, *merged, lens,
                              *(fin[k] for k in SEQSTORE_KEYS[1:])),
                       "blocks, pos, len, dist, nb, valid_lens read; ll, "
                       "off, ml, lit_idx, nb_lit, overflow written"),
    }
    tail_ms = {}
    for name, (kernel, plain, nb_, what) in tail.items():
        k_ms = cuda_ms(kernel)
        p_dev = graph_ms(plain)
        p_host = min(host_ms(plain) for _ in range(3))
        bound = nb_ / HBM_BYTES_PER_S * 1e3
        tail_ms[name] = (k_ms, p_host, bound)
        print(f"{name} lazy batch 0: kernel {k_ms:.4f} ms, bound "
              f"{bound * 1e3:.2f} us ({nb_} B: {what}), {k_ms / bound:.1f}x "
              f"the bound; plain torch ops {p_dev:.4f} ms device (CUDA "
              f"graph), {p_host:.2f} ms host wall (best of 3)", flush=True)

    # ---- the engine's stages on batch 0 ------------------------------------
    stages = {
        "tri_arrays + 2 hashes + 10 candidate rows":
            lambda: candidates(b0, lens),
        "select_resolve (kernel: lengths, gains, deferral, nxt, walk)":
            lambda: fm.select_resolve(*r_args),
        "seq_merge (kernel: compact, rep_rewrite, merge_chains)":
            lambda: fm.seq_merge(*m_args),
        "finish_sequences (kernel: extension, fields, literals)":
            lambda: fm.finish_sequences(*f_args),
        "stage A (_analyze, lazy)": lambda: pipeline._analyze(
            b0, lens, cp.hash_log, mls, seq_cap, "lazy"),
        "stage A with the plain tail": lambda: plain_tail_call(
            pipeline._analyze, b0, lens, cp.hash_log, mls, seq_cap, "lazy"),
    }
    # the torch-op stages are hundreds of small launches, enqueued slower
    # than the card runs them: device time (a CUDA graph's replay) and host
    # wall of one eager call apart
    stage_ms = {name: graph_ms(fn) for name, fn in stages.items()}
    wall_ms = {name: min(host_ms(fn) for _ in range(3))
               for name, fn in stages.items()}
    print("lazy engine stages, batch 0 (ms device / ms host wall of one "
          "eager call, best of 3): "
          + ", ".join(f"{k} {stage_ms[k]:.4f} / {wall_ms[k]:.2f}"
                      for k in stages), flush=True)
    print(f"  nb_seq (first 8 blocks) {merged[3][:8].tolist()}", flush=True)

    # ---- the main path at level 5 -----------------------------------------
    pipeline.compress(corpus, level=5, device=dev)            # warm
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    times = []
    t0 = time.perf_counter()
    frame = pipeline.compress(corpus, level=5, device=dev)
    times.append(time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    frame2 = pipeline.compress(corpus, level=5, device=dev)
    times.append(time.perf_counter() - t0)
    assert frame2 == frame, "two level-5 runs gave different frames"
    if len(corpus) == CORPUS_BYTES:
        assert len(frame) == LEVEL5_FRAME_BYTES, len(frame)
    print(f"level 5: {len(corpus)} B -> {len(frame)} B, ratio "
          f"{len(corpus) / len(frame):.4f}, "
          f"{len(corpus) / min(times) / 1e6:.2f} MB/s (best of 2: "
          f"{times[0]:.3f} s, {times[1]:.3f} s), launches {launches}",
          flush=True)
    for k in ("lazy_resolve", "fse_chain", "seq_merge", "seq_finish"):
        assert launches[k] > 0, f"kernel {k} was not launched at level 5"
    batches = -(-len(corpus) // (32 * N_BLOCK))
    for k in ("seq_merge", "seq_finish"):
        assert launches[k] == batches, (k, launches[k], batches)
    assert frame_blocks(frame) == len(corpus) // N_BLOCK
    stage_mbps = pipeline.TorchCompressor(
        level=5, device=dev).device_stage_mbps(corpus)
    print(f"level 5 device_stage_mbps: {stage_mbps:.2f}", flush=True)
    profiled_encode(pipeline, dev, corpus, 5)

    # ---- A/B in this call: the tail's kernels against its plain torch ops,
    # in the order plain, kernels, kernels, plain ----------------------------
    def encode():
        return pipeline.compress(corpus, level=5, device=dev)

    plain_tail_call(encode)                                   # warm
    legs = {"plain tail": [], "kernels": []}
    for leg in ("plain tail", "kernels", "kernels", "plain tail"):
        run = encode if leg == "kernels" else \
            (lambda: plain_tail_call(encode))
        t0 = time.perf_counter()
        out = run()
        legs[leg].append(time.perf_counter() - t0)
        assert out == frame, f"level 5 with the {leg}: the frame differs"
    mbps = {leg: len(corpus) / min(t) / 1e6 for leg, t in legs.items()}
    comp5 = pipeline.TorchCompressor(level=5, device=dev)
    dsm = {"plain tail": plain_tail_call(comp5.device_stage_mbps, corpus),
           "kernels": comp5.device_stage_mbps(corpus)}
    print("level 5 A/B (plain, kernels, kernels, plain): " + "; ".join(
        f"{leg} {mbps[leg]:.2f} MB/s (best of "
        f"{', '.join(f'{t:.3f}' for t in legs[leg])} s), device_stage_mbps "
        f"{dsm[leg]:.2f}" for leg in legs)
        + f"; frames equal ({len(frame)} B)", flush=True)
    profiled_encode(pipeline, dev, corpus, 5,
                    encode=lambda: plain_tail_call(encode),
                    label="level 5, plain tail")
    profiled_encode(pipeline, dev, corpus, 5, encode=encode,
                    label="level 5, kernels")
    t0 = time.perf_counter()
    assert device_decoder.device_decompress(frame, device=dev) == corpus, \
        "level-5 frame: device decode differs"
    print(f"level-5 frame ({len(frame)} B) decoded on the card by "
          f"device_decompress in {time.perf_counter() - t0:.3f} s: == corpus",
          flush=True)

    # ---- the 1 MiB prefix: cuda == cpu, and decoded on the card ---------
    prefix = corpus[:PREFIX_BYTES]
    for level, engine in ((5, None), (9, None), (3, "v3")):
        f_gpu = pipeline.compress(prefix, level=level, checksum=True,
                                  device=dev, engine=engine)
        f_cpu = pipeline.compress(prefix, level=level, checksum=True,
                                  device="cpu", engine=engine)
        hl = get_cparams(level, len(prefix)).hash_log
        assert f_gpu == f_cpu, \
            f"level {level}, engine {engine}: cuda and cpu frames differ"
        print(f"1 MiB prefix, level {level}, engine {engine or 'lazy'} "
              f"(hash_log {hl}): cuda frame == cpu frame ({len(f_gpu)} B)",
              flush=True)
        if level == 5:
            out = device_decoder.device_decompress(f_gpu, device=dev)
            assert out == prefix, "level-5 frame: device decode differs"
            print("  decoded on the card by device_decompress: == prefix",
                  flush=True)

    return [
        dict(name="lazy_resolve", route="cuda",
             source="zstd_tpu_torch/csrc/lazy_resolve.cu",
             replaces="zstd_tpu/ops/fastmatch.py:179, :429, :493-529, :172",
             launches=launches["lazy_resolve"], max_abs_err=err, ms=r_ms,
             plain_ms=r_plain_ms, bound_ms=r_bound, bound_by="bytes",
             library_ms=None),
        dict(name="seq_merge", route="cuda",
             source="zstd_tpu_torch/csrc/seq_merge.cu",
             replaces="zstd_tpu/ops/fastmatch.py:202, :241, :276",
             launches=launches["seq_merge"],
             max_abs_err=tail_err["seq_merge"], ms=tail_ms["seq_merge"][0],
             plain_ms=tail_ms["seq_merge"][1],
             bound_ms=tail_ms["seq_merge"][2], bound_by="bytes",
             library_ms=None),
        dict(name="seq_finish", route="cuda",
             source="zstd_tpu_torch/csrc/seq_finish.cu",
             replaces="zstd_tpu/ops/fastmatch.py:320",
             launches=launches["seq_finish"],
             max_abs_err=tail_err["seq_finish"], ms=tail_ms["seq_finish"][0],
             plain_ms=tail_ms["seq_finish"][1],
             bound_ms=tail_ms["seq_finish"][2], bound_by="bytes",
             library_ms=None),
    ]


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def xla_phase(dev, corpus: bytes) -> dict:
    """Phase 8: the xla engine and the one-frame sharded encode. The xla_walk
    kernel (`seqextract.xla_extract`: the greedy walk of capped matches,
    their backward extension, the seqstore and the literal index in one
    launch) against its plain chain `xla_extract_plain` on level-1 batch 0
    (also at seq_cap 64, where every row overflows), on the sharded rows of
    the corpus's first 32 blocks and of all its blocks, as compress_sharded
    launches them on one rank (64 KiB halo + 128 KiB block, row 0's halo
    fabricated), on zero, period-8, random and short-valid_len rows, on
    rows whose emit_from is valid_len - 12 and on rows of 393,216 B (a
    256 KiB halo: read from device memory) (all seven keys, max_abs_err
    0, at the CTAs a row the wrapper chooses and at each of 2, 3 and 4);
    its counts per row against tests/xlaextractmodel.py on six rows; its
    time at each CTA count, bound, the plain chain's host wall and the
    device time of the torch ops of the emit it took over (a CUDA graph's
    replay) on batch 0, both sets of sharded rows and the 393,216-B rows
    (8 rows: one wave at every CTA count); the 16 MiB
    level-1 encode under engine="xla" (launches, rate) and its 1 MiB prefix
    cuda == cpu; parallel.zstdmt.compress_sharded in an NCCL group of one
    rank (its 1 MiB prefix against a gloo group on the CPU, the 16 MiB
    frame decoded on the card). Returns the kernel's entry of the kernels
    line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from xlaextractmodel import extract_row
    from zstd_tpu_torch import _kernels, device_decoder, pipeline
    from zstd_tpu_torch.ops import match as tm
    from zstd_tpu_torch.ops import seqextract as ts
    from zstd_tpu_torch.parallel import shard_compress, zstdmt
    from zstd_tpu_torch.params import get_cparams

    cp = get_cparams(1, len(corpus))
    mls = min(max(cp.min_match, 4), 8)
    arr = np.frombuffer(corpus, np.uint8)
    halo = zstdmt.overlap_size(cp.strategy, cp.window_log)
    rng = np.random.default_rng(0)
    keys = ("nb_seq", "ll", "off", "ml", "lit_idx", "nb_lit", "overflow")

    def case(rows, vls, efs, hoks, cap):
        blocks = torch.from_numpy(np.stack(rows)).to(dev)
        vl = torch.tensor(vls, dtype=torch.int32, device=dev)
        ef = torch.tensor(efs, dtype=torch.int32, device=dev)
        hok = torch.tensor(hoks, device=dev)
        cands = tm.banned_candidates(blocks, vl, cp.hash_log, mls, ef,
                                     hok).contiguous()
        return blocks, cands, vl, ef, hok, cap

    cap1 = N_BLOCK // 8
    n_sh = halo + N_BLOCK
    b0 = [arr[i * N_BLOCK:(i + 1) * N_BLOCK] for i in range(32)]
    # the sharded rows as compress_sharded builds them on one rank: block
    # j behind the last `halo` bytes of block j - 1; row 0 behind the last
    # row's tail, a fabricated halo (banned)
    n_all = len(corpus) // N_BLOCK
    blk = [arr[i * N_BLOCK:(i + 1) * N_BLOCK] for i in range(n_all)]
    sh_all = [np.concatenate([blk[j - 1][-halo:], blk[j]])
              for j in range(n_all)]
    sh = [np.concatenate([b0[j - 1][-halo:], b0[j]]) for j in range(32)]
    short = [arr[40 * N_BLOCK:41 * N_BLOCK], arr[41 * N_BLOCK:42 * N_BLOCK]]
    cases = {
        "batch 0": case(b0, [N_BLOCK] * 32, [0] * 32, [True] * 32, cap1),
        f"sharded rows (n = {n_sh})": case(
            sh, [n_sh] * 32, [halo] * 32, [False] + [True] * 31,
            N_BLOCK // 4),
        f"compress_sharded's {n_all} rows": case(
            sh_all, [n_sh] * n_all, [halo] * n_all,
            [False] + [True] * (n_all - 1), N_BLOCK // 4),
        "batch 0 at seq_cap 64": case(b0, [N_BLOCK] * 32, [0] * 32,
                                      [True] * 32, 64),
        "zero row": case([np.zeros(N_BLOCK, np.uint8)], [N_BLOCK], [0],
                         [True], cap1),
        "period-8 row": case([np.tile(rng.integers(0, 256, 8, dtype=np.uint8),
                                      N_BLOCK // 8)], [N_BLOCK], [0], [True],
                             cap1),
        "random row": case([rng.integers(0, 256, N_BLOCK, dtype=np.uint8)],
                           [N_BLOCK], [0], [True], cap1),
        "valid_len 100,003 and 77,777 rows": case(
            short, [100_003, 77_777], [0, 0], [True, True], cap1),
        "emit_from = valid_len - 12 rows": case(
            short, [100_003, 77_777], [100_003 - 12, 77_777 - 12],
            [True, False], cap1),
        # rows of a level-5 shard (a 256 KiB halo), too long for a CTA's
        # shared memory: the kernel reads them from device memory
        f"rows of n = {3 * N_BLOCK}": case(
            [arr[j * N_BLOCK:(j + 3) * N_BLOCK] for j in range(8)],
            [3 * N_BLOCK] * 8, [2 * N_BLOCK] * 8, [True] * 8, N_BLOCK // 4),
    }
    # rows whose kernel counts are held to the model: (case, row)
    model_rows = [("batch 0", 0), ("batch 0", 1), ("zero row", 0),
                  ("valid_len 100,003 and 77,777 rows", 1),
                  (f"sharded rows (n = {n_sh})", 0),
                  (f"rows of n = {3 * N_BLOCK}", 0)]
    err = 0
    for name, args in cases.items():
        got, st = ts.xla_extract_stats(*args)
        torch.cuda.synchronize()
        want = ts.xla_extract_plain(*args)
        e = max_abs_err(tuple(got[k] for k in keys),
                        tuple(want[k] for k in keys))
        # every instantiation the wrapper may choose, held to the plain too
        e_by = []
        for c in ts.CTAS:
            got_c, _ = ts.xla_extract_stats(*args, ctas=c)
            e_by.append(max_abs_err(tuple(got_c[k] for k in keys),
                                    tuple(want[k] for k in keys)))
        s = st.long()
        slow = int(s[:, 9].argmax())
        print(f"xla_walk {name}: max_abs_err {e} (seven keys; with "
              f"{int(s[0, 8])} CTAs a row, the wrapper's choice; "
              f"with 2, 3, 4: "
              f"{', '.join(map(str, e_by))}); nb_seq "
              f"{int(s[:, 0].min())}-{int(s[:, 0].max())}, overflow "
              f"{int(got['overflow'].sum())} rows; slowest row {slow}: "
              + ", ".join(f"{k} {v}" for k, v in zip(ts.XLA_STATS,
                                                     s[slow].tolist())),
              flush=True)
        assert e == 0 and max(e_by) == 0, \
            f"xla_walk kernel disagrees with its plain ({name})"
        err = max(err, e, *e_by)
        for mname, r in model_rows:
            if mname != name:
                continue
            _, counts = extract_row(
                args[0][r].cpu().numpy(), args[1][r].cpu().numpy(),
                int(args[2][r]), int(args[3][r]), bool(args[4][r]), args[5],
                32 * int(s[r, 8]))
            kc = dict(zip(ts.XLA_STATS, s[r].tolist()))
            print(f"  row {r}: kernel counts == tests/xlaextractmodel.py's: "
                  f"{counts}", flush=True)
            assert all(kc[k] == v for k, v in counts.items()), \
                f"xla_walk counts differ from the model ({name}, row {r}): {kc}"
    lib = _kernels.get("xla_walk.cu")
    print(f"xla_walk clusters the card holds at once, by CTAs a row 2, 3, 4: "
          f"{[lib.xla_walk_max_clusters(N_BLOCK, c) for c in ts.CTAS]}",
          flush=True)
    timing = {}
    for name in ("batch 0", f"sharded rows (n = {n_sh})",
                 f"compress_sharded's {n_all} rows",
                 f"rows of n = {3 * N_BLOCK}"):
        args = cases[name]
        B, n = args[0].shape
        out = ts.xla_extract(*args)
        ms = cuda_ms(lambda: ts.xla_extract(*args))
        plain = host_ms(lambda: ts.xla_extract_plain(*args))
        com, take = tm.xla_walk_plain(*args[:4])
        emit_ms = graph_ms(lambda: ts.xla_emit_plain(*args, com, take))
        # each input read once, each output written once
        nb = nbytes(*args[:5], *out.values())
        timing[name] = (ms, plain, nb / HBM_BYTES_PER_S * 1e3)
        by_ctas = [cuda_ms(lambda: ts.xla_extract_stats(*args, ctas=c))
                   for c in ts.CTAS]
        print(f"xla_walk {name}: kernel {ms:.4f} ms ({ts.xla_ctas(B, n, dev)} "
              f"CTAs a row), plain chain {plain:.1f} ms host wall, bound "
              f"{nb / HBM_BYTES_PER_S * 1e6:.2f} us ({nb} B: blocks, cands, "
              f"valid_lens, emit_from, halo_ok read; the seven outputs "
              f"written); the torch ops of the emit it took over: "
              f"{emit_ms:.4f} ms device (CUDA graph); with 2, 3, 4 CTAs a row "
              f"(and the stats): "
              + ", ".join(f"{t:.4f}" for t in by_ctas) + " ms", flush=True)

    # ---- the pipeline under engine="xla": 16 MiB, level 1 ----------------
    prefix = corpus[:PREFIX_BYTES]
    f_gpu = pipeline.compress(prefix, level=1, checksum=True, device=dev,
                              engine="xla")
    f_cpu = pipeline.compress(prefix, level=1, checksum=True, device="cpu",
                              engine="xla")
    assert f_gpu == f_cpu, "xla engine: cuda and cpu frames of 1 MiB differ"
    print(f"1 MiB prefix, engine xla: cuda frame == cpu frame "
          f"({len(f_gpu)} B)", flush=True)
    pipeline.compress(corpus, level=1, device=dev, engine="xla")   # warm
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    times = []
    t0 = time.perf_counter()
    frame = pipeline.compress(corpus, level=1, device=dev, engine="xla")
    times.append(time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    frame2 = pipeline.compress(corpus, level=1, device=dev, engine="xla")
    times.append(time.perf_counter() - t0)
    assert frame2 == frame, "two xla-engine runs gave different frames"
    print(f"engine xla, level 1: {len(corpus)} B -> {len(frame)} B, ratio "
          f"{len(corpus) / len(frame):.4f}, "
          f"{len(corpus) / min(times) / 1e6:.2f} MB/s (best of 2: "
          f"{times[0]:.3f} s, {times[1]:.3f} s), launches {launches}",
          flush=True)
    for k in ("xla_walk", "fse_chain"):
        assert launches[k] > 0, f"kernel {k} was not launched under xla"
    assert launches["extract"] == 0, "the extract kernel ran under xla"
    assert frame_blocks(frame) == len(corpus) // N_BLOCK
    stage_mbps = pipeline.TorchCompressor(
        level=1, device=dev, engine="xla").device_stage_mbps(corpus)
    print(f"engine xla device_stage_mbps: {stage_mbps:.2f}", flush=True)
    profiled_encode(pipeline, dev, corpus, 1, label="engine xla, level 1",
                    encode=lambda: pipeline.compress(corpus, level=1,
                                                     device=dev,
                                                     engine="xla"))

    # ---- compress_sharded in an NCCL group of one rank ---------------------
    grp = shard_compress.init_group(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        cpu_grp = shard_compress.make_group(
            device="cpu", pg=dist.new_group(backend="gloo"))
        s_gpu = zstdmt.compress_sharded(prefix, level=1, checksum=True,
                                        group=grp)
        s_cpu = zstdmt.compress_sharded(prefix, level=1, checksum=True,
                                        group=cpu_grp)
        assert s_gpu == s_cpu, "compress_sharded: cuda and cpu frames differ"
        print(f"1 MiB prefix, compress_sharded: nccl frame == gloo/cpu frame "
              f"({len(s_gpu)} B)", flush=True)
        zstdmt.compress_sharded(corpus, level=1, group=grp)         # warm
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        s_times = []
        t0 = time.perf_counter()
        s_frame = zstdmt.compress_sharded(corpus, level=1, group=grp)
        s_times.append(time.perf_counter() - t0)
        s_launches = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        s_frame2 = zstdmt.compress_sharded(corpus, level=1, group=grp)
        s_times.append(time.perf_counter() - t0)
        profiled_encode(pipeline, dev, corpus, 1, label="compress_sharded",
                        encode=lambda: zstdmt.compress_sharded(
                            corpus, level=1, group=grp))
    finally:
        dist.destroy_process_group()
    assert s_frame2 == s_frame, "two compress_sharded runs differ"
    for k in ("xla_walk", "fse_chain"):
        assert s_launches[k] > 0, f"kernel {k} was not launched sharded"
    print(f"compress_sharded, level 1, one rank (halo {halo}): {len(corpus)} B "
          f"-> {len(s_frame)} B, ratio {len(corpus) / len(s_frame):.4f}, "
          f"{len(corpus) / min(s_times) / 1e6:.2f} MB/s (best of 2: "
          f"{s_times[0]:.3f} s, {s_times[1]:.3f} s), launches {s_launches}",
          flush=True)
    t0 = time.perf_counter()
    out = device_decoder.device_decompress(s_frame, device=dev)
    assert out == corpus, "the sharded frame does not decode to the corpus"
    print(f"  decoded on the card by device_decompress: == corpus "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    ms, plain, bound = timing["batch 0"]
    return dict(name="xla_walk", route="cuda",
                source="zstd_tpu_torch/csrc/xla_walk.cu",
                replaces="zstd_tpu/ops/match.py:100 and :174; "
                         "zstd_tpu/ops/seqextract.py:45-97",
                launches=launches["xla_walk"], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=None)


def ldm_phase(dev) -> list:
    """Phase 9: the sharded long-distance matcher in an NCCL group of one
    rank (a gloo subgroup for the CPU leg). The ldm_fingerprint kernel
    against `anchor_keys_plain` on 4 MiB of big_corpus, 1 MiB of zeros and
    of random bytes, the two edge layouts at world 1 (valid = m and valid =
    m - 56) and the 64 MiB long corpus's chunk; the ldm_lookback kernel
    against `lookback_plain` on the sorted entries of that discovery and on
    an input whose anchors pass cap in one owner (max_abs_err 0). Discovery
    of the 64 MiB long corpus (tests/longcorpus.py): its anchors against the
    port's host LdmState, anchors, candidates and find_long_matches of every
    block against the port's own run on the CPU (gloo, plain versions), and
    the blocks whose long matches differ from the host LdmState's (printed,
    not asserted: the 12-deep look-back can miss host candidates); both
    kernels' times (CUDA events) beside their byte bounds and their plain
    versions' device times; the discovery's device profile by kernel name.
    compress_long_sharded at levels 1 and 3, long_log 27: the 4 MiB
    prefix's NCCL frame against the gloo frame; the 16 MiB frame (size,
    ratio, MB/s best of 2, the host split with the level's gap parser, the
    launches) decoded on the card; at level 19 (the DP gap parse and the
    seqstore splitting), on 2 MiB of the long corpus with a 512 KiB segment,
    the NCCL frame against the gloo frame, its MB/s and launches, decoded on
    the card. Both kernels launch
    once in each level's run. Returns the two kernels' entries of the
    kernels line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigcorpus import big_corpus
    from longcorpus import long_corpus
    from zstd_tpu_torch import _kernels, device_decoder
    from zstd_tpu_torch.format import block as tblock
    from zstd_tpu_torch.format import ldm as tldm
    from zstd_tpu_torch.ops import ldm as tops
    from zstd_tpu_torch.parallel import ldm_sharded, shard_compress

    data = long_corpus(LONG_BYTES)
    full = np.frombuffer(data, np.uint8)
    wlog = max(20, min(27, (len(data) - 1).bit_length()))
    window = 1 << wlog

    def chunk_of(arr, world=1, rank=0):
        """rank's chunk of arr at `world`, on the card, and its layout."""
        lay = ldm_sharded.layout(len(arr), world, window)
        m, a = lay["m"], rank * lay["m"]
        ext = np.zeros(m + tops.SPAN, np.uint8)
        piece = arr[a:a + m + tops.SPAN]
        ext[:len(piece)] = piece
        valid = min(max(lay["n_pos"] - a, 0), m)
        return torch.from_numpy(ext).to(dev), valid, lay

    # ---- kernel 7 vs plain ------------------------------------------------
    rng = np.random.default_rng(9)
    big = np.frombuffer(big_corpus(4 * 1024 * 1024), np.uint8)
    fp_cases = {
        "4 MiB of big_corpus": chunk_of(big),
        "1 MiB of zeros": chunk_of(np.zeros(1 << 20, np.uint8)),
        "1 MiB of random bytes": chunk_of(rng.integers(0, 256, 1 << 20,
                                                       dtype=np.uint8)),
        "valid = m": chunk_of(full[:(1 << 20) + 63]),
        "valid = m - 56": chunk_of(full[:(1 << 20) + 63 - 56]),
        f"the {LONG_BYTES >> 20} MiB long corpus": chunk_of(full),
    }
    err7 = 0
    for name, (ext, valid, lay) in fp_cases.items():
        got = tops.anchor_keys(ext, valid)
        torch.cuda.synchronize()
        e = max_abs_err(got, tops.anchor_keys_plain(ext, valid))
        print(f"ldm_fingerprint {name}: m {lay['m']}, valid {valid}, anchors "
              f"{int(got[0].sum())}, max_abs_err {e}", flush=True)
        assert e == 0, f"ldm_fingerprint disagrees with its plain ({name})"
        err7 = max(err7, e)
    assert fp_cases["valid = m"][1] == fp_cases["valid = m"][2]["m"]
    assert fp_cases["valid = m - 56"][1] == \
        fp_cases["valid = m - 56"][2]["m"] - 56

    # ---- the group: NCCL on the card, a gloo subgroup for the CPU leg -----
    grp = shard_compress.init_group(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        cpu_grp = shard_compress.make_group(
            device="cpu", pg=dist.new_group(backend="gloo"))
        ext, valid, lay = fp_cases[f"the {LONG_BYTES >> 20} MiB long corpus"]
        bs, cap = lay["block_size"], lay["cap"]

        # ---- kernel 8 vs plain --------------------------------------------
        entries = ldm_sharded.owner_entries_of(ext, valid, 0, grp, cap)
        period = np.tile(np.random.default_rng(0).integers(
            0, 256, 16, dtype=np.uint8), 4096)           # one anchor a period
        p_ext, p_valid, p_lay = chunk_of(period)
        p_flag = tops.anchor_keys(p_ext, p_valid)[0]
        assert int(p_flag.sum()) > p_lay["cap"], "no owner passes cap"
        p_entries = ldm_sharded.owner_entries_of(p_ext, p_valid, 0, grp,
                                                 p_lay["cap"])
        err8 = 0
        for name, ent, b in ((f"the {LONG_BYTES >> 20} MiB discovery",
                              entries, bs),
                             (f"a period-16 input ({int(p_flag.sum())} "
                              f"anchors, cap {p_lay['cap']})", p_entries,
                              p_lay["block_size"])):
            got = tops.lookback(ent, b, window)
            torch.cuda.synchronize()
            e = max_abs_err(got, tops.lookback_plain(ent, b, window))
            print(f"ldm_lookback {name}: {ent.numel()} entries, "
                  f"{int((got[0] >= 0).sum())} anchors, "
                  f"{int((got[1] >= 0).sum())} candidates, max_abs_err {e}",
                  flush=True)
            assert e == 0, f"ldm_lookback disagrees with its plain ({name})"
            err8 = max(err8, e)

        # ---- timings: kernels, plain versions, bounds ----------------------
        t7 = cuda_ms(lambda: tops.anchor_keys(ext, valid))
        p7 = cuda_ms(lambda: tops.anchor_keys_plain(ext, valid), reps=2)
        # ext read once, the flag (1 B) and the key (4 B) written
        b7 = (ext.numel() + 5 * lay["m"]) / HBM_BYTES_PER_S * 1e3
        t8 = cuda_ms(lambda: tops.lookback(entries, bs, window))
        p8 = cuda_ms(lambda: tops.lookback_plain(entries, bs, window), reps=2)
        # 8 B an entry read, pos (4 B) and 4 candidates (16 B) written
        b8 = entries.numel() * 28 / HBM_BYTES_PER_S * 1e3
        print(f"ldm_fingerprint: kernel {t7:.4f} ms, plain {p7:.4f} ms "
              f"device, bound {b7 * 1e3:.2f} us ({lay['m']} positions)",
              flush=True)
        print(f"ldm_lookback: kernel {t8:.4f} ms, plain {p8:.4f} ms device, "
              f"bound {b8 * 1e3:.2f} us ({entries.numel()} entries)",
              flush=True)

        # ---- discovery of the long corpus at world 1 -----------------------
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        d_ms = host_ms(lambda: ldm_sharded.discover(
            ext, valid, 0, grp, cap, bs, window))
        st = ldm_sharded.ShardedLdmState(full, wlog, group=grp)
        host = tldm.LdmState(full, wlog)
        assert np.array_equal(st.anchors, host.anchors), \
            "discovery: anchors differ from the host LdmState's"
        t0 = time.perf_counter()
        cpu = ldm_sharded.ShardedLdmState(full, wlog, group=cpu_grp)
        cpu_s = time.perf_counter() - t0
        assert np.array_equal(st.anchors, cpu.anchors) \
            and np.array_equal(st.cands, cpu.cands), \
            "discovery: nccl and gloo/cpu states differ"
        n, blocks, vs_host = len(full), 0, 0
        for b0 in range(0, n, bs):
            b1 = min(b0 + bs, n)
            mine = st.find_long_matches(b0, b1)
            assert mine == cpu.find_long_matches(b0, b1), \
                f"find_long_matches differ cuda/cpu at block {b0 // bs}"
            host.insert_upto(b0)
            vs_host += mine != host.find_long_matches(b0, b1)
            blocks += 1
        print(f"{LONG_BYTES >> 20} MiB discovery (window 2^{wlog}, m "
              f"{lay['m']}, cap {cap}): "
              f"{len(st.anchors)} anchors == host LdmState's; anchors, "
              f"candidates and find_long_matches of {blocks} blocks: nccl == "
              f"gloo/cpu (cpu run {cpu_s:.1f} s); blocks whose long matches "
              f"differ from the host LdmState's: {vs_host}; discover() on the "
              f"card {d_ms:.2f} ms host wall", flush=True)
        prof = profile_run(lambda: ldm_sharded.discover(
            ext, valid, 0, grp, cap, bs, window))
        print(f"discovery profile: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms", flush=True)
        for kern in ("ldm_fingerprint_kernel", "ldm_lookback_kernel"):
            ms = sum(v for k, v in prof["by_name"].items() if kern in k)
            print(f"  {kern}: {ms:.4f} ms of device time", flush=True)
        for name, ms in sorted(prof["by_name"].items(),
                               key=lambda kv: -kv[1])[:10]:
            print(f"  {ms:9.4f} ms  {name[:100]}")

        # ---- compress_long_sharded, level 1, long_log 27 -------------------
        prefix = data[:LONG_PREFIX_BYTES]
        f_gpu = ldm_sharded.compress_long_sharded(prefix, level=1,
                                                  checksum=True, group=grp)
        f_cpu = ldm_sharded.compress_long_sharded(prefix, level=1,
                                                  checksum=True,
                                                  group=cpu_grp)
        assert f_gpu == f_cpu, "compress_long_sharded: nccl != gloo frame"
        print(f"{LONG_PREFIX_BYTES >> 20} MiB prefix, compress_long_sharded: "
              f"nccl frame == gloo/cpu "
              f"frame ({len(f_gpu)} B)", flush=True)
        corpus = data[:LONG_FRAME_BYTES]
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        split = timed_calls([
            (ldm_sharded.ShardedLdmState, "__init__", "discovery"),
            (ldm_sharded.ShardedLdmState, "find_long_matches",
             "find_long_matches"),
            (tldm, "find_sequences_fast", "gap parse"),
            (tblock, "compress_literals", "literals"),
            (tblock, "write_sequences_section", "sequences")])
        times = []
        with split:
            t0 = time.perf_counter()
            frame = ldm_sharded.compress_long_sharded(corpus, level=1,
                                                      group=grp)
            times.append(time.perf_counter() - t0)
        launches = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        frame2 = ldm_sharded.compress_long_sharded(corpus, level=1, group=grp)
        times.append(time.perf_counter() - t0)
        prof = profile_run(lambda: ldm_sharded.compress_long_sharded(
            corpus, level=1, group=grp))

        # ---- level 3: the chain-lazy gap parse ------------------------------
        f3 = [ldm_sharded.compress_long_sharded(prefix, level=3,
                                                checksum=True, group=g)
              for g in (grp, cpu_grp)]
        assert f3[0] == f3[1], "compress_long_sharded level 3: nccl != gloo"
        print(f"{LONG_PREFIX_BYTES >> 20} MiB prefix, compress_long_sharded "
              f"level 3: nccl frame == gloo/cpu frame ({len(f3[0])} B)",
              flush=True)
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        split3 = timed_calls([
            (ldm_sharded.ShardedLdmState, "__init__", "discovery"),
            (ldm_sharded.ShardedLdmState, "find_long_matches",
             "find_long_matches"),
            (tldm, "find_sequences_chainlazy", "gap parse"),
            (tblock, "compress_literals", "literals"),
            (tblock, "write_sequences_section", "sequences")])
        times3 = []
        with split3:
            t0 = time.perf_counter()
            frame3 = ldm_sharded.compress_long_sharded(corpus, level=3,
                                                       group=grp)
            times3.append(time.perf_counter() - t0)
        launches3 = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        assert ldm_sharded.compress_long_sharded(
            corpus, level=3, group=grp) == frame3, "two level-3 runs differ"
        times3.append(time.perf_counter() - t0)

        # ---- level 19: the DP gap parse and the seqstore splitting ----------
        # a 512 KiB segment repeated: long matches inside the 2 MiB
        data19 = long_corpus(LONG_L19_BYTES, seg=512 * 1024)
        f19_cpu = ldm_sharded.compress_long_sharded(
            data19, level=19, checksum=True, group=cpu_grp)
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        frame19 = ldm_sharded.compress_long_sharded(
            data19, level=19, checksum=True, group=grp)
        t19 = time.perf_counter() - t0
        launches19 = dict(_kernels.LAUNCHES)
        assert frame19 == f19_cpu, "compress_long_sharded level 19: nccl " \
            "!= gloo"
    finally:
        dist.destroy_process_group()
    assert frame2 == frame, "two compress_long_sharded runs differ"
    for lv, got in ((1, launches), (3, launches3), (19, launches19)):
        for k in ("ldm_fingerprint", "ldm_lookback"):
            assert got[k] == 1, f"kernel {k}: {got[k]} launches at level {lv}"
    print(f"compress_long_sharded, level 1, long_log 27, one rank: "
          f"{len(corpus)} B -> {len(frame)} B, ratio "
          f"{len(corpus) / len(frame):.4f}, "
          f"{len(corpus) / min(times) / 1e6:.2f} MB/s (best of 2: "
          f"{times[0]:.3f} s, {times[1]:.3f} s), launches {launches}; host "
          + ", ".join(f"{k} {v * 1e3:.1f} ms"
                      for k, v in split.seconds.items()), flush=True)
    print(f"  profiled run: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']:.5f}", flush=True)
    t0 = time.perf_counter()
    out = device_decoder.device_decompress(frame, device=dev)
    assert out == corpus, "the long frame does not decode to the corpus"
    print(f"  decoded on the card by device_decompress: == corpus "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"compress_long_sharded, level 3, long_log 27, one rank: "
          f"{len(corpus)} B -> {len(frame3)} B, ratio "
          f"{len(corpus) / len(frame3):.4f}, "
          f"{len(corpus) / min(times3) / 1e6:.2f} MB/s (best of 2: "
          f"{times3[0]:.3f} s, {times3[1]:.3f} s), launches {launches3}; "
          "host " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                              for k, v in split3.seconds.items()),
          flush=True)
    t0 = time.perf_counter()
    out = device_decoder.device_decompress(frame3, device=dev)
    assert out == corpus, "the level-3 long frame does not decode"
    print(f"  decoded on the card by device_decompress: == corpus "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"compress_long_sharded, level 19, long_log 27, one rank: "
          f"{len(data19)} B -> {len(frame19)} B (nccl == gloo/cpu), ratio "
          f"{len(data19) / len(frame19):.4f}, "
          f"{len(data19) / t19 / 1e6:.2f} MB/s ({t19:.3f} s), launches "
          f"{launches19}", flush=True)
    t0 = time.perf_counter()
    out = device_decoder.device_decompress(frame19, device=dev)
    assert out == data19, "the level-19 long frame does not decode"
    print(f"  decoded on the card by device_decompress: == input "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return [
        dict(name="ldm_fingerprint", route="cuda",
             source="zstd_tpu_torch/csrc/ldm_fingerprint.cu",
             replaces="zstd_tpu/parallel/ldm_sharded.py:51-92 and :116-123",
             launches=launches["ldm_fingerprint"], max_abs_err=err7, ms=t7,
             plain_ms=p7, bound_ms=b7, bound_by="bytes", library_ms=None),
        dict(name="ldm_lookback", route="cuda",
             source="zstd_tpu_torch/csrc/ldm_lookback.cu",
             replaces="zstd_tpu/parallel/ldm_sharded.py:152-170",
             launches=launches["ldm_lookback"], max_abs_err=err8, ms=t8,
             plain_ms=p8, bound_ms=b8, bound_by="bytes", library_ms=None),
    ]


def pzstd_phase(corpus: bytes) -> dict:
    """Phase 10: the multi-host pzstd in an NCCL group of one rank.
    compress_my_shard takes its index and count from the group; at levels 1
    and 3 on the 16 MiB big_corpus (4 MiB chunks: spawned worker processes)
    and at level 19 on its 2 MiB prefix (one chunk), each equals
    pzstd_compress(..., shard_index=0, shard_count=1); MB/s of each.
    decompress_stream inverts the level-19 stream (the block decoder of
    csrc/host/decode.c on threads). This path is host-only by design, as in
    zstd_tpu: no kernel launches. Returns each level's (input, stream)."""
    import torch.distributed as dist
    from zstd_tpu_torch import _kernels
    from zstd_tpu_torch.parallel import multihost, pzstd, shard_compress

    shard_compress.init_group(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        assert multihost.init_distributed() == (0, 1)
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        streams = {}
        for level, data in ((1, corpus), (3, corpus),
                            (19, corpus[:PZSTD_L19_BYTES])):
            t0 = time.perf_counter()
            mine = multihost.compress_my_shard(data, level=level)
            t_mine = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = pzstd.pzstd_compress(data, level=level, shard_index=0,
                                        shard_count=1)
            t_want = time.perf_counter() - t0
            assert mine == want, f"compress_my_shard level {level}: != " \
                "pzstd_compress(shard 0 of 1)"
            streams[level] = (data, mine)
            print(f"compress_my_shard, level {level}, rank 0 of 1: "
                  f"{len(data)} B -> {len(mine)} B, ratio "
                  f"{len(data) / len(mine):.4f}, "
                  f"{len(data) / t_mine / 1e6:.2f} MB/s ({t_mine:.3f} s; "
                  f"pzstd_compress {t_want:.3f} s, the same bytes)",
                  flush=True)
        launches = dict(_kernels.LAUNCHES)
        assert not any(launches.values()), f"host path launched {launches}"
        data, stream = streams[19]
        t0 = time.perf_counter()
        assert multihost.decompress_stream(stream) == data, \
            "decompress_stream does not invert the level-19 stream"
        t = time.perf_counter() - t0
        print(f"decompress_stream of the level-19 stream: == input, "
              f"{len(data) / t / 1e6:.2f} MB/s ({t:.3f} s); launches "
              f"{launches}", flush=True)
    finally:
        dist.destroy_process_group()
    return streams


def host_c_phase(dev, corpus: bytes, frame: bytes, streams: dict) -> None:
    """Phase 11: the host C under the host halves (csrc/host/decode.c,
    xxh64.c, huf.c, encode.c) against their plain versions, the Python
    branches (tests/hostplain.py), in this one call. The device decode's
    host parse of the main path's 16 MiB level-1 frame, C against plain
    (ms, every field equal) and the decode's wall with each; `_build_plans`
    of the 16 MiB corpus's level-1 stats (ms, equal plans) and the level-1
    and level-5 encode walls with each (equal frames); decompress_stream of
    phase 10's level-1 (C only: the plain decoder takes minutes) and
    level-19 streams (MB/s; C == plain == input); compress_long_sharded at
    level 1 on 4 MiB of the long corpus with each, its host split (equal
    frames). Host code: the card only runs the encodes and decodes around
    it."""
    import pickle

    import numpy as np
    import torch
    from hostplain import plain_branches
    from longcorpus import long_corpus
    from zstd_tpu_torch import device_decoder, native, pipeline
    from zstd_tpu_torch.format import block as tblock
    from zstd_tpu_torch.format import ldm as tldm
    from zstd_tpu_torch.parallel import ldm_sharded, multihost
    from zstd_tpu_torch.params import get_cparams

    def best(fn, reps: int = 2) -> tuple[float, object]:
        out, t_best = None, float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            t_best = min(t_best, time.perf_counter() - t0)
        return t_best, out

    def fields(pf):
        return pickle.dumps((pf.lanes, pf.lane_tab, pf.segs, pf.host_pool,
                             pf.pool_len, [(a.tolist(), b.tolist())
                                           for a, b in pf.tables],
                             pf.ll.dtype.str, pf.ll.tolist(), pf.ml.tolist(),
                             pf.off.tolist(), pf.n, pf.end_pos))

    # ---- the decode's host parse and wall -----------------------------------
    t_c, pf_c = best(lambda: device_decoder._parse_frame(frame, 0, 31))
    t_p, pf_p = best(lambda: device_decoder._parse_frame_plain(frame, 0, 31),
                     reps=1)
    assert fields(pf_c) == fields(pf_p), "C parse != plain parse"
    d_c, out = best(lambda: device_decoder.device_decompress(frame,
                                                             device=dev))
    assert out == corpus
    with plain_branches():
        d_p, out = best(lambda: device_decoder.device_decompress(
            frame, device=dev), reps=1)
    assert out == corpus
    mib = len(corpus) >> 20
    print(f"host C, decode of the {mib} MiB level-1 frame ({len(pf_c.ll)} "
          f"sequences): host parse C {t_c * 1e3:.1f} ms, plain "
          f"{t_p * 1e3:.1f} ms (every field equal); device_decompress wall "
          f"C {d_c * 1e3:.1f} ms ({len(corpus) / d_c / 1e6:.2f} MB/s, best "
          f"of 2), plain {d_p * 1e3:.1f} ms "
          f"({len(corpus) / d_p / 1e6:.2f} MB/s)", flush=True)

    # ---- _build_plans and the encode walls ----------------------------------
    cp = get_cparams(1, len(corpus))
    comp = pipeline.TorchCompressor(level=1, device=dev)
    mls = min(max(cp.min_match, 4), 8)
    arr = np.frombuffer(corpus, np.uint8)
    batches = []
    for b in range(0, len(corpus) // N_BLOCK, 32):
        blocks = torch.from_numpy(
            arr[b * N_BLOCK:(b + 32) * N_BLOCK].reshape(32, N_BLOCK).copy()
        ).to(dev)
        lens = torch.full((32,), N_BLOCK, dtype=torch.int32, device=dev)
        stats, _ = pipeline._analyze(blocks, lens, cp.hash_log, mls,
                                     N_BLOCK // 8)
        batches.append((stats.cpu().numpy(), lens.cpu().numpy()))

    def plans():
        return [comp._build_plans(st, ln, cp.strategy, N_BLOCK)
                for st, ln in batches]

    p_c, plans_c = best(plans)
    with plain_branches():
        p_p, plans_p = best(plans)
    assert pickle.dumps(plans_c) == pickle.dumps(plans_p), \
        "_build_plans: C != plain"
    # what of the C run is still Python: its parts, and the time in C
    split = timed_calls(
        [(pipeline, "build_sequences_header_from_hists", "sequences header"),
         (pipeline, "_fse_bit_cost", "bit-cost estimate"),
         (pipeline.TorchCompressor, "_plan_literals", "literals plan")]
        + [(native, name, "C calls") for name in (
            "fse_normalize", "fse_write_ncount", "fse_build_ctable",
            "fse_compress_2state", "huf_build_write")])
    with split:
        t0 = time.perf_counter()
        plans()
        p_split = time.perf_counter() - t0
    in_c = split.seconds.get("C calls", 0.0)
    print(f"host C, _build_plans split (C branch, one run of "
          f"{p_split * 1e3:.1f} ms): " + ", ".join(
              f"{k} {v * 1e3:.1f} ms" for k, v in split.seconds.items())
          + f"; in Python {(1 - in_c / p_split) * 100:.1f}%", flush=True)
    walls = {}
    for level in (1, 5):
        enc = pipeline.TorchCompressor(level=level, device=dev)
        w_c, f_c = best(lambda: enc.compress(corpus))
        with plain_branches():
            w_p, f_p = best(lambda: enc.compress(corpus))
        assert f_c == f_p, f"level {level} encode: C frame != plain frame"
        walls[level] = (w_c, w_p)
    print(f"host C, _build_plans of the {mib} MiB corpus's level-1 stats "
          f"({len(batches)} batches of 32 blocks): C {p_c * 1e3:.1f} ms, "
          f"plain {p_p * 1e3:.1f} ms (equal plans); encode wall, best of 2: "
          + ", ".join(f"level {lv} C {c * 1e3:.1f} ms "
                      f"({len(corpus) / c / 1e6:.2f} MB/s), plain "
                      f"{p * 1e3:.1f} ms ({len(corpus) / p / 1e6:.2f} MB/s)"
                      for lv, (c, p) in walls.items())
          + " (equal frames)", flush=True)

    # ---- decompress_stream ------------------------------------------------
    for level in (1, 19):
        data, stream = streams[level]
        t_c, out = best(lambda: multihost.decompress_stream(stream))
        assert out == data, f"decompress_stream level {level} != input"
        line = (f"host C, decompress_stream of the level-{level} stream "
                f"({len(data)} B): C {len(data) / t_c / 1e6:.2f} MB/s "
                f"({t_c:.3f} s, best of 2)")
        if level == 19:
            with plain_branches():
                t_p, out = best(lambda: multihost.decompress_stream(stream),
                                reps=1)
            assert out == data, "plain decompress_stream != input"
            line += (f", plain {len(data) / t_p / 1e6:.2f} MB/s "
                     f"({t_p:.3f} s); C == plain == input")
        print(line, flush=True)

    # ---- compress_long_sharded, level 1 -------------------------------------
    data = long_corpus(LONG_BYTES)[:LONG_PREFIX_BYTES]
    out, walls = {}, {}
    for name in ("C", "plain", "plain", "C"):        # in turns, best of 2
        split = timed_calls([
            (ldm_sharded.ShardedLdmState, "__init__", "discovery"),
            (ldm_sharded.ShardedLdmState, "find_long_matches",
             "find_long_matches"),
            (tldm, "find_sequences_fast", "gap parse"),
            (tblock, "compress_literals", "literals"),
            (tblock, "write_sequences_section", "sequences")])
        with contextlib.ExitStack() as stack:
            if name == "plain":
                stack.enter_context(plain_branches())
            with split:
                t0 = time.perf_counter()
                f = ldm_sharded.compress_long_sharded(data, level=1,
                                                      device=dev)
                t = time.perf_counter() - t0
        assert out.setdefault(name, f) == f, "two runs differ"
        walls.setdefault(name, []).append(t)
        print(f"host C, compress_long_sharded level 1, long_log 27, "
              f"{len(data)} B -> {len(f)} B, {name}: "
              f"{len(data) / t / 1e6:.2f} MB/s ({t:.3f} s); host "
              + ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in split.seconds.items()), flush=True)
    assert out["C"] == out["plain"], "compress_long_sharded: C != plain"
    print("host C, compress_long_sharded level 1, best of 2: " + ", ".join(
        f"{k} {len(data) / min(v) / 1e6:.2f} MB/s" for k, v in walls.items())
        + " (equal frames)", flush=True)


def _cli_dictionary(content: bytes, dict_id: int) -> bytes:
    """A zstd-format dictionary written by the port's write_dictionary:
    `content`, a Huffman table over its bytes (+1 smoothing) and flat FSE
    tables over the full code alphabets (repeat mode valid for every
    code)."""
    import numpy as np
    from zstd_tpu_torch.constants import (LL_FSE_LOG, MAX_LL_CODE,
                                          MAX_ML_CODE, ML_FSE_LOG,
                                          OF_FSE_LOG)
    from zstd_tpu_torch.dictionary import write_dictionary
    from zstd_tpu_torch.format import fse, huffman
    lit = np.bincount(np.frombuffer(content, np.uint8),
                      minlength=256).astype(np.int64) + 1
    huf = huffman.build_huf_ctable(lit, 255, huffman.HUF_TABLELOG_DEFAULT)

    def flat(n: int, max_log: int):
        hist = np.ones(n, np.int64)
        log = fse.optimal_table_log(max_log, n, n - 1)
        return fse.normalize_count(hist, log, n, n - 1,
                                   use_low_prob_count=False), log
    return write_dictionary(dict_id, content, huf, *flat(29, OF_FSE_LOG),
                            *flat(MAX_ML_CODE + 1, ML_FSE_LOG),
                            *flat(MAX_LL_CODE + 1, LL_FSE_LOG))


def cli_phase(dev, corpus: bytes, root: str) -> None:
    """Phase 12: the command line, `python -m zstd_tpu_torch.cli`.

    As a command (a subprocess each): `--engine gpu -1 -c` of the 16 MiB
    corpus equals pipeline.compress(corpus, level=1, checksum=True) in this
    process, and `--engine gpu -d -c` of it gives back the corpus; the walls
    beside those of three bare processes (the interpreter; `import torch`;
    torch, the CUDA context and every kernel library loaded), whose
    difference from the CLI's wall is its codec and I/O time. In process:
    cli.main of the same two commands under torch.profiler launches
    extract, fse_chain, huf_lane_kernel and exec_seq (launch counts zeroed
    just before, read just after; profiler names checked). The host paths
    at the sizes users run, each CLI output equal to the in-process call of
    the same port function and decoded back to its input, MB/s of the CLI:
    the async file path (-3 on a 16 MiB file), -19 on 2 MiB, -1 --long=27
    on 16 MiB of tests/longcorpus.py, -T4, --rsyncable, --patch-from on
    4 MiB (old = the corpus's first 4 MiB with 8 point mutations), -D (a
    dictionary written by the port's write_dictionary, on 1 MiB: its
    decoder is Python), --target-compressed-block-size 2048, --format lz4,
    then -l and -t; no kernel launched on them."""
    import io
    import tempfile

    import numpy as np
    from longcorpus import long_corpus
    from zstd_tpu_torch import _kernels, cli, dictionary, fileio_async
    from zstd_tpu_torch import lz4frame, pipeline
    from zstd_tpu_torch.device_decoder import device_decompress
    from zstd_tpu_torch.format import codec
    from zstd_tpu_torch.parallel import pzstd
    from zstd_tpu_torch.params import get_cparams

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    mb = 1e6
    with tempfile.TemporaryDirectory() as tmp:
        def path(name: str) -> str:
            return os.path.join(tmp, name)

        def put(name: str, data: bytes) -> str:
            with open(path(name), "wb") as f:
                f.write(data)
            return path(name)

        def get(name: str) -> bytes:
            with open(path(name), "rb") as f:
                return f.read()

        def proc(*args: str) -> tuple:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, *args], cwd=tmp, env=env,
                               capture_output=True, timeout=300)
            wall = time.perf_counter() - t0
            assert r.returncode == 0, r.stderr.decode(errors="replace")
            return r.stdout, wall

        put("corpus.bin", corpus)
        # ---- as a command ----
        enc, t_enc = proc("-m", "zstd_tpu_torch.cli", "--engine", "gpu",
                          "-1", "-c", "corpus.bin")
        pipeline.compress(corpus, level=1, checksum=True, device=dev)  # warm
        t0 = time.perf_counter()
        want = pipeline.compress(corpus, level=1, checksum=True, device=dev)
        t_enc_in = time.perf_counter() - t0
        assert enc == want, "the CLI's --engine gpu -1 frame != " \
            "pipeline.compress in process"
        put("corpus.bin.zst", enc)
        dec, t_dec = proc("-m", "zstd_tpu_torch.cli", "--engine", "gpu",
                          "-d", "-c", "corpus.bin.zst")
        assert dec == corpus, "the CLI's --engine gpu -d does not give " \
            "back the corpus"
        t0 = time.perf_counter()
        assert device_decompress(enc, device=dev) == corpus
        t_dec_in = time.perf_counter() - t0
        _, t_py = proc("-c", "pass")
        _, t_torch = proc("-c", "import torch")
        _, t_libs = proc("-c", "import torch\n"
                         "torch.zeros(1, device='cuda')\n"
                         "from zstd_tpu_torch import _kernels\n"
                         "for s in _kernels.SOURCES: _kernels.get(s)\n"
                         "_kernels.host()\n")
        print(f"CLI as a command, 16 MiB: --engine gpu -1 -c {t_enc:.3f} s "
              f"({len(corpus) / t_enc / mb:.2f} MB/s, {len(enc)} B == "
              f"pipeline.compress in process, {t_enc_in:.3f} s, "
              f"{len(corpus) / t_enc_in / mb:.2f} MB/s); --engine gpu -d -c "
              f"{t_dec:.3f} s ({len(corpus) / t_dec / mb:.2f} MB/s, == corpus;"
              f" device_decompress in process {t_dec_in:.3f} s, "
              f"{len(corpus) / t_dec_in / mb:.2f} MB/s)", flush=True)
        print(f"  bare processes: the interpreter {t_py:.3f} s; it and import "
              f"torch {t_torch:.3f} s; those, the CUDA context and the "
              f"kernel libraries {t_libs:.3f} s (start-up {t_libs / t_enc:.3f}"
              f" of the encode's wall); so the encode's codec and I/O "
              f"{t_enc - t_libs:.3f} s, the decode's {t_dec - t_libs:.3f} s",
              flush=True)

        # ---- in process, under the profiler ----
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0

        def both_ways():
            assert cli.main(["--engine", "gpu", "-1", "-f", "-o",
                             path("inproc.zst"), path("corpus.bin")]) == 0
            assert cli.main(["--engine", "gpu", "-d", "-f", "-o",
                             path("inproc.out"), path("inproc.zst")]) == 0

        prof = profile_run(both_ways)
        launches = dict(_kernels.LAUNCHES)
        assert get("inproc.zst") == want and get("inproc.out") == corpus
        seen = {}
        for kern in ("extract_kernel", "fse_chain_kernel", "huf_lane_kernel",
                     "exec_seq_kernel"):
            seen[kern] = sum(v for k, v in prof["by_name"].items()
                             if kern in k)
            assert any(kern in k for k in prof["by_name"]), \
                f"cli.main launched no {kern} (profiler)"
        for k in ("extract", "fse_chain", "huf_decode", "exec_seq"):
            assert launches[k] > 0, f"cli.main launched no {k}"
        print(f"cli.main --engine gpu -1 then -d in process: wall "
              f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
              f"ms, launches {launches}; device ms by kernel " + ", ".join(
                  f"{k} {v:.3f}" for k, v in seen.items()), flush=True)

        # ---- the host paths ----
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        rng = np.random.default_rng(8)
        new = corpus[:CLI_PATCH_BYTES]
        old = bytearray(new)
        for at in rng.integers(0, len(old), 8):
            old[int(at)] ^= 0x5A
        old = bytes(old)
        put("old.bin", old)
        put("new.bin", new)
        small = put("l19.bin", corpus[:CLI_L19_BYTES])
        put("long.bin", long_corpus(CORPUS_BYTES))
        put("dict.bin", corpus[:CLI_DICT_BYTES])
        blob = _cli_dictionary(corpus[-65536:], 24680)
        put("dict", blob)
        dct = dictionary.load_dictionary(blob)
        rlog = min(max(get_cparams(3, len(corpus)).window_log + 2, 19), 24)
        async_calls = []
        orig_async = fileio_async.compress_file_async

        def counted(*a, **k):
            async_calls.append(1)
            return orig_async(*a, **k)

        fileio_async.compress_file_async = counted
        legs = (
            ("async file path -3", ["-3", "-f", path("corpus.bin")],
             "corpus.bin.zst", corpus,
             lambda: (orig_async(path("corpus.bin"), path("ref.zst"),
                                 level=3, checksum=True), get("ref.zst"))[1],
             codec.decompress),
            ("-19, 2 MiB", ["-19", "-f", "-o", path("l19.zst"), small],
             "l19.zst", corpus[:CLI_L19_BYTES],
             lambda: codec.compress(corpus[:CLI_L19_BYTES], level=19,
                                    checksum=True), codec.decompress),
            ("-1 --long=27, long corpus", ["-1", "--long=27", "-f", "-o",
                                           path("long.zst"),
                                           path("long.bin")],
             "long.zst", get("long.bin"),
             lambda: codec.compress(get("long.bin"), level=1, checksum=True,
                                    window_log=27, long_mode=True),
             codec.decompress),
            ("-T4", ["-T4", "-f", "-o", path("t4.zst"), path("corpus.bin")],
             "t4.zst", corpus,
             lambda: pzstd.pzstd_compress(corpus, level=3, checksum=True,
                                          workers=4), codec.decompress),
            ("--rsyncable", ["--rsyncable", "-f", "-o", path("rs.zst"),
                             path("corpus.bin")], "rs.zst", corpus,
             lambda: pzstd.pzstd_compress(corpus, level=3, checksum=True,
                                          workers=1, rsync_log=rlog),
             codec.decompress),
            ("--patch-from, 4 MiB", ["--patch-from", path("old.bin"), "-f",
                                     "-o", path("patch.zst"),
                                     path("new.bin")],
             "patch.zst", new,
             lambda: codec.compress_patch(new, old, level=3, checksum=True),
             lambda b: codec.decompress_patch(b, old)),
            ("-D, 1 MiB", ["-D", path("dict"), "-f", "-o", path("d.zst"),
                           path("dict.bin")], "d.zst",
             corpus[:CLI_DICT_BYTES],
             lambda: dictionary.compress_with_dict(
                 corpus[:CLI_DICT_BYTES], dct, level=3, checksum=True),
             lambda b: dictionary.decompress_with_dict(b, dct)),
            ("--target-compressed-block-size 2048",
             ["--target-compressed-block-size", "2048", "-f", "-o",
              path("tcb.zst"), path("corpus.bin")], "tcb.zst", corpus,
             lambda: codec.compress(corpus, level=3, checksum=True,
                                    target_cblock_size=2048),
             codec.decompress),
            ("--format lz4", ["--format", "lz4", "-f", "-o",
                              path("c.lz4"), path("corpus.bin")],
             "c.lz4", corpus,
             lambda: lz4frame.compress_lz4(corpus, content_checksum=True),
             lambda b: lz4frame.decompress_lz4(b)[0]),
        )
        try:
            for label, argv, out, data, ref_fn, decode in legs:
                t0 = time.perf_counter()
                assert cli.main(argv) == 0, label
                t_cli = time.perf_counter() - t0
                got = get(out)
                t0 = time.perf_counter()
                ref = ref_fn()
                t_ref = time.perf_counter() - t0
                assert got == ref, f"{label}: the CLI's output != the " \
                    "in-process call"
                t0 = time.perf_counter()
                assert decode(got) == data, f"{label}: no round trip"
                t_back = time.perf_counter() - t0
                print(f"CLI {label}: {len(data)} B -> {len(got)} B, ratio "
                      f"{len(data) / len(got):.4f}, {len(data) / t_cli / mb:.2f}"
                      f" MB/s ({t_cli:.3f} s; in process {t_ref:.3f} s, the "
                      f"same bytes; decoded back in {t_back:.3f} s)",
                      flush=True)
        finally:
            fileio_async.compress_file_async = orig_async
        assert async_calls == [1], "-3 on a 16 MiB file skipped the async " \
            "file path"
        listing = io.StringIO()
        zsts = [path(n) for n in ("corpus.bin.zst", "l19.zst", "t4.zst",
                                  "rs.zst", "tcb.zst")]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(listing):
            assert cli.main(["-l", *zsts]) == 0
        t_list = time.perf_counter() - t0
        rows = listing.getvalue().splitlines()
        # the async path's frame is a stream's: its size is not in it
        assert len(rows) == 6 and " unknown " in rows[1] \
            and f" {len(corpus)} " in rows[5] \
            and all("XXH64" in r for r in rows[1:]), rows
        t0 = time.perf_counter()
        assert cli.main(["-t", *zsts]) == 0
        t_test = time.perf_counter() - t0
        bad = bytearray(get("tcb.zst"))
        bad[len(bad) // 2] ^= 0xFF
        put("bad.zst", bytes(bad))
        with contextlib.redirect_stderr(io.StringIO()) as err:
            assert cli.main(["-t", path("bad.zst")]) == 1
        tested = len(corpus) * 4 + CLI_L19_BYTES
        print(f"CLI -l of 5 frames: {t_list:.3f} s; -t of them: "
              f"{tested / t_test / mb:.2f} MB/s ({t_test:.3f} s); -t of a "
              f"corrupted frame exits 1 ({err.getvalue().strip()[:60]})",
              flush=True)
        for line in rows:
            print(f"  {line}")
        launches = dict(_kernels.LAUNCHES)
        assert not any(launches.values()), \
            f"the host paths launched {launches}"


def hostapi_phase(dev, corpus: bytes, root: str) -> None:
    """Phase 13: the rest of zstd_tpu's host API, none of it a kernel.

    The trainers: `python -m zstd_tpu_torch.cli --train` as a command on
    TRAIN_BYTES of the corpus cut into samples of TRAIN_SAMPLE bytes, its
    dictionary equal to finalize_dictionary(train_from_samples(...)) run in
    this process meanwhile (train and finalize timed apart); --train-cover
    and --optimize-cover through cli.main on the same samples
    (--optimize-cover on TRAIN_OPT_BYTES of them if the command took over
    60 s); -D compress and decompress of TRAIN_DICT_BYTES with the trained
    dictionary. seekable: seekable_compress of the corpus at level 3 in
    frames of SEEK_FRAME bytes, three ranges equal to the corpus's slices,
    and device_decompress of the blob on the card (the decode kernels on
    the host encoder's frames; the seek table's skippable frame skipped).
    The sequence producer: a period-8 producer on the corpus's length of
    b"abcdefgh" and one that returns None on the corpus, at level 3, each
    frame decoded on the host and on the card."""
    import io
    import tempfile
    import threading

    import zstd_tpu_torch
    from zstd_tpu_torch import _kernels, cli, device_decoder, dictionary
    from zstd_tpu_torch import seekable
    from zstd_tpu_torch.dict_builder.fastcover import train_from_samples
    from zstd_tpu_torch.dict_builder.zdict import finalize_dictionary
    from zstd_tpu_torch.format import codec

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    mb = 1e6

    def on_card(label: str, blob: bytes, want: bytes) -> None:
        for k in _kernels.LAUNCHES:
            _kernels.LAUNCHES[k] = 0
        device_decoder.COUNTS["host_frames"] = 0
        t0 = time.perf_counter()
        out = device_decoder.device_decompress(blob, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        host_frames = device_decoder.COUNTS["host_frames"]
        assert out == want, f"{label}: the card's decode differs"
        assert host_frames == 0, f"{label}: {host_frames} frames went to " \
            "the host decoder"
        for k in ("huf_decode", "exec_seq"):
            assert launches[k] > 0, f"{label}: no {k} launch"
        print(f"  {label} on the card: device_decompress {wall:.3f} s "
              f"({len(want) / wall / mb:.2f} MB/s), launches literal_pool "
              f"{launches['huf_decode']}, exec_seq {launches['exec_seq']}",
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        def path(name: str) -> str:
            return os.path.join(tmp, name)

        def get(name: str) -> bytes:
            with open(path(name), "rb") as f:
                return f.read()

        def trainer_leg(flag: str, use: list) -> str:
            target = path(flag[2:] + ".dict")
            said = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(said):
                assert cli.main([flag, "-o", target, "--maxdict", "112640",
                                 *use]) == 0, flag
            wall = time.perf_counter() - t0
            blob = get(target)
            assert dictionary.load_dictionary(blob).dict_id >= 32768, flag
            return (f"  cli.main {flag} on {len(use)} samples: {wall:.3f} s, "
                    f"dictionary {len(blob)} B ("
                    + "; ".join(said.getvalue().strip().splitlines()) + ")")

        # ---- the trainers ----
        train = corpus[:TRAIN_BYTES]
        samples = [train[i:i + TRAIN_SAMPLE]
                   for i in range(0, len(train), TRAIN_SAMPLE)]
        os.makedirs(path("s"))
        names = []
        for i, sample in enumerate(samples):
            names.append(path(f"s/{i:04d}.bin"))
            with open(names[-1], "wb") as f:
                f.write(sample)
        t0 = time.perf_counter()
        with open(path("train.out"), "wb") as out, \
                open(path("train.err"), "wb") as err:
            cmd = subprocess.Popen(
                [sys.executable, "-m", "zstd_tpu_torch.cli", "--train", "-o",
                 "d.dict", "--maxdict", "112640", *names], cwd=tmp, env=env,
                stdout=out, stderr=err)
        ended = []
        waiter = threading.Thread(
            target=lambda: ended.append((cmd.wait(), time.perf_counter())))
        waiter.start()
        try:
            # while the command runs: the same training in this process,
            # then --train-cover through cli.main
            t1 = time.perf_counter()
            raw = train_from_samples(samples, max_dict_size=112640)
            t_train = time.perf_counter() - t1
            t1 = time.perf_counter()
            want = finalize_dictionary(raw, samples, dict_id=0, level=3)
            t_fin = time.perf_counter() - t1
            legs = [trainer_leg("--train-cover", names)]
            waiter.join(timeout=300)
        finally:
            if cmd.poll() is None:
                cmd.kill()
            waiter.join()
        rc, t_end = ended[0]
        t_cmd = t_end - t0
        assert rc == 0, get("train.err").decode(errors="replace")
        assert get("d.dict") == want, "the CLI's --train dictionary != " \
            "finalize_dictionary(train_from_samples(...)) in process"
        print(f"trainers, {len(samples)} samples of {TRAIN_SAMPLE} B "
              f"({len(train)} B): --train as a command {t_cmd:.3f} s "
              f"({get('train.out').decode().strip()}), == in process: "
              f"train_from_samples {t_train:.3f} s + finalize_dictionary "
              f"{t_fin:.3f} s (finalize share "
              f"{t_fin / (t_train + t_fin):.4f}); dictionary {len(want)} B",
              flush=True)
        opt_names = names
        if t_cmd > 60:
            opt_names = names[:TRAIN_OPT_BYTES // TRAIN_SAMPLE]
        legs.append(trainer_leg("--optimize-cover", opt_names))
        for line in legs:
            print(line, flush=True)
        data = corpus[len(corpus) // 2:len(corpus) // 2 + TRAIN_DICT_BYTES]
        with open(path("x.bin"), "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        assert cli.main(["-q", "-D", path("d.dict"), "-f", "-o",
                         path("x.zst"), path("x.bin")]) == 0
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert cli.main(["-q", "-d", "-D", path("d.dict"), "-f", "-o",
                         path("x.out"), path("x.zst")]) == 0
        t_d = time.perf_counter() - t0
        assert get("x.out") == data, "-D with the trained dictionary: no " \
            "round trip"
        print(f"  -D with the --train dictionary, {len(data)} B: -> "
              f"{len(get('x.zst'))} B (without it "
              f"{len(codec.compress(data, level=3))} B), compress {t_c:.3f} "
              f"s, decompress {t_d:.3f} s, == input", flush=True)

    # ---- seekable ----
    t0 = time.perf_counter()
    blob = seekable.seekable_compress(corpus, level=3, frame_size=SEEK_FRAME)
    t_sc = time.perf_counter() - t0
    table = seekable.read_seek_table(blob)
    assert table.content_size == len(corpus)
    walls = []
    for offset, length in ((0, 1000), (5 * SEEK_FRAME - 100, 3 * SEEK_FRAME),
                           (len(corpus) - 10, None)):
        t0 = time.perf_counter()
        got = seekable.seekable_decompress(blob, offset, length)
        walls.append(time.perf_counter() - t0)
        end = len(corpus) if length is None else offset + length
        assert got == corpus[offset:end], f"seekable range {offset}"
    print(f"seekable: {len(corpus)} B at level 3 in {len(table.entries)} "
          f"frames of {SEEK_FRAME} B -> {len(blob)} B in {t_sc:.3f} s "
          f"({len(corpus) / t_sc / mb:.2f} MB/s); three ranges equal to the "
          "corpus in " + ", ".join(f"{w:.3f}" for w in walls) + " s",
          flush=True)
    on_card("seekable blob", blob, corpus)

    # ---- the sequence producer ----
    def period8(full, bs, be, wl):
        if be - bs < 64:
            return None
        ml = (be - bs) - 16
        ml -= ml % 8
        return [(8, 8, ml)]

    asked = []

    def none(full, bs, be, wl):
        asked.append(bs)
        return None

    period = b"abcdefgh" * (len(corpus) // 8)
    for label, producer, data in (("period-8 producer", period8, period),
                                  ("None producer", none, corpus)):
        zstd_tpu_torch.register_sequence_producer(producer)
        try:
            t0 = time.perf_counter()
            frame = codec.compress(data, level=3, checksum=True)
            t_c = time.perf_counter() - t0
        finally:
            zstd_tpu_torch.register_sequence_producer(None)
        t0 = time.perf_counter()
        assert codec.decompress(frame) == data, f"{label}: host decode"
        t_h = time.perf_counter() - t0
        print(f"producer: {label}, {len(data)} B at level 3 -> {len(frame)} "
              f"B in {t_c:.3f} s ({len(data) / t_c / mb:.2f} MB/s); host "
              f"decode {t_h:.3f} s", flush=True)
        on_card(label, frame, data)
    assert len(asked) >= len(corpus) // (128 * 1024), \
        f"the None producer was asked for {len(asked)} blocks"
    print(f"  the None producer was asked for {len(asked)} blocks",
          flush=True)


def main() -> int:
    signal.alarm(1150)             # hard deadline: the default action exits
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # by file: an installed package named `tests` can shadow the repo's
    sys.path.insert(0, os.path.join(root, "tests"))
    from bigcorpus import big_corpus
    from chainmodel import SYNTHETIC_ROWS, chain_fields, synthetic_batch
    from zstd_tpu_torch import _kernels, pipeline
    from zstd_tpu_torch.ops.fse_enc import (fse_fields, fse_fields_plain,
                                            fse_fields_stats)
    from zstd_tpu_torch.ops.match import (hash_positions, prev_same_bucket,
                                          words_at)
    from zstd_tpu_torch.ops.resolve import (extract_compact,
                                            extract_compact_stats,
                                            extract_plain)
    from zstd_tpu_torch.ops.seqextract import next_possible
    from zstd_tpu_torch.params import get_cparams

    dev = torch.device(DEVICE)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t_build = _kernels.build_all()
    t_host = _kernels.build_host()
    print(f"build: {t_build:.1f} s (nvcc), {t_host:.1f} s (cc, csrc/host)",
          flush=True)
    for src, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    corpus = big_corpus(CORPUS_BYTES)
    arr = np.frombuffer(corpus, np.uint8)
    cp = get_cparams(1, len(corpus))
    block_size = min(1 << cp.window_log, N_BLOCK)
    assert block_size == N_BLOCK, block_size
    mls = min(max(cp.min_match, 4), 8)
    seq_cap = block_size // 8

    # ---- 2. extract: kernel vs plain on the compare rows ----------------
    rng = np.random.default_rng(0)
    n_blocks = len(corpus) // N_BLOCK          # four blocks across the corpus
    rows = [arr[i * N_BLOCK:(i + 1) * N_BLOCK]
            for i in (0, n_blocks // 3 + 1, 2 * n_blocks // 3 + 2, n_blocks - 1)]
    rows.append(np.zeros(N_BLOCK, np.uint8))                  # one long match
    rows.append(np.tile(rng.integers(0, 256, 128, dtype=np.uint8),
                        N_BLOCK // 128))                       # period 128
    rows.append(rng.integers(0, 256, N_BLOCK, dtype=np.uint8))  # random
    rows.append(arr[5 * N_BLOCK:6 * N_BLOCK])                 # valid_len < N
    # mls-byte tokens from a small dictionary, their first bytes distinct:
    # every token starts a sequence (about one per 7.5 bytes at mls 7), so the
    # walk reaches cap = 16,384
    tokens = rng.integers(0, 256, (16, mls), dtype=np.uint8)
    tokens[:, 0] = rng.permutation(256)[:16]
    units = tokens[rng.integers(0, 16, N_BLOCK // mls + 1)]
    rows.append(units.reshape(-1)[:N_BLOCK])
    # random bytes with zero runs that start inside 4,096-byte segments and
    # span several of them, the last one to the end of the row
    runs = rng.integers(0, 256, N_BLOCK, dtype=np.uint8)
    for a, z in ((5000, 30000), (70001, 71500), (100500, N_BLOCK)):
        runs[a:z] = 0
    rows.append(runs)
    cmp_blocks = torch.from_numpy(np.stack(rows)).to(dev)
    cmp_lens = torch.full((len(rows),), N_BLOCK, dtype=torch.int32, device=dev)
    cmp_lens[7] = 100_003

    def propose(blocks, lens):
        w32 = words_at(blocks)
        cands = prev_same_bucket(hash_positions(blocks, cp.hash_log, mls, w32),
                                 lens)
        return cands, next_possible(blocks, cands, w32)

    cands, nxt = propose(cmp_blocks, cmp_lens)
    got, walk = extract_compact_stats(cmp_blocks, cands, nxt, cmp_lens,
                                      seq_cap)
    torch.cuda.synchronize()
    want = extract_plain(cmp_blocks, cands, nxt, cmp_lens, seq_cap)
    err_x = max_abs_err(got, want)
    print(f"extract: nb_seq {got[4].tolist()} nb_lit {got[5].tolist()} "
          f"zero-row ml {int(got[2][4, 0])} max_abs_err {err_x}", flush=True)
    print_walk(walk, got[4])
    assert err_x == 0, "extract kernel disagrees with extract_plain"
    assert int(got[4][8]) == seq_cap, "the token row should reach the cap"

    # the main path's first batch, for timing
    b0_np = arr[:32 * N_BLOCK].reshape(32, N_BLOCK)
    b0 = torch.from_numpy(b0_np.copy()).to(dev)
    b0_lens = torch.full((32,), N_BLOCK, dtype=torch.int32, device=dev)
    b0_cands, b0_nxt = propose(b0, b0_lens)
    x_args = (b0, b0_cands, b0_nxt, b0_lens, seq_cap)
    x_ms = cuda_ms(lambda: extract_compact(*x_args))
    x_plain_ms = host_ms(lambda: extract_plain(*x_args))
    x_out, x_walk = extract_compact_stats(*x_args)
    print("extract batch 0 walk:")
    print_walk(x_walk, x_out[4])
    x_bound = nbytes(b0, b0_cands, b0_nxt, b0_lens, *x_out) / HBM_BYTES_PER_S * 1e3
    err_x = max(err_x, max_abs_err(x_out, extract_plain(*x_args)))
    assert err_x == 0, "extract kernel disagrees with extract_plain (batch 0)"
    print(f"extract batch 0: kernel {x_ms:.3f} ms plain {x_plain_ms:.1f} ms "
          f"bound {x_bound * 1e3:.1f} us", flush=True)

    # ---- 3. FSE chain: kernel vs plain ------------------------------------
    comp = pipeline.TorchCompressor(level=1, device=dev)

    def fse_args(blocks, lens):
        stats, resident = pipeline._analyze(blocks, lens, cp.hash_log, mls,
                                            seq_cap)
        _, blob, cap, *_ = comp._build_plans(
            stats.cpu().numpy(), lens.cpu().numpy(), cp.strategy, block_size)
        return pipeline.fse_inputs(resident, torch.from_numpy(blob).to(dev),
                                   cap)

    # the ten phase-2 rows (the token row reaches cap), then batch 0
    f_cmp = fse_args(cmp_blocks, cmp_lens)
    assert int(f_cmp[6][8]) == seq_cap, "the token row should reach the cap"
    err_f = max_abs_err(fse_fields(*f_cmp), fse_fields_plain(*f_cmp))
    f_args = fse_args(b0, b0_lens)
    f_out, f_stats = fse_fields_stats(*f_args)
    err_f = max(err_f, max_abs_err(f_out, fse_fields_plain(*f_args)))
    print(f"fse_chain: cap {f_args[0].shape[1]} nb_seq "
          f"{f_args[6].tolist()[:8]}... max_abs_err {err_f}", flush=True)
    assert err_f == 0, "fse_chain kernel disagrees with fse_fields_plain"
    print("fse_chain batch 0 counts (rows 0-7):")
    print_chain(f_stats, 8)
    # synthetic table sets at the main path's cap: no symbol of count 1
    # (128 candidates a cut, maps in global scratch), RLE, predefined,
    # random, nb_seq 0, 1, 2, cap
    syn = tuple(torch.from_numpy(a).to(dev)
                for a in synthetic_batch(seq_cap, seed=1))
    syn_out, syn_stats = fse_fields_stats(*syn)
    err_s = max_abs_err(syn_out, fse_fields_plain(*syn))
    print(f"fse_chain synthetic rows {list(SYNTHETIC_ROWS)}: nb_seq "
          f"{syn[6].tolist()} max_abs_err {err_s}", flush=True)
    print_chain(syn_stats, len(SYNTHETIC_ROWS))
    assert err_s == 0, "fse_chain kernel disagrees on the synthetic tables"
    err_f = max(err_f, err_s)
    # the kernel's counts against tests/chainmodel.py on blocks 0, 40, 43
    m_blocks = np.stack([arr[i * N_BLOCK:(i + 1) * N_BLOCK]
                         for i in (0, 40, 43)])
    m_args = fse_args(torch.from_numpy(m_blocks).to(dev),
                      torch.full((3,), N_BLOCK, dtype=torch.int32, device=dev))
    m_out, m_stats = fse_fields_stats(*m_args)
    m_vals, m_nbits, m_counts = chain_fields(
        tuple(a.cpu().numpy() for a in m_args))
    got = m_stats[:, :, :4].cpu().numpy()
    for k, blk in enumerate((0, 40, 43)):
        print(f"  block {blk}: kernel (segments, longest, most candidates, "
              f"walk steps) per LL/OF/ML {got[k].tolist()}, model "
              f"{m_counts[k].tolist()}")
    assert (got == m_counts).all(), "fse_chain counts differ from the model"
    assert (m_out[0].cpu().numpy() == m_vals).all() \
        and (m_out[1].cpu().numpy() == m_nbits).all(), \
        "fse_chain fields differ from the model's"
    f_ms = cuda_ms(lambda: fse_fields(*f_args))
    f_plain_ms = host_ms(lambda: fse_fields_plain(*f_args))
    f_bound = nbytes(*f_args, *f_out) / HBM_BYTES_PER_S * 1e3
    print(f"fse_chain batch 0: kernel {f_ms:.4f} ms plain {f_plain_ms:.1f} ms "
          f"bound {f_bound * 1e3:.1f} us", flush=True)

    # ---- 4. main path: level-1 encode of the 16 MiB corpus ---------------
    pipeline.compress(corpus, level=1, device=dev)            # warm
    for k in _kernels.LAUNCHES:
        _kernels.LAUNCHES[k] = 0
    times = []
    t0 = time.perf_counter()
    frame = pipeline.compress(corpus, level=1, device=dev)
    times.append(time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    frame2 = pipeline.compress(corpus, level=1, device=dev)
    times.append(time.perf_counter() - t0)
    assert frame2 == frame, "two runs gave different frames"
    mbps = len(corpus) / min(times) / 1e6
    print(f"main path: {len(corpus)} B -> {len(frame)} B, ratio "
          f"{len(corpus) / len(frame):.4f}, {mbps:.2f} MB/s (best of 2: "
          f"{times[0]:.3f} s, {times[1]:.3f} s), launches {launches}",
          flush=True)
    for k in ("extract", "fse_chain"):
        assert launches[k] > 0, f"kernel {k} was not launched on the main path"
    n_blocks = frame_blocks(frame)
    assert n_blocks == len(corpus) // block_size, n_blocks

    prefix = corpus[:PREFIX_BYTES]
    f_gpu = pipeline.compress(prefix, level=1, checksum=True, device=dev)
    f_cpu = pipeline.compress(prefix, level=1, checksum=True, device="cpu")
    assert f_gpu == f_cpu, "cuda and cpu frames of the 1 MiB prefix differ"
    print(f"1 MiB prefix: cuda frame == cpu frame ({len(f_gpu)} B)", flush=True)

    stage_mbps = comp.device_stage_mbps(corpus)
    print(f"device_stage_mbps: {stage_mbps:.2f}", flush=True)

    # ---- 5. where the main path's time goes (one profiled run) ----------
    profiled_encode(pipeline, dev, corpus, 1)

    kernels = [
        dict(name="extract", route="cuda",
             source="zstd_tpu_torch/csrc/extract.cu",
             replaces="zstd_tpu/ops/resolve_pallas.py:41",
             launches=launches["extract"], max_abs_err=err_x,
             ms=x_ms, plain_ms=x_plain_ms, bound_ms=x_bound,
             bound_by="bytes", library_ms=None),
        dict(name="fse_chain", route="cuda",
             source="zstd_tpu_torch/csrc/fse_chain.cu",
             replaces="zstd_tpu/ops/fse_enc.py:111",
             launches=launches["fse_chain"], max_abs_err=err_f,
             ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound,
             bound_by="bytes", library_ms=None),
    ]

    # ---- 6. device decode of the main path's frame ------------------------
    kernels += decode_phase(dev, corpus, frame, root)

    # ---- 7. the lazy engine: level 5 ---------------------------------------
    kernels += lazy_phase(dev, corpus)

    # ---- 8. the xla engine and the one-frame sharded encode ----------------
    kernels.append(xla_phase(dev, corpus))

    # ---- 9. the sharded long-distance matcher and --long -------------------
    kernels += ldm_phase(dev)

    # ---- 10. the multi-host pzstd (host codec) ----------------------------
    streams = pzstd_phase(corpus)

    # ---- 11. the host C against the host halves' plain versions ------------
    host_c_phase(dev, corpus, frame, streams)

    # ---- 12. the command line ----------------------------------------------
    cli_phase(dev, corpus, root)

    # ---- 13. the host API: trainers, seekable, the sequence producer ------
    hostapi_phase(dev, corpus, root)
    print(card_line(), flush=True)       # again, beside the numbers below
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
