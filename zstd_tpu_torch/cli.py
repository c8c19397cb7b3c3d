"""zstd-compatible command line interface: python -m zstd_tpu_torch.cli.

Copy of zstd_tpu/cli.py over the port. Parity target: zstd's
programs/zstdcli.c:831 (operation modes compress/decompress/test/bench/list,
multi-personality names, common flags) and fileio.c behaviors (suffix
handling, stdout rules, --rm, -f, -k).

Engine selection: the host codec by default; --engine gpu (or tpu, the
same, so command lines written for zstd_tpu run unchanged) sends levels
1-2 without a dictionary through the device encode (pipeline.compress:
the extract and fse_chain kernels) and -d through the device decode
(device_decoder.device_decompress: the literal_pool and exec_seq kernels).
--engine alone decides: no environment variable moves the path. The device
path runs on the CUDA card and raises where there is none; main(argv,
device="cpu") runs it through the kernels' plain versions instead (the
tests). torch is imported on the device path only.

Two of zstd_tpu's faults are not inherited: ZSTD_TPU_ENGINE set to anything
does not move the encode onto the device path (zstd_tpu/cli.py:146), and
lz4 input with bytes after its last frame is an error (exit 1), as trailing
bytes after zstd frames are, where zstd_tpu decodes the frames and exits 0
(:274-280).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .errors import ZstdError, ZstdErrorCode
from .format.codec import compress, decompress


def _err(msg: str) -> None:
    print(f"zstd: {msg}", file=sys.stderr)


def build_parser(prog: str = "zstd") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, add_help=False,
        description="zstd_tpu_torch: Zstandard CLI on PyTorch/CUDA")
    p.add_argument("files", nargs="*", help="files to process")
    p.add_argument("-h", "--help", action="store_true", dest="show_help")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-z", "--compress", action="store_true")
    p.add_argument("-t", "--test", action="store_true")
    p.add_argument("-b", dest="bench", nargs="?", const=3, type=int,
                   metavar="#", help="benchmark file(s) at level #")
    p.add_argument("-e", dest="bench_end", type=int, metavar="#",
                   help="with -b: benchmark the level range -b#..-e#")
    p.add_argument("-i", dest="bench_secs", type=float, metavar="#",
                   help="with -b: minimum seconds per measurement")
    p.add_argument("-H", action="help", help=argparse.SUPPRESS)
    p.add_argument("--train", action="store_true")
    p.add_argument("--train-cover", action="store_true", dest="train_cover")
    p.add_argument("--train-fastcover", action="store_true",
                   dest="train_fastcover",
                   help="train with the fastCover algorithm (the default)")
    p.add_argument("--train-legacy", action="store_true", dest="train_legacy",
                   help="legacy trainer selector; routed to the COVER "
                        "trainer (the divsufsort analysis path is a "
                        "documented non-goal)")
    p.add_argument("--optimize-cover", action="store_true", dest="opt_cover")
    p.add_argument("-l", "--list", action="store_true")
    p.add_argument("-o", dest="output", metavar="FILE")
    p.add_argument("-c", "--stdout", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-k", "--keep", action="store_true", default=True)
    p.add_argument("--rm", action="store_true")
    p.add_argument("-q", "--quiet", action="count", default=0)
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-D", dest="dictionary", metavar="DICT")
    p.add_argument("--maxdict", type=int, default=112640)
    p.add_argument("--dictID", type=int, default=0)
    p.add_argument("--no-dictID", dest="no_dict_id", action="store_true",
                   help="don't write the dictID into frame headers")
    p.add_argument("-T", "--threads", type=int, default=0, metavar="#")
    p.add_argument("--single-thread", dest="single_thread",
                   action="store_true",
                   help="one thread for I/O and compression (no async I/O)")
    p.add_argument("--auto-threads", choices=["physical", "logical"],
                   default="physical",
                   help="how -T0 resolves the worker count")
    p.add_argument("--priority", choices=["rt"], default=None,
                   help="raise process scheduling priority (best effort)")
    p.add_argument("-B", dest="job_size", type=int, default=0, metavar="#",
                   help="with -b: cut input into independent chunks of "
                        "size #; otherwise the -T job size")
    p.add_argument("-S", dest="bench_separate", action="store_true",
                   help="with -b: one benchmark result per input file")
    p.add_argument("--size-hint", dest="size_hint", type=int, default=None,
                   metavar="#",
                   help="approximate streaming input size for parameter "
                        "selection")
    p.add_argument("--stream-size", dest="stream_size", type=int,
                   default=None, metavar="#",
                   help="exact size of the streaming input (mismatch is "
                        "an error, like the reference)")
    p.add_argument("--long", nargs="?", const=27, type=int, metavar="windowLog")
    p.add_argument("--patch-from", dest="patch_from", metavar="FILE")
    p.add_argument("--adapt", nargs="?", const="", metavar="min=#,max=#",
                   dest="adapt")
    p.add_argument("--rsyncable", action="store_true",
                   help="content-defined frame boundaries so rsync "
                        "re-transfers only changed regions")
    p.add_argument("--output-dir-flat", dest="output_dir_flat", metavar="DIR",
                   help="write all output files into DIR (basenames only)")
    p.add_argument("--output-dir-mirror", dest="output_dir_mirror",
                   metavar="DIR",
                   help="recreate the source directory structure under DIR")
    p.add_argument("--exclude-compressed", dest="exclude_compressed",
                   action="store_true",
                   help="compress only files that are not already compressed")
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--engine", choices=["auto", "gpu", "tpu", "host"],
                   default="auto",
                   help="auto = host = the host codec; gpu (or tpu) = the "
                        "device encode at levels 1-2 and the device decode")
    p.add_argument("--trace", metavar="FILE",
                   help="log one CSV row per (de)compression to FILE "
                        "(zstdcli_trace.c schema)")
    p.add_argument("-r", dest="recursive", action="store_true",
                   help="operate recursively on directories")
    p.add_argument("--filelist", metavar="FILE", action="append", default=[],
                   help="read additional input paths from FILE")
    p.add_argument("--no-mtime", dest="no_mtime", action="store_true",
                   help="do not mirror source mtime onto the output file")
    p.add_argument("--target-compressed-block-size", dest="target_cblock",
                   type=int, default=None, metavar="#",
                   help="aim compressed blocks at this size (superblock)")
    p.add_argument("-M", "--memory", type=int, default=None, metavar="#",
                   help="decompression memory limit: <=31 is a windowLog "
                        "cap, larger values are MiB (reference -M#)")
    p.add_argument("--format", choices=["zstd", "gzip", "xz", "lzma",
                                        "lz4"],
                   default="zstd",
                   help="compress to this format (gzip/xz/lzma/lz4 "
                        "passthrough codecs; decompression sniffs the "
                        "magic regardless)")
    for lvl in range(1, 23):
        p.add_argument(f"-{lvl}", dest="level", action="store_const",
                       const=lvl, help=argparse.SUPPRESS)
    p.add_argument("--fast", nargs="?", const=1, type=int, metavar="#")
    p.add_argument("--ultra", action="store_true")
    p.set_defaults(level=None)
    return p


def _on_device(args) -> bool:
    """--engine gpu (or its other name tpu) and nothing else: auto is the
    host codec, and no environment variable changes that."""
    return args.engine in ("gpu", "tpu")


def _compress_adaptive(data: bytes, args) -> bytes:
    """--adapt fallback for in-memory/stdin inputs, where no I/O queues
    exist to observe: the level adapts against the pipeline's own recent
    throughput EMA. Real files take the fileio_async.compress_file_adaptive
    path instead, whose feedback is the async reader/writer queue fill —
    the actual FIO_compressZstdFrame mechanism (fileio.c:1490,
    ZSTD_getFrameProgression feedback). Output is standard multi-frame
    zstd either way."""
    lo, hi = 1, 19
    for part in (args.adapt or "").split(","):
        if part.startswith("min="):
            lo = int(part[4:])
        elif part.startswith("max="):
            hi = int(part[4:])
    level = args.level if args.level is not None else 3
    if args.fast is not None:
        level = -args.fast
    level = min(max(level, lo), hi)
    window_log = args.long if args.long else None
    out = bytearray()
    chunk = 4 * 1024 * 1024
    ema_mbps = None
    for i in range(0, max(len(data), 1), chunk):
        piece = data[i : i + chunk]
        t0 = time.time()
        out += compress(piece, level=level, checksum=not args.no_check,
                        window_log=window_log,
                        long_mode=args.long is not None)
        dt = max(time.time() - t0, 1e-6)
        mbps = len(piece) / dt / 1e6
        if ema_mbps is None:
            ema_mbps = mbps
        if mbps < ema_mbps * 0.6 and level > lo:
            level -= 1
        elif mbps > ema_mbps * 1.1 and level < hi:
            level += 1
        ema_mbps = 0.7 * ema_mbps + 0.3 * mbps
    return bytes(out)


def _compress_bytes(data: bytes, args) -> bytes:
    level = args.level if args.level is not None else 3
    if args.fast is not None:
        level = -args.fast
    checksum = not args.no_check
    if args.format == "gzip":
        import gzip
        return gzip.compress(data, compresslevel=min(max(level, 1), 9))
    if args.format == "lz4":
        from .lz4frame import compress_lz4
        return compress_lz4(data, content_checksum=checksum)
    if args.format in ("xz", "lzma"):
        import lzma
        fmt = lzma.FORMAT_XZ if args.format == "xz" else lzma.FORMAT_ALONE
        return lzma.compress(data, format=fmt,
                             preset=min(max(level, 0), 9))
    if args.adapt is not None:
        return _compress_adaptive(data, args)
    if args.patch_from:
        from .format.codec import compress_patch
        patch = open(args.patch_from, "rb").read()
        return compress_patch(data, patch, level=level, checksum=checksum)
    if args.rsyncable and args.dictionary is None and not args.long:
        # content-defined frame boundaries (ZSTD_c_rsyncable analog,
        # zstdmt_compress.c:1284: rsyncBits tracks the job size = 4x window)
        from .params import get_cparams
        from .parallel.pzstd import pzstd_compress
        rlog = min(max(get_cparams(level, len(data)).window_log + 2, 19), 24)
        return pzstd_compress(data, level=level, checksum=checksum,
                              workers=max(args.threads, 1), rsync_log=rlog)
    # multi-frame parallel output only on an EXPLICIT -T#: the reference's
    # default (-T0) stays single-frame (zstdmt windows share one frame), so
    # silently switching frame structure on size alone would diverge in
    # --list output and ratio
    nb_workers = args.threads
    if nb_workers > 1 and args.dictionary is None and not args.long:
        # -T#: pzstd-style parallel independent frames (multi-frame output
        # any decoder reads; zstd's contrib/pzstd/Pzstd.cpp:73)
        from .parallel.pzstd import pzstd_compress
        return pzstd_compress(data, level=level, checksum=checksum,
                              workers=nb_workers)
    if _on_device(args) and level <= 2 and args.dictionary is None:
        from . import pipeline
        return pipeline.compress(data, level=max(level, 1), checksum=checksum,
                                 device=args.device)
    if args.dictionary:
        import copy
        from .dictionary import load_dictionary, compress_with_dict
        d = load_dictionary(open(args.dictionary, "rb").read())
        if args.no_dict_id and d.dict_id:
            d = copy.copy(d)
            d.dict_id = 0
        return compress_with_dict(data, d, level=level, checksum=checksum)
    window_log = args.long if args.long else None
    return compress(data, level=level, checksum=checksum,
                    window_log=window_log, long_mode=args.long is not None,
                    target_cblock_size=args.target_cblock)


_GZIP_MAGIC = b"\x1f\x8b"
_XZ_MAGIC = b"\xfd7zXZ\x00"
_LZMA_MAGIC = b"\x5d\x00\x00"
_LZ4_MAGIC = b"\x04\x22\x4d\x18"


def _sniff_passthrough(data: bytes):
    """Multi-format magic sniff on decompression (FIO_decompressFrames,
    zstd's programs/fileio.c:2721; passthrough codecs :1213-1445).
    Returns decoded bytes for a foreign format, None for zstd/unknown.
    Bytes after the last lz4 frame are an error."""
    if data[:2] == _GZIP_MAGIC:
        import gzip
        return gzip.decompress(data)
    if data[:6] == _XZ_MAGIC:
        import lzma
        return lzma.decompress(data, format=lzma.FORMAT_XZ)
    if data[:3] == _LZMA_MAGIC and len(data) > 13:
        import lzma
        return lzma.decompress(data, format=lzma.FORMAT_ALONE)
    if data[:4] == _LZ4_MAGIC:
        from .lz4frame import decompress_lz4
        parts = []
        pos = 0
        while pos < len(data) and data[pos : pos + 4] == _LZ4_MAGIC:
            content, pos = decompress_lz4(data, pos)
            parts.append(content)
        if pos < len(data):
            raise ZstdError(ZstdErrorCode.prefix_unknown,
                            f"{len(data) - pos} bytes after the last lz4 "
                            "frame")
        return b"".join(parts)
    return None


def _decompress_bytes(data: bytes, args) -> bytes:
    if args.memory:
        # <=31: a windowLog cap directly; larger: a MiB budget (ref -M#)
        wlog_max = (args.memory if args.memory <= 31
                    else max((args.memory * (1 << 20)).bit_length() - 1, 10))
    else:
        wlog_max = args.long if args.long else 27
    other = _sniff_passthrough(data)
    if other is not None:
        return other
    if _on_device(args) and not args.dictionary and not args.patch_from:
        # device decode path (batched Huffman + pointer-doubling exec)
        from .device_decoder import device_decompress
        return device_decompress(data, window_log_max=wlog_max,
                                 device=args.device)
    if args.threads > 1 and not args.dictionary and not args.patch_from:
        from .parallel.pzstd import pzstd_decompress
        return pzstd_decompress(data, workers=args.threads,
                                window_log_max=wlog_max)
    if args.patch_from:
        from .format.codec import decompress_patch
        patch = open(args.patch_from, "rb").read()
        return decompress_patch(data, patch, window_log_max=max(wlog_max, 31))
    if args.dictionary:
        from .dictionary import load_dictionary, decompress_with_dict
        d = load_dictionary(open(args.dictionary, "rb").read())
        return decompress_with_dict(data, d, window_log_max=wlog_max)
    return decompress(data, window_log_max=wlog_max)


_FMT_SUFFIX = {"zstd": ".zst", "gzip": ".gz", "xz": ".xz", "lzma": ".lzma",
               "lz4": ".lz4"}


def _out_name_compress(name: str, fmt: str = "zstd") -> str:
    return name + _FMT_SUFFIX.get(fmt, ".zst")


def _out_name_decompress(name: str) -> str:
    for suf in (".zst", ".zstd", ".gz", ".xz", ".lzma", ".lz4"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name + ".out"


# suffixes --exclude-compressed skips (zstdcli.c compressedFileExtensions)
_COMPRESSED_SUFFIXES = (".zst", ".zstd", ".gz", ".gzip", ".xz", ".lzma",
                        ".lz4", ".bz2", ".7z", ".zip")


def _dest_path(default_name: str, args) -> str:
    """Resolve the output path (zstdcli --output-dir-flat /
    --output-dir-mirror; UTIL_mirrorSourceFilesDirectories role)."""
    if args.output:
        return args.output
    if args.output_dir_flat:
        os.makedirs(args.output_dir_flat, exist_ok=True)
        return os.path.join(args.output_dir_flat,
                            os.path.basename(default_name))
    if args.output_dir_mirror:
        rel = default_name.lstrip(os.sep)
        parts = [p for p in rel.split(os.sep) if p and p != ".."]
        dest = os.path.join(args.output_dir_mirror, *parts)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        return dest
    return default_name


def _do_list(files, args) -> int:
    from .format.frame import parse_frame_header, is_skippable
    from .constants import ZSTD_MAGIC
    print(f"{'Frames':>6} {'Skips':>5} {'Compressed':>12} "
          f"{'Uncompressed':>13} {'Ratio':>6} {'Check':>5} Filename")
    rc = 0
    for f in files:
        try:
            data = open(f, "rb").read()
        except OSError as e:
            _err(str(e))
            rc = 1
            continue
        pos = frames = skips = 0
        total_unc = 0
        known = True
        check = "None"
        try:
            while pos < len(data):
                if is_skippable(data, pos):
                    size = int.from_bytes(data[pos + 4 : pos + 8], "little")
                    pos += 8 + size
                    skips += 1
                    continue
                hdr = parse_frame_header(data[pos:], 31)
                frames += 1
                if hdr.checksum_flag:
                    check = "XXH64"
                if hdr.frame_content_size is None:
                    known = False
                else:
                    total_unc += hdr.frame_content_size
                # walk blocks to find frame end
                p = pos + hdr.header_size
                last = False
                while not last:
                    bh = int.from_bytes(data[p : p + 3], "little")
                    last = bool(bh & 1)
                    btype = (bh >> 1) & 3
                    bsize = bh >> 3
                    p += 3 + (1 if btype == 1 else bsize)
                if hdr.checksum_flag:
                    p += 4
                pos = p
        except Exception as e:
            _err(f"{f}: could not parse: {e}")
            rc = 1
            continue
        unc = str(total_unc) if known else "unknown"
        ratio = f"{total_unc / len(data):.3f}" if known and len(data) else "-"
        print(f"{frames:>6} {skips:>5} {len(data):>12} {unc:>13} "
              f"{ratio:>6} {check:>5} {f}")
    return rc


def _do_bench(files, args) -> int:
    """zstd -b# analog (benchzstd.c BMK_benchFilesAdvanced): iterated
    best-of timing over a minimum window, compress and decompress;
    -e# sweeps the level range, -i# sets the timing window."""
    start = args.bench if args.bench is not None else 3
    end = args.bench_end if args.bench_end is not None else start
    min_secs = args.bench_secs if args.bench_secs is not None else \
        (1.0 if args.verbose else 0.4)
    def chunks(data: bytes) -> list[bytes]:
        if args.job_size and args.job_size > 0:
            b = args.job_size
            return [data[i : i + b] for i in range(0, len(data), b)]
        return [data]

    def _time_best(fn, min_secs: float) -> float:
        """benchfn.c-grade timing: one UNTIMED warmup (absorbs jit
        compiles / cold caches), then adaptive batching so each timed
        sample spans >= ~40 ms (a sub-ms op is looped; per-call Python
        dispatch amortizes out), min-of-samples over the window."""
        fn()                                   # warmup, excluded
        t0 = time.perf_counter()
        fn()
        est = time.perf_counter() - t0
        loops = max(1, int(0.04 / est)) if est > 0 else 64
        best = est if loops == 1 else float("inf")
        elapsed = est
        while elapsed < min_secs:
            t0 = time.perf_counter()
            for _ in range(loops):
                fn()
            dt = time.perf_counter() - t0
            best = min(best, dt / loops)
            elapsed += dt
        return best

    def run_one(label: str, data: bytes, level: int) -> tuple:
        parts = chunks(data)
        blobs = [_compress_bytes(p, args) for p in parts]   # result

        def do_c():
            blobs[:] = [_compress_bytes(p, args) for p in parts]

        ct = _time_best(do_c, min_secs)
        outs = [_decompress_bytes(b, args) for b in blobs]

        def do_d():
            outs[:] = [_decompress_bytes(b, args) for b in blobs]

        dtm = _time_best(do_d, min_secs)
        assert b"".join(outs) == data, "round-trip mismatch"
        csize = sum(len(b) for b in blobs)
        print(f"{level:>2}#{label:>18} :{len(data):>9} -> "
              f"{csize:>9} ({len(data)/csize:6.3f}), "
              f"{len(data)/ct/1e6:6.1f} MB/s, "
              f"{len(data)/dtm/1e6:6.1f} MB/s")
        return len(data), csize, ct, dtm

    for level in range(start, max(start, end) + 1):
        args.level = level
        if len(files) > 1 and not args.bench_separate:
            # consolidated result over the whole file set (reference
            # default; -S switches to one row per file)
            data = b"".join(open(f, "rb").read() for f in files)
            run_one(f"{len(files)} files", data, level)
            continue
        for f in files:
            run_one(os.path.basename(f), open(f, "rb").read(), level)
    return 0


def _do_train(files, args) -> int:
    from .dict_builder.fastcover import train_from_samples
    from .dict_builder.zdict import finalize_dictionary
    samples = [open(f, "rb").read() for f in files]
    if not samples:
        _err("no training files")
        return 1
    if args.opt_cover:
        from .dict_builder.cover import optimize_train
        raw, params = optimize_train(samples, max_dict_size=args.maxdict,
                                     cover=args.train_cover)
        if not args.quiet:
            print(f"optimized parameters: k={params['k']} d={params['d']}")
    elif args.train_cover or args.train_legacy:
        # --train-legacy routes to COVER: the divsufsort-based legacy
        # analysis is a documented non-goal; COVER is the closest
        # exhaustive trainer
        from .dict_builder.cover import train_from_samples_cover
        raw = train_from_samples_cover(samples, max_dict_size=args.maxdict)
    else:
        raw = train_from_samples(samples, max_dict_size=args.maxdict)
    dict_bytes = finalize_dictionary(raw, samples, dict_id=args.dictID,
                                     level=args.level or 3)
    out = args.output or "dictionary"
    with open(out, "wb") as fh:
        fh.write(dict_bytes)
    if not args.quiet:
        print(f"Save dictionary of size {len(dict_bytes)} into file {out}")
    return 0


def _expand_inputs(args) -> list[str]:
    """Input list: positional files + --filelist entries, with -r expanding
    directories recursively (fileio.c UTIL directory traversal analog)."""
    paths = list(args.files)
    for fl in args.filelist:
        with open(fl) as fh:
            paths += [ln.strip() for ln in fh if ln.strip()]
    out: list[str] = []
    for p in paths:
        if p != "-" and os.path.isdir(p):
            if args.recursive:
                for root, _dirs, names in os.walk(p):
                    out += sorted(os.path.join(root, x) for x in names)
            else:
                _err(f"{p} is a directory -- ignored (use -r)")
        else:
            out.append(p)
    return out or ["-"]


def _mirror_stat(src: str, dst: str, args) -> None:
    """Copy permissions and (unless --no-mtime) timestamps from src to dst
    (fileio.c FIO_copyFilePermissions / UTIL_setFileStat analog)."""
    try:
        st = os.stat(src)
        os.chmod(dst, st.st_mode & 0o7777)
        if not args.no_mtime:
            os.utime(dst, ns=(st.st_atime_ns, st.st_mtime_ns))
    except OSError:
        pass


def _do_zstdgrep(argv: list[str]) -> int:
    """zstdgrep: grep through compressed files (programs/zstdgrep analog).
    Usage: zstdgrep [grep options] PATTERN FILE..."""
    import subprocess
    files = [a for a in argv if not a.startswith("-")][1:]
    head = [a for a in argv if a not in files]
    rc = 1
    for f in files or []:
        data = open(f, "rb").read()
        if f.endswith((".zst", ".zstd")):
            data = decompress(data)
        r = subprocess.run(["grep", *head, "--label", f, "-H"],
                           input=data, stdout=None)
        rc = min(rc, r.returncode)
    return rc


def _do_zstdless(argv: list[str]) -> int:
    """zstdless: view compressed files through $PAGER (zstdless analog)."""
    import subprocess
    pager = os.environ.get("PAGER", "less")
    rc = 0
    for f in argv:
        if f.startswith("-"):
            continue
        data = open(f, "rb").read()
        if f.endswith((".zst", ".zstd")):
            data = decompress(data)
        r = subprocess.run([pager], input=data)
        rc = max(rc, r.returncode)
    return rc


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the command line on `argv` (default sys.argv[1:]). `device` is
    where --engine gpu runs: None is the CUDA card (raises where there is
    none); the tests pass "cpu"."""
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = os.path.basename(sys.argv[0]) if sys.argv else "zstd"
    # zstdgrep/zstdless dispatch BEFORE option parsing: these personalities
    # forward arbitrary grep/pager flags (-i, -E, -A2, ...) verbatim, which
    # the zstd parser would otherwise reject or consume with zstd semantics
    # (reference: programs/zstdgrep passes "$@" straight to grep)
    if prog == "zstdgrep":
        return _do_zstdgrep(argv)
    if prog == "zstdless":
        return _do_zstdless(argv)
    parser = build_parser(prog)
    args = parser.parse_args(argv)
    args.device = device
    if args.trace:
        from .trace import GLOBAL_TRACER
        GLOBAL_TRACER.open_csv(args.trace)
    if args.priority == "rt":
        try:                        # best effort (needs privileges)
            os.nice(-20)
        except OSError:
            pass
    if args.single_thread:
        args.threads = 1

    # multi-personality (zstdcli.c:913-927)
    if prog in ("unzstd", "zstdcat"):
        args.decompress = True
    if prog == "zstdcat":
        args.stdout = True

    if args.show_help:
        parser.print_help()
        return 0
    if args.version:
        from . import __version__
        print(f"*** zstd_tpu_torch (Zstandard on PyTorch/CUDA) "
              f"v{__version__} ***")
        return 0
    if args.list:
        return _do_list(args.files, args)
    if args.bench is not None:
        args.level = args.bench
        return _do_bench(args.files, args)
    if (args.train or args.train_cover or args.train_fastcover
            or args.train_legacy or args.opt_cover):
        return _do_train(args.files, args)

    mode = "decompress" if (args.decompress or args.test) else "compress"
    files = _expand_inputs(args)
    rc = 0
    for f in files:
        try:
            if (args.exclude_compressed and mode == "compress"
                    and f.endswith(_COMPRESSED_SUFFIXES)):
                continue
            plain = (args.dictionary is None and args.patch_from is None
                     and args.adapt is None and args.threads <= 1
                     and not args.rsyncable
                     and not args.long and not args.test
                     and not args.stdout and args.fast is None
                     and args.engine == "auto"
                     and args.target_cblock is None
                     and args.format == "zstd"
                     and f != "-")
            if (args.adapt is not None and mode == "compress"
                    and args.format == "zstd"
                    and not args.stdout and f != "-" and os.path.isfile(f)
                    and os.path.getsize(f) >= (8 << 20)
                    and args.dictionary is None and args.patch_from is None):
                # --adapt on a large file: level feedback from the async
                # I/O queue fill (FIO_compressZstdFrame's progression loop)
                from .fileio_async import compress_file_adaptive
                lo, hi = 1, 19
                for part in (args.adapt or "").split(","):
                    if part.startswith("min="):
                        lo = int(part[4:])
                    elif part.startswith("max="):
                        hi = int(part[4:])
                out = _dest_path(_out_name_compress(f, args.format), args)
                if os.path.exists(out) and not args.force:
                    _err(f"{out} already exists; use -f to overwrite")
                    rc = 1
                    continue
                level = args.level if args.level is not None else 3
                if args.fast is not None:
                    level = -args.fast
                compress_file_adaptive(
                    f, out, level=level, lo=lo, hi=hi,
                    checksum=not args.no_check,
                    window_log=args.long if args.long else None,
                    long_mode=args.long is not None)
                _mirror_stat(f, out, args)
                if args.rm:
                    os.unlink(f)
                continue
            if plain and mode == "decompress" and os.path.isfile(f):
                with open(f, "rb") as fh:
                    head = fh.read(8)
                if (head[:2] == _GZIP_MAGIC or head[:6] == _XZ_MAGIC
                        or head[:3] == _LZMA_MAGIC or head[:4] == _LZ4_MAGIC):
                    plain = False   # foreign format: whole-buffer passthrough
            if plain and not args.single_thread and os.path.isfile(f) and \
                    os.path.getsize(f) >= (8 << 20):
                # large plain files stream through the async read-ahead /
                # write-behind pipeline (fileio_asyncio.c analog)
                from .fileio_async import (compress_file_async,
                                           decompress_file_async)
                out = _dest_path(_out_name_compress(f)
                                 if mode == "compress"
                                 else _out_name_decompress(f), args)
                if os.path.exists(out) and not args.force:
                    _err(f"{out} already exists; use -f to overwrite")
                    rc = 1
                    continue
                if mode == "compress":
                    compress_file_async(f, out,
                                        level=args.level
                                        if args.level is not None else 3,
                                        checksum=not args.no_check)
                else:
                    wlog = args.memory if args.memory else 27
                    decompress_file_async(f, out, window_log_max=wlog)
                _mirror_stat(f, out, args)
                if args.rm:
                    os.unlink(f)
                continue
            if f == "-":
                data = sys.stdin.buffer.read()
                if (args.stream_size is not None and mode == "compress"
                        and len(data) != args.stream_size):
                    _err(f"stream size mismatch: got {len(data)}, "
                         f"--stream-size said {args.stream_size}")
                    rc = 1
                    continue
            else:
                data = open(f, "rb").read()
            if mode == "compress":
                result = _compress_bytes(data, args)
                default_out = _out_name_compress(f, args.format)
            else:
                result = _decompress_bytes(data, args)
                default_out = _out_name_decompress(f)
            if args.test:
                if args.verbose:
                    print(f"{f}: OK", file=sys.stderr)
                continue
            if args.stdout or f == "-":
                sys.stdout.buffer.write(result)
            else:
                out = _dest_path(default_out, args)
                if os.path.exists(out) and not args.force:
                    _err(f"{out} already exists; use -f to overwrite")
                    rc = 1
                    continue
                with open(out, "wb") as fh:
                    fh.write(result)
                if f != "-":
                    _mirror_stat(f, out, args)
                if args.verbose and mode == "compress":
                    print(f"{f} :{100*len(result)/max(len(data),1):6.2f}%   "
                          f"({len(data)} => {len(result)} bytes, {out})",
                          file=sys.stderr)
                if args.rm and f != "-":
                    os.unlink(f)
        except Exception as e:
            _err(f"{f}: {e}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
