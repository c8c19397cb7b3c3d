"""Build and load the hand-written CUDA kernels in csrc/ and the host C in
csrc/host/.

Each csrc/*.cu is compiled on first use by its own nvcc process (all started
together) into a shared library with a plain C interface under _build/, and
loaded with ctypes. All of csrc/host/*.c is one host library, built by one
process of the host C compiler (`cc`), as native/Makefile links native/*.c
into one library: cblock.c calls the parsers and entropy coders of the
other files, and plan.c (the device encode's batch planner) the FSE and
Huffman pieces of huf.c and encode.c. A library is rebuilt when a source
changes (the sources' hash is part of the file name). Nothing here runs at
import time, so the package imports on machines without nvcc or a GPU. A
missing compiler or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("extract.cu", "fse_chain.cu", "huf_decode.cu", "exec_seq.cu",
           "lazy_resolve.cu", "xla_walk.cu", "ldm_fingerprint.cu",
           "ldm_lookback.cu", "seq_merge.cu", "seq_finish.cu")
HOST_SOURCES = ("host/cblock.c", "host/decode.c", "host/encode.c",
                "host/fast.c", "host/huf.c", "host/lazy.c", "host/ldm.c",
                "host/lz4.c", "host/opt.c", "host/plan.c", "host/row.c",
                "host/xxh64.c")
HOST_LIB = "host"

SMEM_LIMIT = 232448   # dynamic shared memory an H100 block may use (bytes)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# native/Makefile's flags without -march=native: the host C is integer-only,
# and a library built for this host's ISA could fault on another
CC_FLAGS = ["-O3", "-std=gnu11", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (each returns an int: a cudaError_t for
# the launches, a size or a count for the others)
_SIGNATURES = {
    "extract.cu": {"extract_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _I, _I, _I, _P],
                   "extract_scratch_bytes": [_I],
                   "extract_smem_bytes": [_I]},
    "fse_chain.cu": {"fse_chain_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _P, _P, _P, _P, _I, _I, _P],
                     "fse_chain_scratch_bytes": [_I],
                     "fse_chain_smem_bytes": [_I]},
    "huf_decode.cu": {"huf_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                            _L, _P, _P, _I, _I, _I, _I, _P,
                                            _P, _P, _P, _I, _I, _L, _P],
                      "huf_decode_smem_bytes": [_I],
                      "huf_decode_threads": [_I]},
    "exec_seq.cu": {"exec_seq_launch": [_P, _I, _P, _P, _P, _P, _I, _P, _P,
                                        _P, _P, _P, _I, _P, _P, _P, _P, _I,
                                        _I, _I, _P],
                    "exec_seq_ctrl_len": [],
                    "exec_seq_stats_len": []},
    "lazy_resolve.cu": {"lazy_resolve_launch": [_P, _P, _P, _P, _P, _P, _P,
                                                _I, _I, _I, _I, _P]},
    "xla_walk.cu": {"xla_walk_launch": [_P] * 14 + [_I, _I, _I, _I, _P],
                    "xla_walk_scratch_bytes": [_I, _I],
                    "xla_walk_max_clusters": [_I, _I]},
    "ldm_fingerprint.cu": {"ldm_fingerprint_launch": [_P, _I, _I, _P, _P,
                                                      _P]},
    "ldm_lookback.cu": {"ldm_lookback_launch": [_P, _I, _I, _I, _P, _P,
                                                _P]},
    "seq_merge.cu": {"seq_merge_launch": [_P] * 10 + [_I] * 5 + [_P],
                     "seq_merge_scratch_ints": [_I] * 4,
                     "seq_merge_max_clusters": [_I] * 4},
    "seq_finish.cu": {"seq_finish_launch": [_P] * 14 + [_I] * 4 + [_P],
                      "seq_finish_scratch_ints": [_I, _I, _I],
                      "seq_finish_max_clusters": [_I, _I, _I]},
}
# host C entry points: name -> (restype, argtypes)
_I64 = ctypes.c_int64
_HOST_SIGNATURES = {
    "zt_fast_fill": (None, [_P, _L, _L, _I, _I, _P]),
    "zt_fast_parse": (_I64, [_P, _L, _L, _L, _P, _P, _P, _P, _L,
                             _I, _I, _I, _I, _P]),
    "zt_dfast_fill": (None, [_P, _L, _L, _I, _I, _P, _P]),
    "zt_dfast_parse": (_I64, [_P, _L, _L, _L, _P, _P, _P, _P, _L,
                              _I, _I, _I, _P, _P]),
    "zt_lazy_fill": (None, [_P, _L, _L, _I, _I, _I, _P, _P]),
    "zt_lazy_fill_long": (None, [_P, _L, _L, _I, _P]),
    "zt_lazy_parse": (_I64, [_P, _L, _L, _L, _P, _P, _P, _P, _L,
                             _I, _I, _I, _I, _I, _I, _P, _P, _P, _I]),
    "zt_ldm_walk": (_I64, [_P, _L, _L, _L, _P, _P, _L, _L, _I, _L, _L, _P]),
    "zt_ldm_gap_parse": (_I64, [_P, _L, _L, _L, _L, _P, _L, _P,
                                _I, _I, _I, _I, _I, _I, _P, _P, _P, _L,
                                _P, _P, _P, _L, _P, _P]),
    "zt_row_fill": (None, [_P, _L, _L, _I, _I, _I, _P, _P, _P, _P, _I]),
    "zt_row_parse": (_I64, [_P, _L, _L, _L, _P, _P, _P, _P, _L,
                            _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I]),
    "zt_opt_parse": (_I64, [_P, _L, _L, _L, _P, _P, _P, _P, _L,
                            _I, _I, _I, _I, _I]),
    "zt_opt_parse_ctx": (_I64, [_P, _P, _L, _L, _L, _L, _P, _P, _P, _P, _L,
                                _I, _I, _I, _I, _I]),
    "zt_opt_ctx_new": (_P, []),
    "zt_opt_ctx_free": (None, [_P]),
    "zt_opt_ctx_clone": (_I, [_P, _P, _L]),
    "zt_opt_ctx_copy_prices": (None, [_P, _P]),
    "zt_opt_knob_twopass": (None, [_I]),
    "zt_compress_fast_frame": (_I64, [_P, _L, _L, _L, _L, _I, _I, _I, _I,
                                      _I, _P, _P, _P, _L]),
    "zt_compress_dp_frame": (_I64, [_P, _L, _L, _L, _L, _I, _P,
                                    _I, _I, _I, _I, _P, _L]),
    "zt_compress_row_frame": (_I64, [_P, _L, _L, _L, _L, _I, _P,
                                     _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                     _P, _L]),
    "zt_split_points": (_I64, [_P, _L, _L, _L, _L, _P, _L]),
    # the block decoder (decode.c)
    "zt_dctx_new": (_P, []),
    "zt_dctx_free": (None, [_P]),
    "zt_decompress_block": (_I64, [_P, _P, _L, _P, _L, _L, _L, _L]),
    "zt_decompress_blocks": (_I64, [_P, _P, _L, _P, _L, _L, _L, _L, _P]),
    "zt_parse_frame": (_I64, [_P, _L, _L, _L, _P, _L, _P, _P, _L, _P, _L,
                              _P, _L, _P, _P, _P, _L, _P]),
    "zt_xxh64": (ctypes.c_uint64, [_P, ctypes.c_size_t, ctypes.c_uint64]),
    "zt_xxh64_state_size": (ctypes.c_size_t, []),
    "zt_xxh64_reset": (None, [_P, ctypes.c_uint64]),
    "zt_xxh64_update": (None, [_P, _P, ctypes.c_size_t]),
    "zt_xxh64_digest": (ctypes.c_uint64, [_P]),
    # the lz4 block codec and XXH32 (lz4.c)
    "zt_lz4_block_compress": (_I64, [_P, _I64, _P, _I64]),
    "zt_lz4_block_decompress": (_I64, [_P, _I64, _P, _I64, _I64]),
    "zt_xxh32": (ctypes.c_uint32, [_P, _I64, ctypes.c_uint32]),
    # the entropy planning and encoders (huf.c, encode.c)
    "zt_fse_normalize": (_I64, [_P, _I, _L, _I, _I, _P]),
    "zt_fse_write_ncount": (_I64, [_P, _I, _I, _P, _L]),
    "zt_fse_build_ctable": (_I64, [_P, _I, _I, _P, _P, _P]),
    "zt_fse_compress_2state": (_I64, [_P, _L, _I, _P, _P, _P, _P, _L]),
    "zt_huf_build_write": (_I64, [_P, _I, _I, _P, _P, _P, _L, _P]),
    "zt_huf_encode": (_I64, [_P, _L, _P, _P, _P, _L]),
    "zt_huf_encode4": (_I64, [_P, _L, _P, _P, _P, _L]),
    "zt_encode_sequences": (_I64, [_L] + [_P] * 8
                            + [_I, _P, _P, _P] * 3 + [_P, _L]),
    # the device encode's batch planner (plan.c)
    "zt_plan_batch": (_I64, [_P, _L, _P, _L, _I] + [_P] * 6
                      + [_P, _L, _P, _L, _P, _L]),
}

# launch counts, one per kernel: each wrapper adds one where it launches its
# kernel (and nowhere else), so a run can show which kernels it went through
LAUNCHES = {"extract": 0, "fse_chain": 0, "huf_decode": 0, "exec_seq": 0,
            "lazy_resolve": 0, "xla_walk": 0, "ldm_fingerprint": 0,
            "ldm_lookback": 0, "seq_merge": 0, "seq_finish": 0}

CTAS = (2, 3, 4)   # the cluster sizes of the kernels that run a row on C CTAs


def fewest_waves(B: int, clusters, held=None) -> int:
    """CTAs a row (one of CTAS) for a launch of B rows, from the clusters of
    each size that the card holds at once (`clusters`, in CTAS' order; a
    count <= 0 rules its size out): a row's work is cut by C, and rows past
    the clusters the card holds run in later waves, so the fewest
    ceil(B / clusters) / C, the larger C on a tie. `held` (in CTAS' order,
    optional) says at which sizes the kernel keeps its row in shared
    memory: where some size does, a size that reads the row from device
    memory is ruled out, since waves do not weigh that slower route."""
    if held is not None and any(h and m > 0 for h, m in zip(held, clusters)):
        clusters = [m if h else 0 for m, h in zip(clusters, held)]
    best, cost = CTAS[0], None
    for c, m in zip(CTAS, clusters):
        if m <= 0:
            continue
        k = -(-B // m) / c
        if cost is None or k <= cost:
            best, cost = c, k
    return best


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # source -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _cc() -> str:
    found = shutil.which("cc")
    if found is None:
        raise RuntimeError("no host C compiler (cc): the host C in "
                           "csrc/host cannot be built")
    return found


def _lib_path(src: str) -> str:
    """The library of one CUDA source, or of HOST_LIB (all HOST_SOURCES)."""
    digest = hashlib.sha256()
    for part in (HOST_SOURCES if src == HOST_LIB else (src,)):
        with open(os.path.join(_CSRC, part), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0].replace("/", "-")
    return os.path.join(_BUILD, f"{stem}-{digest.hexdigest()[:16]}.so")


def _build(libs, compiler, flags, what: str) -> float:
    """Compile every library (a CUDA source, or HOST_LIB) that is not up to
    date, one compiler process per library, all in parallel. Returns the
    wall time spent."""
    t0 = time.time()
    with _lock:
        os.makedirs(_BUILD, exist_ok=True)
        procs = []
        for src in libs:
            out = _lib_path(src)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            parts = HOST_SOURCES if src == HOST_LIB else (src,)
            cmd = [compiler(), *flags, "-o", tmp,
                   *(os.path.join(_CSRC, p) for p in parts)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, out, tmp, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            BUILD_LOG[src] = log
            if p.returncode != 0:
                failed.append(f"{src}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError(f"{what} failed:\n" + "\n".join(failed))
    return time.time() - t0


def build_all() -> float:
    """Compile every CUDA source that has no up-to-date library, one nvcc
    per source, all in parallel. Returns the wall time spent (seconds)."""
    return _build(SOURCES, _nvcc, NVCC_FLAGS, "nvcc")


def build_host() -> float:
    """Compile the host library (all HOST_SOURCES, one cc process) if it is
    not up to date. Returns the wall time spent (seconds)."""
    return _build((HOST_LIB,), _cc, CC_FLAGS, "cc")


def get(src: str) -> ctypes.CDLL:
    """The loaded library of one CUDA source in csrc/, built on first use."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    build_all()
    return _load(src, {name: (ctypes.c_int, argtypes)
                       for name, argtypes in _SIGNATURES[src].items()})


def host() -> ctypes.CDLL:
    """The loaded host library (csrc/host/*.c), built on first use."""
    lib = _libs.get(HOST_LIB)
    if lib is not None:
        return lib
    build_host()
    return _load(HOST_LIB, _HOST_SIGNATURES)


def _load(src: str, sigs: dict) -> ctypes.CDLL:
    with _lock:
        if src not in _libs:
            lib = ctypes.CDLL(_lib_path(src))
            for name, (restype, argtypes) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[src] = lib
    return _libs[src]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
