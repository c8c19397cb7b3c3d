"""Build and load the hand-written CUDA kernels in csrc/ and the host C in
csrc/host/.

Each csrc/*.cu is compiled on first use by its own nvcc process (all started
together) into a shared library with a plain C interface under _build/, and
loaded with ctypes; each csrc/host/*.c likewise with the host C compiler
(`cc`). A library is rebuilt when its source changes (the source's
hash is part of the file name). Nothing here runs at import time, so the
package imports on machines without nvcc or a GPU. A missing compiler or a
failed build raises: nothing falls back.
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
           "ldm_lookback.cu")
HOST_SOURCES = ("host/fast.c",)

SMEM_LIMIT = 232448   # dynamic shared memory an H100 block may use (bytes)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-O2", "-shared", "-fPIC"]

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
}
# host C entry points: name -> (restype, argtypes)
_HOST_SIGNATURES = {
    "host/fast.c": {
        "zt_fast_fill": (None, [_P, _L, _L, _I, _I, _P]),
        "zt_fast_parse": (ctypes.c_int64, [_P, _L, _L, _L, _P, _P, _P, _P,
                                           _L, _I, _I, _I, _I, _P]),
    },
}

# launch counts, one per kernel: each wrapper adds one where it launches its
# kernel (and nowhere else), so a run can show which kernels it went through
LAUNCHES = {"extract": 0, "fse_chain": 0, "huf_decode": 0, "exec_seq": 0,
            "lazy_resolve": 0, "xla_walk": 0, "ldm_fingerprint": 0,
            "ldm_lookback": 0}

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
    with open(os.path.join(_CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(src)[0].replace("/", "-")
    return os.path.join(_BUILD, f"{stem}-{digest}.so")


def _build(sources, compiler, flags, what: str) -> float:
    """Compile every source that has no up-to-date library, one compiler
    process per source, all in parallel. Returns the wall time spent."""
    t0 = time.time()
    with _lock:
        os.makedirs(_BUILD, exist_ok=True)
        procs = []
        for src in sources:
            out = _lib_path(src)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [compiler(), *flags, "-o", tmp, os.path.join(_CSRC, src)]
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
    """Compile the host C sources with cc, as build_all does the CUDA ones."""
    return _build(HOST_SOURCES, _cc, CC_FLAGS, "cc")


def get(src: str) -> ctypes.CDLL:
    """The loaded library of one csrc/ source (a .cu, or host/*.c), built
    on first use."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    host = src in _HOST_SIGNATURES
    (build_host if host else build_all)()
    with _lock:
        if src not in _libs:
            lib = ctypes.CDLL(_lib_path(src))
            sigs = _HOST_SIGNATURES[src] if host else {
                name: (ctypes.c_int, argtypes)
                for name, argtypes in _SIGNATURES[src].items()}
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
