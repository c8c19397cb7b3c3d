"""Dictionary format + dictionary-aware (de)compression.

Copy of zstd_tpu/dictionary.py over the port's host codec. Format parity:
spec "Dictionary Format" (magic 0xEC30A437, dictID, entropy tables in order
Huffman/OF/ML/LL, 3 rep offsets, content); API parity:
ZSTD_compress_usingDict / ZSTD_decompress_usingDict and the digested
CDict/DDict split (zstd's lib/compress/zstd_compress.c dictionary loading,
lib/decompress/zstd_ddict.c:244). Raw-content dictionaries (no magic) are
supported as in zstd.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import (BLOCK_HEADER_SIZE, BLOCK_MAX_SIZE, BT_COMPRESSED,
                        BT_RAW, BT_RESERVED, BT_RLE, DICT_MAGIC,
                        LL_FSE_LOG, MAX_LL_CODE, MAX_ML_CODE, MAX_OFF_CODE,
                        ML_FSE_LOG, OF_FSE_LOG, WINDOWLOG_LIMIT_DEFAULT)
from .errors import Corruption, ZstdError, ZstdErrorCode
from .format import fse, huffman
from .format.block import BlockCState, BlockDState, compress_block, decompress_block
from .format.frame import is_skippable, parse_frame_header, write_frame_header
from .format.literals import HufDecodeState, HufEntropyState, HufRepeat
from .format.sequences import FseDecodeState, FseEntropyState, FSERepeat
from .params import get_cparams
from .xxhash64 import content_checksum


@dataclasses.dataclass
class Dictionary:
    """Digested dictionary: content + prebuilt entropy tables (CDict/DDict)."""
    dict_id: int
    content: bytes
    reps: tuple[int, int, int]
    # decode side
    huf_dtable: huffman.HufDTable | None
    dt_of: fse.DTable | None
    dt_ml: fse.DTable | None
    dt_ll: fse.DTable | None
    # encode side
    huf_ctable: huffman.HufCTable | None
    ct_of: fse.CTable | None
    ct_ml: fse.CTable | None
    ct_ll: fse.CTable | None
    # encode-side usability: repeat mode is only safe when the dict table
    # fully covers the code alphabet (ZSTD_loadCEntropy's checkDictNCount)
    huf_full: bool = False
    of_cov_max: int = -1   # highest offset code with nonzero probability,
                           # -1 unless codes 0..max are all covered
    ml_full: bool = False
    ll_full: bool = False


def load_dictionary(data: bytes) -> Dictionary:
    """Parse a zstd-format dictionary; fall back to raw-content semantics."""
    if len(data) < 8:
        raise ZstdError(ZstdErrorCode.dictionary_corrupted, "dictionary too small")
    magic = int.from_bytes(data[:4], "little")
    if magic != DICT_MAGIC:
        return Dictionary(0, data, (1, 4, 8), None, None, None, None,
                          None, None, None, None)
    dict_id = int.from_bytes(data[4:8], "little")
    pos = 8
    try:
        nb_bits, nb_symbols, tlog, consumed = huffman.read_tree_description(data[pos:])
        huf_dt = huffman.build_huf_dtable(nb_bits, nb_symbols, tlog)
        huf_ct = huffman.ctable_from_nbbits(nb_bits, tlog)
        pos += consumed

        tables_d = []
        tables_c = []
        full_cov = []
        cov_max = []
        for max_code, max_log in ((MAX_OFF_CODE, OF_FSE_LOG),
                                  (MAX_ML_CODE, ML_FSE_LOG),
                                  (MAX_LL_CODE, LL_FSE_LOG)):
            norm, max_sym, table_log, c = fse.read_ncount(data[pos:], max_code,
                                                          max_log)
            tables_d.append(fse.build_dtable(norm, table_log))
            tables_c.append(fse.build_ctable(norm, max_sym, table_log))
            all_nonzero = bool(np.all(norm[: max_sym + 1] != 0))
            full_cov.append(all_nonzero and max_sym == max_code)
            cov_max.append(max_sym if all_nonzero else -1)
            pos += c

        reps = tuple(int.from_bytes(data[pos + 4 * i : pos + 4 * i + 4], "little")
                     for i in range(3))
        pos += 12
    except Exception as e:
        raise ZstdError(ZstdErrorCode.dictionary_corrupted, str(e))
    content = data[pos:]
    for r in reps:
        if r == 0 or r > len(content):
            raise ZstdError(ZstdErrorCode.dictionary_corrupted,
                            "invalid rep offset in dictionary")
    huf_full = bool(np.all(huf_ct.nb_bits > 0))
    return Dictionary(dict_id, content, reps,
                      huf_dt, tables_d[0], tables_d[1], tables_d[2],
                      huf_ct, tables_c[0], tables_c[1], tables_c[2],
                      huf_full=huf_full, of_cov_max=cov_max[0],
                      ml_full=full_cov[1], ll_full=full_cov[2])


def write_dictionary(dict_id: int, content: bytes,
                     huf_ct: huffman.HufCTable,
                     norm_of: np.ndarray, log_of: int,
                     norm_ml: np.ndarray, log_ml: int,
                     norm_ll: np.ndarray, log_ll: int,
                     reps: tuple[int, int, int] = (1, 4, 8)) -> bytes:
    """Serialize a zstd-format dictionary (ZDICT_finalizeDictionary layout)."""
    out = bytearray(DICT_MAGIC.to_bytes(4, "little"))
    out += dict_id.to_bytes(4, "little")
    out += huffman.write_tree_description(huf_ct)
    out += fse.write_ncount(norm_of, len(norm_of) - 1, log_of)
    out += fse.write_ncount(norm_ml, len(norm_ml) - 1, log_ml)
    out += fse.write_ncount(norm_ll, len(norm_ll) - 1, log_ll)
    for r in reps:
        out += r.to_bytes(4, "little")
    out += content
    return bytes(out)


def _initial_cstate(d: Dictionary, window_log: int) -> BlockCState:
    if d.huf_ctable is None:
        huf = HufEntropyState()
    else:
        huf = HufEntropyState(d.huf_ctable,
                              HufRepeat.VALID if d.huf_full else HufRepeat.CHECK)
    # offsets: repeat is safe only if the table covers every code the window
    # can produce (max offBase = window + 3 -> code == window_log)
    of_ok = d.ct_of is not None and d.of_cov_max >= window_log
    ml_ok = d.ct_ml is not None and d.ml_full
    ll_ok = d.ct_ll is not None and d.ll_full
    fse_state = FseEntropyState(
        d.ct_ll if ll_ok else None,
        d.ct_of if of_ok else None,
        d.ct_ml if ml_ok else None,
        FSERepeat.VALID if ll_ok else FSERepeat.NONE,
        FSERepeat.VALID if of_ok else FSERepeat.NONE,
        FSERepeat.VALID if ml_ok else FSERepeat.NONE)
    return BlockCState(huf, fse_state, d.reps)


def _initial_dstate(d: Dictionary) -> BlockDState:
    return BlockDState(HufDecodeState(d.huf_dtable),
                       FseDecodeState(d.dt_ll, d.dt_of, d.dt_ml),
                       d.reps)


def compress_with_dict(data: bytes, d: Dictionary, level: int = 3,
                       checksum: bool = False) -> bytes:
    """ZSTD_compress_usingDict: dict content as window prefix + dict entropy
    tables as the initial repeat state."""
    n = len(data)
    cparams = get_cparams(level, n, len(d.content))
    out = bytearray(write_frame_header(n, cparams.window_log, checksum,
                                       dict_id=d.dict_id))
    window_size = 1 << cparams.window_log
    block_size = min(window_size, BLOCK_MAX_SIZE)

    if n == 0:
        out += (1 | (BT_RAW << 1)).to_bytes(3, "little")
        if checksum:
            out += content_checksum(b"").to_bytes(4, "little")
        return bytes(out)

    prefix = d.content
    full = np.frombuffer(prefix + data, dtype=np.uint8)
    base = len(prefix)
    state = _initial_cstate(d, cparams.window_log)
    pos = 0
    while pos < n:
        end = min(pos + block_size, n)
        last = end == n
        # dictionary stays addressable until output exceeds window size
        if pos < window_size:
            window_low = 0
        else:
            window_low = base + pos - window_size
        payload, btype, state = compress_block(
            full, base + pos, base + end, window_low, state, cparams)
        if btype == BT_RLE:
            bh = int(last) | (BT_RLE << 1) | ((end - pos) << 3)
        else:
            bh = int(last) | (btype << 1) | (len(payload) << 3)
        out += bh.to_bytes(3, "little")
        out += payload
        pos = end
    if checksum:
        out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)


def decompress_with_dict(data: bytes, d: Dictionary,
                         window_log_max: int = WINDOWLOG_LIMIT_DEFAULT) -> bytes:
    """ZSTD_decompress_usingDict over all frames in `data`."""
    out_all = bytearray()
    pos = 0
    while pos < len(data):
        if is_skippable(data, pos):
            size = int.from_bytes(data[pos + 4 : pos + 8], "little")
            pos += 8 + size
            continue
        hdr = parse_frame_header(data[pos:], window_log_max)
        if hdr.dict_id and d.dict_id and hdr.dict_id != d.dict_id:
            raise ZstdError(ZstdErrorCode.dictionary_wrong,
                            f"frame wants dict {hdr.dict_id}, have {d.dict_id}")
        pos += hdr.header_size
        out = bytearray(d.content)
        base = len(d.content)
        state = _initial_dstate(d)
        block_max = min(hdr.window_size or BLOCK_MAX_SIZE, BLOCK_MAX_SIZE)
        if hdr.single_segment and hdr.frame_content_size is not None:
            block_max = min(max(hdr.frame_content_size, 1), BLOCK_MAX_SIZE)
        last = False
        while not last:
            if pos + BLOCK_HEADER_SIZE > len(data):
                raise ZstdError(ZstdErrorCode.srcSize_wrong, "truncated block")
            bh = int.from_bytes(data[pos : pos + 3], "little")
            pos += 3
            last = bool(bh & 1)
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if btype == BT_RESERVED:
                raise Corruption("reserved block type")
            if btype == BT_RAW:
                out += data[pos : pos + bsize]
                pos += bsize
            elif btype == BT_RLE:
                if bsize > block_max:
                    raise Corruption("RLE block larger than maximum")
                out += data[pos : pos + 1] * bsize
                pos += 1
            else:
                if bsize > block_max or pos + bsize > len(data):
                    raise Corruption("bad compressed block size")
                produced = len(out) - base
                window = hdr.window_size or (1 << 62)
                window_low = 0 if produced < window else len(out) - window
                state = decompress_block(data[pos : pos + bsize], out,
                                         window_low, state, block_max)
                pos += bsize
        content = bytes(out[base:])
        if hdr.frame_content_size is not None and \
                len(content) != hdr.frame_content_size:
            raise Corruption("content size mismatch")
        if hdr.checksum_flag:
            expect = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
            if content_checksum(content) != expect:
                raise ZstdError(ZstdErrorCode.checksum_wrong)
        out_all += content
    return bytes(out_all)
