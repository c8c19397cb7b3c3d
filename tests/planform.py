"""zstd_tpu's host plans in the port's form.

TorchCompressor._build_plans returns a batch's plans as csrc/host/plan.c
writes them: one int64 record a block (native.PLAN_FIELDS) and an arena of
sequences headers and Huffman trees that the records point into, beside the
plan rows. zstd_tpu's _build_plans returns a dict a block, each with a
_LitPlan. The tests put zstd_tpu's plans into the port's form, to compare
the two planners field by field and to patch zstd_tpu's plans into the
port's encode.
"""

import numpy as np

from zstd_tpu_torch import native
from zstd_tpu_torch import pipeline as tpipe

COL = {name: i for i, name in enumerate(native.PLAN_FIELDS)}
KINDS = {"raw": 0, "rle": tpipe._LIT_RLE, "huf": tpipe._LIT_HUF}


def lit_fields(lp) -> dict:
    """The record fields of zstd_tpu's literal plan `lp`: its kind, and for
    a Huffman plan its streams, sizes, tree length and table (0 otherwise,
    as plan.c leaves them)."""
    f = dict(kind=KINDS[lp.kind])
    if lp.kind == "huf":
        f.update(single=int(lp.single), c_size=lp.c_size,
                 tree_len=len(lp.tree_desc), huf_log=lp.ct.table_log,
                 huf_max_symbol=lp.ct.max_symbol)
        f.update((f"size{t}", s) for t, s in enumerate(lp.stream_sizes))
    return f


def records(plans: list) -> tuple:
    """(records int64[B, len(native.PLAN_FIELDS)], arena bytes) of
    zstd_tpu's plan dicts, laid out as plan.c lays them: each block's
    sequences header, then its tree if it has one."""
    rec = np.zeros((len(plans), len(COL)), np.int64)
    arena = bytearray()
    for row, p in zip(rec, plans):
        lp = p["lit_plan"]
        f = lit_fields(lp)
        f.update(est=p["est"], last_count=p["last_count"], nb_seq=p["nb_seq"],
                 nb_lit=p["nb_lit"], all_same=int(p["all_same"]),
                 first_lit=p["first_lit"], hdr_off=len(arena),
                 hdr_len=len(p["seq_header"]))
        arena += p["seq_header"]
        if lp.kind == "huf":
            f["tree_off"] = len(arena)
            arena += lp.tree_desc
        for name, v in f.items():
            row[COL[name]] = v
    return rec, bytes(arena)


def port_form(ref: tuple) -> tuple:
    """zstd_tpu's _build_plans result in the port's: ((records, arena),
    plan rows, cap, out_w_fse, seg_cap, out_w_huf)."""
    plans, *rest = ref
    return (records(plans), *rest)


def huf_table(rec_row: np.ndarray, blob_row: np.ndarray):
    """One block's Huffman table in the port's form, from its record
    (huf_log, huf_max_symbol) and its plan row (code lengths, codes):
    (table_log, max_symbol, nb_bits, value), None for a block without
    one."""
    if rec_row[COL["kind"]] != tpipe._LIT_HUF:
        return None
    return (int(rec_row[COL["huf_log"]]), int(rec_row[COL["huf_max_symbol"]]),
            blob_row[tpipe._PB_NBL:tpipe._PB_VAL].tolist(),
            blob_row[tpipe._PB_VAL:tpipe._PB_SINGLE].tolist())


def ref_table(lp):
    """huf_table's tuple of zstd_tpu's literal plan `lp`."""
    ct = lp.ct
    return None if ct is None else (ct.table_log, ct.max_symbol,
                                    ct.nb_bits.tolist(), ct.value.tolist())
