"""On a card: the long cell's discovery and frame against the plain
versions, exactly, on one 16 MiB input of the cell's pool
(long27-l3.compress-long-16mib): kernel ldm_fingerprint's flags and keys
against anchor_keys_plain, the owner's sorted entries, kernel
ldm_lookback's anchors and candidates against lookback_plain, the whole
ShardedLdmState on the card against the one on the CPU, the card's frame
against the CPU's byte for byte, the frame decoded by the reference, and
its ratio against a level-3 frame of the same input without --long.

    python -m pytest gpubench/tests/test_gpubench_long_card.py -q -m card -s
"""

from __future__ import annotations

import json
import os
import time

import pytest
from conftest import BENCH, ROOT

import harness
import refdecode

CELL = "long27-l3.compress-long-16mib"
SEED = 2**31 + 2207


def _equal(a, b) -> bool:
    return a.shape == b.shape and bool((a.cpu() == b.cpu()).all())


@pytest.mark.card
def test_long_cell_equals_the_plain_versions(card, capsys):
    import numpy as np
    import torch

    from zstd_tpu_torch import _kernels
    from zstd_tpu_torch.format import codec
    from zstd_tpu_torch.ops import ldm as tops
    from zstd_tpu_torch.params import get_cparams
    from zstd_tpu_torch.parallel import ldm_sharded as tl

    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.cell_of(spec, CELL)
    config = harness.config_of(BENCH, cell["config"])
    traffic = harness.traffic_of(BENCH, cell["traffic"])
    data = harness.pool_of(config, traffic, SEED)[0]
    full = np.frombuffer(data, dtype=np.uint8)
    n = len(data)
    level, long_log = config["level"], config["long_log"]
    wlog = max(get_cparams(level, n).window_log,
               min(long_log, (n - 1).bit_length()))
    lay = tl.layout(n, 1, 1 << wlog)
    m, cap, bs = lay["m"], lay["cap"], lay["block_size"]
    chunk = np.zeros(m + tops.SPAN, dtype=np.uint8)
    chunk[:min(n, m + tops.SPAN)] = full[:m + tops.SPAN]
    valid = min(lay["n_pos"], m)
    ext_h = torch.from_numpy(chunk)
    ext_d = ext_h.to(card)
    launches = dict(_kernels.LAUNCHES)
    got, want = tops.anchor_keys(ext_d, valid), tops.anchor_keys_plain(
        ext_h, valid)
    assert all(_equal(g, w) for g, w in zip(got, want))
    ent_d = tl.owner_entries_of(ext_d, valid, 0, None, cap)
    ent_h = tl.owner_entries_of(ext_h, valid, 0, None, cap)
    assert _equal(ent_d, ent_h)
    got = tops.lookback(ent_d, bs, 1 << wlog)
    want = tops.lookback_plain(ent_h, bs, 1 << wlog)
    assert all(_equal(g, w) for g, w in zip(got, want))
    st_d = tl.ShardedLdmState(full, wlog, device=card)
    st_h = tl.ShardedLdmState(full, wlog, device="cpu")
    assert np.array_equal(st_d.anchors, st_h.anchors)
    assert np.array_equal(st_d.cands, st_h.cands)
    kw = dict(level=level, checksum=config["checksum"], long_log=long_log)
    t0 = time.perf_counter()
    frame_d = tl.compress_long_sharded(data, device=card, **kw)
    card_s = time.perf_counter() - t0
    frame_h = tl.compress_long_sharded(data, device="cpu", **kw)
    assert frame_d == frame_h
    assert refdecode.verdicts([frame_d], [data]) == [True]
    plain3 = codec.compress(data, level=level, checksum=config["checksum"])
    assert len(plain3) >= 3 * len(frame_d)
    moved = {k: v - launches[k] for k, v in _kernels.LAUNCHES.items()
             if v != launches[k]}
    assert moved == {"ldm_fingerprint": 4, "ldm_lookback": 3}
    with capsys.disabled():
        print("\nlong card check: " + json.dumps({
            "seed": SEED, "bytes": n, "window_log": wlog,
            "positions": m, "anchors": int(got[0].ge(0).sum()),
            "candidates": int(got[1].ge(0).sum()),
            "anchors_kept": len(st_d.anchors), "frame": len(frame_d),
            "ratio": n / len(frame_d),
            "ratio_level3_without_long": n / len(plain3),
            "card_call_s": card_s, "launches": moved}))
