"""The operation `compress_long`: parallel.compress_long_sharded (`zstd
--long`) as the configuration states it (level, checksum, long_log), on a
raw pool input, with no process group: a world of one on the device. The
answer is a frame; its end-to-end metrics and its control are
ops/compress.py's.

`zstd --long` writes a content checksum by default, and the configuration
states it: a call is right where its frame decodes to its input by the
plain reference (refdecode.py, which reads the checksum and does not
verify it) and carries the checksum, its last 4 bytes the low 32 bits of
XXH64(input) (xxh64.py), as `zstd -d` checks them (`bad_checksums`).

The window has to run the long path on the card: over the warm-up and the
window, kernels ldm_fingerprint and ldm_lookback each launch once a call
(on the CPU, which only the tests use, the plain versions run and neither
launches), and the long matcher commits long matches
(ldm_sharded.COUNTS["long_matches"]); check_path raises CellError
otherwise."""

from __future__ import annotations

import json
import os

import harness
import xxh64

_BASE = harness.module_of(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "compress")
frame_of, end_to_end = _BASE.frame_of, _BASE.end_to_end
control = _BASE.control
KERNELS = ("ldm_fingerprint", "ldm_lookback")


class Op:
    def __init__(self, config: dict, device):
        if not config["checksum"]:
            raise harness.CellError("the judge holds every frame to its "
                                    "content checksum: `checksum` is true")
        import torch
        from zstd_tpu_torch import _kernels
        from zstd_tpu_torch.parallel import ldm_sharded
        self._compress = ldm_sharded.compress_long_sharded
        self._counts = ldm_sharded.COUNTS
        self._launches = _kernels.LAUNCHES
        self._cuda = torch.device(device).type == "cuda"
        self._kw = dict(level=config["level"], checksum=config["checksum"],
                        long_log=config["long_log"], device=device)
        self._start = self._snapshot()

    def _snapshot(self) -> dict:
        return {"calls": self._counts["calls"],
                "long_matches": self._counts["long_matches"],
                **{k: self._launches[k] for k in KERNELS}}

    def inputs(self, pool: list) -> list:
        return pool

    def __call__(self, data: bytes) -> bytes:
        return self._compress(data, **self._kw)

    def check_path(self) -> None:
        moved = {k: v - self._start[k] for k, v in self._snapshot().items()}
        print("long path over the warm-up and the window: "
              + json.dumps(moved), flush=True)
        if not moved["long_matches"]:
            raise harness.CellError(
                "the long matcher committed no long match: the cell times "
                "the long path")
        want = moved["calls"] if self._cuda else 0
        for k in KERNELS:
            if moved[k] != want:
                raise harness.CellError(
                    f"kernel {k} launched {moved[k]} times in "
                    f"{moved['calls']} calls: each call's discovery runs "
                    "it once on the card, the plain version on the CPU")


def judge(kept: list, inputs: list, pool: list) -> dict:
    """ops/compress.py's `wrong_calls`, and `bad_checksums`: the kept calls
    whose frame carries no content checksum or not its input's."""
    sums = {idx: xxh64.content_checksum(pool[idx])
            for idx in {r[0] for r in kept}}
    bad = sum(not (len(out) >= 9 and out[4] & 0x04 and out[-4:] == sums[idx])
              for idx, _, _, out, _ in kept)
    return {**_BASE.judge(kept, inputs, pool),
            "bad_checksums": {"value": bad, "limit": 0}}
