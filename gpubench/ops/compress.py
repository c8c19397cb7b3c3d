"""The operation `compress`: TorchCompressor.compress as the configuration
states it (level, engine, checksum), on a raw pool input; the answer is a
frame. A call's frame has to decode to its input by the plain reference
(refdecode.py); `ratio` is the raw bytes over the frames' bytes."""

from __future__ import annotations

import faults
import refdecode

# the control that the card's test plants (faults.py)
control = faults.control


class Op:
    def __init__(self, config: dict, device):
        from zstd_tpu_torch.pipeline import TorchCompressor
        self._compress = TorchCompressor(
            level=config["level"], engine=config["engine"], device=device,
            checksum=config["checksum"]).compress

    def inputs(self, pool: list) -> list:
        return pool

    def __call__(self, data: bytes) -> bytes:
        return self._compress(data)

    def check_path(self) -> None:
        pass


def frame_of(data: bytes, frame: bytes) -> bytes:
    return frame


def end_to_end(in_bytes: int, out_bytes: int, wall_s: float) -> dict:
    m = {"encode_mbps": (in_bytes / 1e6 / wall_s, "MB/s")}
    if out_bytes:
        m["ratio"] = (in_bytes / out_bytes, "x")
    return m


def judge(kept: list, inputs: list, pool: list) -> dict:
    """Each distinct frame made of a pool input is decoded by the
    reference, and a call whose frame does not decode to its input is
    wrong."""
    distinct: dict[int, list] = {}         # pool index -> distinct frames
    which = []
    for idx, _, _, out, _ in kept:
        known = distinct.setdefault(idx, [])
        for j, frame in enumerate(known):
            if frame == out:
                break
        else:
            j = len(known)
            known.append(out)
        which.append((idx, j))
    keys = [(i, j) for i, fs in distinct.items() for j in range(len(fs))]
    ok = dict(zip(keys, refdecode.verdicts([distinct[i][j] for i, j in keys],
                                           [pool[i] for i, _ in keys])))
    return {"wrong_calls": {"value": sum(not ok[k] for k in which),
                            "limit": 0}}
