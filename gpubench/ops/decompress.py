"""The operation `decompress`: device_decoder.device_decompress on a frame
that the port's encoder made of a raw pool input, with the output returned
to the host. The frames are made before the warm-up (set-up) by
TorchCompressor as the configuration states it (level, engine, checksum).

A call is right when its answer equals the raw input byte for byte. After
the window the plain reference (refdecode.py) decodes each frame to its raw
input too: a frame it refuses is the encoder's fault, not the decoder's,
and fails the run all the same (encoder_frames_refused). The window has to
run the device path: a frame that device_decompress hands to the host
decoder moves COUNTS["host_frames"], and the run raises CellError."""

from __future__ import annotations

import sys

import faults
import harness
import refdecode

# the control that the card's test plants (faults.py)
control = faults.altered


class Op:
    def __init__(self, config: dict, device):
        from zstd_tpu_torch import device_decoder
        self._config = config
        self._device = device
        self._decoder = device_decoder
        self._host_frames = None

    def inputs(self, pool: list) -> list:
        import torch
        from zstd_tpu_torch.pipeline import TorchCompressor
        c = self._config
        compress = TorchCompressor(level=c["level"], engine=c["engine"],
                                   device=self._device,
                                   checksum=c["checksum"]).compress
        frames = [compress(x) for x in pool]
        del compress
        if torch.device(self._device).type == "cuda":
            # the encoder is set-up here: the peak is the decode's
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self._host_frames = self._decoder.COUNTS["host_frames"]
        return frames

    def __call__(self, frame: bytes) -> bytes:
        return self._decoder.device_decompress(frame, device=self._device)

    def check_path(self) -> None:
        moved = self._decoder.COUNTS["host_frames"] - self._host_frames
        print(f"decode path: COUNTS['host_frames'] moved by {moved} over the "
              "warm-up and the window", flush=True)
        if moved:
            raise harness.CellError(
                f"{moved} frame(s) went to the host decoder: the cell times "
                "the device decode only")


def frame_of(frame: bytes, content: bytes) -> bytes:
    return frame


def end_to_end(in_bytes: int, out_bytes: int, wall_s: float) -> dict:
    return {}


def judge(kept: list, inputs: list, pool: list) -> dict:
    """A kept answer that is not its raw input is wrong; a frame that the
    reference does not decode to its raw input is refused."""
    wrong = sum(out != pool[idx] for idx, _, _, out, _ in kept)
    refused = sum(not ok for ok in refdecode.verdicts(inputs, pool))
    if refused:
        print(f"judge: the reference refuses {refused} of the encoder's "
              f"{len(inputs)} frames: the fault is the encoder's "
              "(TorchCompressor), not the decoder's", file=sys.stderr,
              flush=True)
    return {"wrong_calls": {"value": wrong, "limit": 0},
            "encoder_frames_refused": {"value": refused, "limit": 0}}
