"""zstd_tpu_torch: the device paths of zstd_tpu on PyTorch.

Two paths: the device encode at every level (`compress`, `TorchCompressor`;
the lazy engine at levels 5-22) and the device decode of frames from any zstd encoder (`device_decompress`,
`device_decompress_resident`). The port runs on an NVIDIA GPU (hand-written
CUDA kernels for the serial steps, built on first use from csrc/) or, when
the caller passes device="cpu", on the host through the kernels' plain
versions. It imports neither JAX nor zstd_tpu: the host code it needs is
copied into this package. The host codec (format.codec, parallel.pzstd)
imports no torch, so the entry points load on first use: a pzstd worker
process that imports only the host codec starts without torch.
"""

import importlib

_ENTRY = {"TorchCompressor": "pipeline", "compress": "pipeline",
          "device_decompress": "device_decoder",
          "device_decompress_resident": "device_decoder"}

__all__ = sorted(_ENTRY)


def __getattr__(name: str):
    if name not in _ENTRY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_ENTRY[name]}", __name__),
                   name)
