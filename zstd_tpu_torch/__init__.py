"""zstd_tpu_torch: zstd_tpu on PyTorch.

The top-level one-shot API is zstd_tpu's (ZSTD_compress / ZSTD_decompress
analog), on the host codec:

    import zstd_tpu_torch
    blob = zstd_tpu_torch.compress(data, level=3)
    data = zstd_tpu_torch.decompress(blob)

The device paths are the device encode at every level
(`pipeline.compress`, `TorchCompressor`; the lazy engine at levels 5-22)
and the device decode of frames from any zstd encoder (`device_decompress`,
`device_decompress_resident`). They run on an NVIDIA GPU (hand-written
CUDA kernels for the serial steps, built on first use from csrc/) or, when
the caller passes device="cpu", on the host through the kernels' plain
versions. The command line is `python -m zstd_tpu_torch.cli`. The package
imports neither JAX nor zstd_tpu: the host code it needs is copied into it.
The host codec imports no torch, so every name here loads on first use: a
pzstd worker process, or the command line on a host path, starts without
torch.
"""

import importlib

__version__ = "0.1.0"

_ENTRY = {"compress": "format.codec", "decompress": "format.codec",
          "compress_patch": "format.codec",
          "decompress_patch": "format.codec",
          "register_sequence_producer": "format.block",
          "compress_bound": "format.frame",
          "find_frame_compressed_size": "format.frame",
          "get_dict_id_from_dict": "format.frame",
          "get_dict_id_from_frame": "format.frame",
          "get_frame_content_size": "format.frame",
          "is_frame": "format.frame",
          "ZstdError": "errors", "ZstdErrorCode": "errors",
          "CParams": "params", "get_cparams": "params",
          "xxh64": "xxhash64",
          "TorchCompressor": "pipeline",
          "device_decompress": "device_decoder",
          "device_decompress_resident": "device_decoder"}

__all__ = sorted(_ENTRY) + ["__version__"]


def __getattr__(name: str):
    if name not in _ENTRY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_ENTRY[name]}", __name__),
                   name)
