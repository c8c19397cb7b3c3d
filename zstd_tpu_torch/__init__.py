"""zstd_tpu_torch: the device paths of zstd_tpu on PyTorch.

Two paths: the device encode at every level (`compress`, `TorchCompressor`;
the lazy engine at levels 5-22) and the device decode of frames from any zstd encoder (`device_decompress`,
`device_decompress_resident`). The port runs on an NVIDIA GPU (hand-written
CUDA kernels for the serial steps, built on first use from csrc/) or, when
the caller passes device="cpu", on the host through the kernels' plain
versions. It imports neither JAX nor zstd_tpu: the host code it needs is
copied into this package.
"""

from .device_decoder import device_decompress, device_decompress_resident
from .pipeline import TorchCompressor, compress

__all__ = ["TorchCompressor", "compress", "device_decompress",
           "device_decompress_resident"]
