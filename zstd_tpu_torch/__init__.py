"""zstd_tpu_torch: the level-1 device encode path of zstd_tpu on PyTorch.

The port runs on an NVIDIA GPU (hand-written CUDA kernels for the serial
steps, built on first use from csrc/) or, when the caller passes
device="cpu", on the host through the kernels' plain versions. It imports
neither JAX nor zstd_tpu: the host code it needs is copied into this
package.
"""

from .pipeline import TorchCompressor, compress

__all__ = ["TorchCompressor", "compress"]
