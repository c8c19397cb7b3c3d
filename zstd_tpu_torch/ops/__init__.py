"""Device ops of the encode and decode paths (torch ops + CUDA kernels)."""

from __future__ import annotations

import numpy as np
import torch

_TABLES: dict = {}


def device_table(arr: np.ndarray, device) -> torch.Tensor:
    """A constant lookup table on `device`, copied there once: a copy from
    pageable host memory would wait for the device on every call."""
    key = (id(arr), str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.as_tensor(arr, device=device)
    return t
