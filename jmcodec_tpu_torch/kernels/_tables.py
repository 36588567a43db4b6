"""Constant tables on the device, copied there once."""

from __future__ import annotations

import numpy as np
import torch

_TABLES = {}


def device_table(a, device, dtype=torch.int32):
    """The constant table `a` on `device`, copied there once: a copy from
    host memory synchronises the stream, so after its first call on a
    device a decode makes none. The cache holds `a`, so its id stays
    unique while the entry lives."""
    key = (id(a), str(device), dtype)
    if key not in _TABLES:
        _TABLES[key] = (a, torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device))
    return _TABLES[key][1]
