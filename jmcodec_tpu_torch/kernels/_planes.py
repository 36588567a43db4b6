"""Plane helpers shared by the H.264 and HEVC motion compensation."""

from __future__ import annotations

import torch


def edge_pad(a, dim: int, before: int, after: int):
    """a padded along dim by repeating its first and last sample."""
    n = a.shape[dim]
    idx = torch.arange(-before, n + after, device=a.device).clamp(0, n - 1)
    return a.index_select(dim, idx)


def cell_origins(cells, step: int, pad: int):
    """Sample (row, column) of the top-left corner of every cell of the
    [Hc, Wc] grid `cells` in a plane padded by `pad`: [Hc, 1] and [1, Wc]
    int64."""
    Hc, Wc = cells.shape
    dev = cells.device
    return (torch.arange(Hc, device=dev)[:, None] * step + pad,
            torch.arange(Wc, device=dev)[None, :] * step + pad)
