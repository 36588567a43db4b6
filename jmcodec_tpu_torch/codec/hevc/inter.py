"""HEVC inter prediction: the DPB entry (H.265 8.3.2) with the motion field
that temporal MV prediction reads (8.5.3.2.8).

The port's copy of what jmcodec_tpu/codec/hevc/inter.py holds that the
device inter path uses: RefPic. Motion derivation runs in the native
parser, motion compensation on the device (kernels/hevc_tiles.py); the
host MC functions of the reference are not copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np


@dataclass
class RefPic:
    """A decoded picture in the DPB, with the motion field kept for TMVP.
    y/cb/cr are the coded-size planes as the device decode returned them
    (tensors that stay on its device)."""
    poc: int
    y: Any
    cb: Any
    cr: Any
    # per-4x4-luma-cell motion data (TMVP reads it 16x16-rounded, 8.5.3.2.8)
    mv: np.ndarray          # [2, H4, W4, 2] int32 quarter-pel
    ref_poc: np.ndarray     # [2, H4, W4] int32 (POC of the ref each MV uses)
    pred: np.ndarray        # [2, H4, W4] uint8 predFlagLX
    intra: np.ndarray       # [H4, W4] uint8
    output_needed: bool = True
    is_reference: bool = True
    crop: Tuple[int, int] = (0, 0)   # output (width, height), conf window
