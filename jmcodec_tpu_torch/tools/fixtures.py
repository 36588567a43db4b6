"""Inputs for checks and timings of the port: the committed 1080p HEVC and
H.264 all-intra fixtures at the smoke's batches, seeded synthetic inputs
for holding each kernel against its plain version, and copies of reference
objects into the port's own types."""

from __future__ import annotations

import json
import os

import numpy as np

from ..codec.h264.symbols import FrameSymbols
from ..codec.hevc.plan import ZIDX_NONE, HevcFramePlan

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(ROOT, "tests", "data", "hevc_1080p_intra.h265")
DIGESTS = os.path.join(ROOT, "tests", "data", "hevc_1080p_intra.sha256.json")
H264_FIXTURE = os.path.join(ROOT, "tests", "data", "h264_1080p_intra.h264")
H264_DIGESTS = os.path.join(ROOT, "tests", "data",
                            "h264_1080p_intra.sha256.json")
# frames per decode batch, as bench.py's 1080p figures decode them
BATCH = 16
H264_BATCH = 32


def fixture_digests(path: str = DIGESTS) -> list[dict]:
    """Per-frame {"Y", "U", "V"} SHA-256 of a fixture's libavcodec decode."""
    with open(path) as f:
        return json.load(f)["frames"]


def _repeated(stream_path: str, digests_path: str, batch: int) -> bytes:
    with open(stream_path, "rb") as f:
        one = f.read()
    return one * (batch // len(fixture_digests(digests_path)))


def fixture_batch_stream() -> bytes:
    """The HEVC fixture repeated to BATCH pictures (all are IDR)."""
    return _repeated(FIXTURE, DIGESTS, BATCH)


def h264_fixture_batch_stream() -> bytes:
    """The H.264 fixture repeated to H264_BATCH pictures (all are IDR; the
    repeated parameter sets are the same ones)."""
    return _repeated(H264_FIXTURE, H264_DIGESTS, H264_BATCH)


def synth_idct_blocks(N: int, seed: int = 0):
    """Seeded inputs of dequant_idct_blocks as numpy arrays: levels [N, 4,
    4] int16 over the full int16 range, qp [N] int32 cycling through every
    value 0..51 (shuffled), dc [N] int32 over +-2^20 and a mask [N] bool
    that sets about one block in three."""
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-32768, 32768, (N, 4, 4)).astype(np.int16)
    qp = rng.permutation(np.arange(N) % 52).astype(np.int32)
    dc = rng.integers(-(1 << 20), 1 << 20, N).astype(np.int32)
    mask = rng.integers(0, 3, N) == 0
    return coeffs, qp, dc, mask


def _copy_fields(src, dst):
    for name, val in vars(src).items():
        setattr(dst, name, val.copy() if isinstance(val, np.ndarray) else val)
    return dst


def symbols_from_reference(fs) -> FrameSymbols:
    """A FrameSymbols-shaped object of another package (duck-typed: the
    same attributes) copied into the port's FrameSymbols."""
    return _copy_fields(fs, FrameSymbols(fs.mb_width, fs.mb_height))


def plan_from_reference(plan) -> HevcFramePlan:
    """A HevcFramePlan-shaped object of another package copied into the
    port's HevcFramePlan."""
    return _copy_fields(plan, HevcFramePlan.__new__(HevcFramePlan))


def synth_state(C: int, max_tu: int, B: int, seed: int = 0, skew: int = 2):
    """Seeded random walk state as numpy arrays (F int16, Z int32, resid
    int16, tu int32, mode int32), laid out as a scan step with the given
    skew (hevc_tables.skew_for(C) in the decode).
    Each lane's CTB quadrants take random TU sizes from 4 up to
    min(C/2, max_tu); modes are uniform over 0..34. Every fourth lane also
    has a TU of the largest size at (0, 0), in a mode that filters its
    references, and borders that are a linear ramp plus +-1 noise, so the
    32x32 strong-smoothing test (8.4.4.2.3) passes there and its bilinear
    output differs from the [1 2 1] filter's."""
    rng = np.random.default_rng(seed)
    C4, T = C // 4, min(C, max_tu)
    WF, WZ = 1 + skew * C, 1 + skew * C4
    F = np.zeros((B, 1 + C + T, WF), np.int16)
    F[:, 0, :] = rng.integers(0, 256, (B, WF))
    F[:, :, 0] = rng.integers(0, 256, (B, 1 + C + T))
    for b in range(0, B, 4):
        a, dx, dy = (int(rng.integers(80, 171)), int(rng.integers(-1, 2)),
                     int(rng.integers(-1, 2)))
        F[b, 0, :] = np.clip(a + dx * np.arange(WF)
                             + rng.integers(-1, 2, WF), 0, 255)
        F[b, :, 0] = np.clip(a + dy * np.arange(1 + C + T)
                             + rng.integers(-1, 2, 1 + C + T), 0, 255)
    Z = np.full((B, 1 + C4 + T // 4, WZ), ZIDX_NONE, np.int32)
    Z[:, 1:1 + C4, 1:1 + C4] = np.arange(C4 * C4).reshape(C4, C4)
    Z[:, 0, :] = -1
    Z[:, :, 0] = -1
    resid = rng.integers(-20, 21, (B, C, C)).astype(np.int16)
    tu = np.zeros((B, C4, C4), np.int32)
    top_log2 = min(C // 2, max_tu).bit_length() - 1
    h4 = C4 // 2
    for b in range(B):
        for qy in range(2):
            for qx in range(2):
                log2 = int(rng.integers(2, top_log2 + 1))
                n4 = (1 << log2) // 4
                tu[b, qy * h4:(qy + 1) * h4:n4, qx * h4:(qx + 1) * h4:n4] = \
                    log2
        if b % 4 == 0:
            tu[b, 0, 0] = T.bit_length() - 1
    mode = rng.integers(0, 35, (B, C4, C4)).astype(np.int32)
    mode[::4, 0, 0] = rng.choice([0, 2, 18, 34], len(range(0, B, 4)))
    return F, Z, resid, tu, mode
