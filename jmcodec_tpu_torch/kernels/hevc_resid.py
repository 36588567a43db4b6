"""HEVC residuals: dequantisation and the two-stage inverse DCT / DST of
whole planes, a TU at a time. The CUDA kernel (csrc/hevc_resid.cu) and its
plain torch version.

    resid_planes(...) == planes_reference(...)

Both take the levels of one or two components, the TU map and the luma QP
map in the compact dtypes of hevc_tiles.stack_plans, for F frames of an
H x W plane:

    coeffs     ([F, H, W] int16,)       luma; or (Cb, Cr)
    tu         [F, H/4, W/4] int8       log2 TU size per 4x4 cell
    qp_y       [F, Hy/4, Wy/4] int8     the luma cell QP (Hy = H for luma,
                                        2 H for chroma)
    offsets    None, or ([F] int32, [F] int32): the Cb and Cr QP offsets;
               a chroma block takes its QP through chroma_qp

and return the residual planes [K F, H, W] int16 (K = len(coeffs); Cb of
every frame, then Cr, as the chroma scan stacks them): for each log2 TU
size v in `sizes` (the kernel takes the decode paths' two: LUMA_SIZES,
and CHROMA_SIZES with the offsets) and each 2^v-aligned block whose
origin cell holds v, its
residual_reference contribution; the contributions of every size summed
(a map that is not a clean TU tree gives overlapping blocks, which add),
in int16. The int16 planes hold the sum: a pixel lies in at most one
block of each size, each adds at most (32767 x a column sum of |M| +
2048) >> 12, and that is 28,224 over the four sizes, so the saturation
the plain version applies never binds. The scans take int16 residuals,
and the inter base clip(pred + r, 0, 255) is computed in int32.

residual_reference is jmcodec_tpu's _residual_plane
(kernels/hevc_tiles.py:84), which the kernel replaces: every block through
the transform at every size, float64 matrix products (each partial sum is
an integer below 2^27, so float64 is exact), a mask a size. The kernel
transforms only the blocks that hold their size and a level, in int32, as
partial butterflies whose matrix entries are compile-time constants of the
source (csrc/hevc_resid.cu: dct_basis, dst4; LEVEL_SCALE and QPC_T in its
constant memory), a 32x32 area of one plane a warp.
"""

from __future__ import annotations

import ctypes

import torch

from ..codec.hevc import transform as HTR
from . import hevc_tables as HT
from ._tables import device_table as _t

_I32 = torch.int32

# the log2 TU sizes of a luma plane (4..32) and of a 4:2:0 chroma one
# (4..16): the kernel's two forms
LUMA_SIZES, CHROMA_SIZES = (2, 3, 4, 5), (2, 3, 4)

# Kernel launches made by resid_planes(); read by callers that must show
# the main path went through the kernel.
LAUNCHES = 0

# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _dequant_blocks(c, qp, log2: int):
    """c [..., n, n] int32 levels, qp [...] int32 -> dequantised int32
    (8.6.3, flat scaling list m = 16, 8-bit), clipped to int16 range."""
    bd_shift = log2 + 3
    ls = _t(HTR.LEVEL_SCALE, c.device)[(qp % 6).long()][..., None, None]
    s = (qp // 6)[..., None, None]
    d1 = c * (ls * 16)                       # |d1| < 2^26
    one = torch.ones_like(s)
    k = s - bd_shift                         # in [-8, 3]
    lo_path = (d1 + (one << (bd_shift - 1 - s).clamp(min=0))) >> \
        (-k).clamp(min=0)
    kp = k.clamp(min=0)
    lim = one << (15 - kp)
    hi_path = torch.where(d1 >= lim, 32767,
                          torch.where(d1 < -lim, -32768, d1 << kp))
    return torch.where(k >= 0, hi_path,
                       lo_path.clamp(-32768, 32767)).to(_I32)


def _itransform_blocks(d, log2: int, dst: bool):
    """Two-stage inverse transform (8.6.4.2) on [..., n, n] int32: columns,
    then rows, each stage a float64 matrix product (exact, see above)."""
    m = _t(HTR.DST4 if dst else HTR.DCT[1 << log2], d.device, torch.float64)
    e = (d.to(torch.float64).transpose(-1, -2) @ m).transpose(-1, -2)
    e = ((e.to(_I32) + 64) >> 7).clamp(-32768, 32767)
    r = (e.to(torch.float64) @ m).to(_I32)
    return ((r + 2048) >> 12).clamp(-32768, 32767)


def residual_reference(coeff, qp_cell, tu_log2, luma: bool, sizes):
    """coeff [..., Hp, Wp] int32, qp_cell/tu_log2 [..., Hp/4, Wp/4] ->
    residual plane [..., Hp, Wp] int32 (zero where no TU). luma: the DST
    at 4x4 (intra luma)."""
    *lead, Hp, Wp = coeff.shape
    resid = torch.zeros_like(coeff, dtype=_I32)
    for log2 in sizes:
        n = 1 << log2
        c4 = n // 4
        blocks = coeff.reshape(*lead, Hp // n, n, Wp // n, n).transpose(-3, -2)
        mask = tu_log2[..., ::c4, ::c4] == log2
        d = _dequant_blocks(blocks, qp_cell[..., ::c4, ::c4], log2)
        r = _itransform_blocks(d, log2, dst=(luma and log2 == 2))
        r = torch.where(mask[..., None, None], r, 0)
        resid += r.transpose(-3, -2).reshape(*lead, Hp, Wp)
    return resid


def chroma_qp(qp_y, off):
    """Chroma QP per chroma cell (Table 8-10) from the luma cell QP [F, Hp/4,
    Wp/4] and the frame's offset [F]."""
    return _t(HT.QPC_T, qp_y.device)[(qp_y[:, ::2, ::2] + off[:, None, None])
                                     .clamp(0, 57).long()]


def planes_reference(coeffs, tu, qp_y, *, sizes, dst4=False, offsets=None):
    """Plain torch version of resid_planes on any device (its arguments),
    through residual_reference. Returns [K F, H, W] int16."""
    qp_y = qp_y.to(_I32)
    qps = ([qp_y] if offsets is None
           else [chroma_qp(qp_y, o.to(_I32)) for o in offsets])
    out = [residual_reference(c.to(_I32), q, tu.to(_I32), dst4, sizes)
           for c, q in zip(coeffs, qps)]
    return torch.cat(out).clamp(-32768, 32767).to(torch.int16)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(coeffs, tu, qp_y, sizes, offsets):
    """Type, shape and contiguity first (so a CPU call shows a wrong
    argument too), then the device: CUDA, one for all, every tensor
    starting on a 16-byte boundary."""
    if not isinstance(coeffs, (tuple, list)) or len(coeffs) not in (1, 2):
        raise ValueError("coeffs is a tuple of one (luma) or two (Cb, Cr) "
                         "tensors")
    if offsets is not None and len(offsets) != len(coeffs):
        raise ValueError(f"{len(offsets)} QP offsets for {len(coeffs)} "
                         f"components")
    want_sizes = LUMA_SIZES if offsets is None else CHROMA_SIZES
    if tuple(sizes) != want_sizes:
        raise ValueError(f"sizes {tuple(sizes)}: the kernel takes "
                         f"{want_sizes} for "
                         f"{'luma' if offsets is None else 'chroma'}")
    if coeffs[0].dim() != 3:
        raise ValueError(f"coeffs are [frames, rows, cols], got "
                         f"{tuple(coeffs[0].shape)}")
    F, H, W = coeffs[0].shape
    R = 1 << max(want_sizes)
    if F == 0 or H == 0 or W == 0 or H % R or W % R:
        raise ValueError(f"planes {H}x{W} are not whole {R}x{R} blocks")
    s = 1 if offsets is None else 2
    want = {f"coeffs[{k}]": (c, torch.int16, (F, H, W))
            for k, c in enumerate(coeffs)}
    want["tu"] = (tu, torch.int8, (F, H // 4, W // 4))
    want["qp_y"] = (qp_y, torch.int8, (F, s * H // 4, s * W // 4))
    for k, o in enumerate(offsets or ()):
        want[f"offsets[{k}]"] = (o, torch.int32, (F,))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = coeffs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the hevc_resid kernel takes CUDA tensors, not "
                         f"{dev}: the plain torch version is "
                         f"planes_reference")
    for name, (t, _, _) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, not {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    if F * len(coeffs) > 65535 or H // R > 65535:
        raise ValueError(f"{F * len(coeffs)} planes of {H} rows: too many "
                         f"for one launch's grid")


_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build
        lib = ctypes.CDLL(_build.build())
        fn = lib.hevc_resid_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def resid_planes(coeffs, tu, qp_y, *, sizes, dst4=False, offsets=None):
    """The residual planes of `coeffs` (the layout above) for the log2 TU
    sizes `sizes`, LUMA_SIZES or, with offsets (chroma), CHROMA_SIZES
    (dst4: the DST-VII at 4x4, intra luma).
    CPU tensors take planes_reference; CUDA tensors launch the kernel, one
    launch for every component and frame (or raise). Returns new [K F, H,
    W] int16 planes."""
    dev = coeffs[0].device
    if dev.type == "cpu":
        return planes_reference(coeffs, tu, qp_y, sizes=sizes, dst4=dst4,
                                offsets=offsets)
    _check(coeffs, tu, qp_y, sizes, offsets)
    F, H, W = coeffs[0].shape
    out = torch.empty((len(coeffs) * F, H, W), dtype=torch.int16, device=dev)
    ptr = lambda seq, k: seq[k].data_ptr() if seq and k < len(seq) else None
    with torch.cuda.device(dev):
        err = _load().hevc_resid_launch(
            ptr(coeffs, 0), ptr(coeffs, 1), tu.data_ptr(), qp_y.data_ptr(),
            ptr(offsets, 0), ptr(offsets, 1), out.data_ptr(),
            F, H, W, int(dst4), int(offsets is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hevc_resid kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
