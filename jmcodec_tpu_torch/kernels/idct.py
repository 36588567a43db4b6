"""H.264 4x4 residual blocks: dequantisation, DC splice and inverse
transform in one pass. The CUDA kernel (csrc/dequant_idct.cu) and its plain
torch version.

dequant_idct_blocks(coeffs, qp_blk, dc=None, dc_mask=None) computes, per
block n of coeffs [N, 4, 4]:

    d = (coeffs[n] * DEQUANT4x4[qp_blk[n] % 6]) << (qp_blk[n] // 6)
    d[0, 0] = dc[n]          where dc is given and dc_mask[n] is set
                             (dc without dc_mask: every block)
    out[n] = inverse_transform_4x4(d)

Without dc it is the function of jmcodec_tpu's Pallas kernel
(kernels/pallas_idct.py, dequant_idct_blocks). The splice is where the
Intra16x16 luma DC and the chroma DC values enter: they come from a
Hadamard stage (recon._residuals) on 1/16 of the data.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import transform as T
from ._tables import device_table

# Kernel launches made by dequant_idct_blocks(); read by callers that must
# show the main path went through the kernel.
LAUNCHES = 0


def dequant_idct_reference(coeffs, qp_blk, dc=None, dc_mask=None):
    """Plain torch version on any device: coeffs [..., 4, 4] int16/int32,
    qp_blk/dc/dc_mask [...]. Returns [..., 4, 4] int32."""
    dq = device_table(T.DEQUANT4x4, coeffs.device)
    d = T.dequant_4x4(coeffs.to(torch.int32), qp_blk.to(torch.int32), dq)
    if dc is not None:
        d00 = dc if dc_mask is None else torch.where(dc_mask.bool(), dc,
                                                     d[..., 0, 0])
        d[..., 0, 0] = d00
    return T.inverse_transform_4x4(d)


_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build
        lib = ctypes.CDLL(_build.build())
        fn = lib.dequant_idct_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(coeffs, qp_blk, dc, dc_mask):
    if coeffs.dim() != 3 or tuple(coeffs.shape[1:]) != (4, 4):
        raise ValueError(f"coeffs shape {tuple(coeffs.shape)} != [N, 4, 4]")
    if coeffs.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"coeffs must be int16 or int32, got {coeffs.dtype}")
    N = coeffs.shape[0]
    want = {"qp_blk": (qp_blk, (torch.int32,)), "dc": (dc, (torch.int32,)),
            "dc_mask": (dc_mask, (torch.bool, torch.uint8))}
    for name, (t, dts) in want.items():
        if t is None:
            continue
        if t.device != coeffs.device:
            raise ValueError(f"{name} on {t.device}, coeffs on "
                             f"{coeffs.device}")
        if t.dtype not in dts:
            raise TypeError(f"{name} must be {dts}, got {t.dtype}")
        if tuple(t.shape) != (N,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({N},)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not coeffs.is_contiguous():
        raise ValueError("coeffs must be contiguous")
    if coeffs.data_ptr() % 16:
        raise ValueError("coeffs must be 16-byte aligned")
    if dc_mask is not None and dc is None:
        raise ValueError("dc_mask without dc")


def dequant_idct_blocks(coeffs, qp_blk, dc=None, dc_mask=None):
    """coeffs [N, 4, 4] int16/int32 contiguous, qp_blk [N] int32 in 0..51,
    dc [N] int32, dc_mask [N] bool/uint8 -> [N, 4, 4] int32. CPU tensors
    take dequant_idct_reference; CUDA tensors launch the kernel (or
    raise)."""
    if coeffs.device.type == "cpu":
        return dequant_idct_reference(coeffs, qp_blk, dc, dc_mask)
    if coeffs.device.type != "cuda":
        raise ValueError(f"dequant_idct_blocks: unsupported device "
                         f"{coeffs.device}")
    _check(coeffs, qp_blk, dc, dc_mask)
    N = coeffs.shape[0]
    out = torch.empty((N, 4, 4), dtype=torch.int32, device=coeffs.device)
    if N == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream(coeffs.device).cuda_stream
        err = _load().dequant_idct_launch(
            coeffs.data_ptr(), int(coeffs.dtype == torch.int16),
            qp_blk.data_ptr(), ptr(dc), ptr(dc_mask), out.data_ptr(), N,
            stream)
    if err != 0:
        raise RuntimeError(f"dequant_idct kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
