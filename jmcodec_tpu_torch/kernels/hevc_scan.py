"""The HEVC intra wavefront scan as one CUDA kernel (csrc/hevc_scan.cu):
one persistent launch a scan, on whole planes, and its plain torch
version.

    scan_planes(...) == scan_reference(...)

Both take the scan's inputs in plane layout, for CTB size C, H = ctb_h * C
and W = ctb_w * C:

    resid  [P, H, W] int16       residual planes, saturated to int16
    zidx   [G, H/4, W/4] int32   decode-order index per 4x4 cell
    tu     [G, H/4, W/4] int32   log2 TU size per cell (0 = none)
    mode   [G, H/4, W/4] int32   intra mode per cell
    base   [P, H, W] int16       an inter picture's base, saturated to
                                 int16 (None: an all-intra picture)

(plane p uses cell plane p % G: the chroma scan stacks the Cb planes of
every frame, then the Cr planes, on one map a frame) and return the
reconstructed planes [P, H, W] int32. They are the counterpart of
jmcodec_tpu's jax.lax.scan (kernels/hevc_tiles.py: _intra_scan) with the
skew of its inputs and the unskew of its output around it: the planes'
CTB rows are its lanes (the kernel walks the rows of two planes on one
map, a frame's Cb and Cr, together: lanes()), the first of each plane
without a top neighbour, and skew (hevc_tables.skew_for of the luma CTB
size) sets its wavefront. The kernel walks each CTB's TUs by dependency
level (kernels/hevc_levels.py), which gives the z-order walk's samples.
hevc_tiles.decode_frames_hevc_scan routes a decode on the card here (two
launches: luma, then Cb and Cr); CPU tensors take the torch scan there,
and scan_planes raises on them.
"""

from __future__ import annotations

import ctypes

import torch

from ..codec.hevc.plan import ZIDX_NONE
from .hevc_walk import walk_reference

# Kernel launches made by scan_planes(), one a scan; read by callers that
# must show the main path went through the kernel.
LAUNCHES = 0


def scan_reference(resid, zidx, tu, mode, *, C: int, skew: int, max_tu: int,
                   is_chroma: bool, strong: bool, base=None):
    """Plain torch version on any device: the port's torch scan
    (hevc_tiles._intra_scan, one walk_reference a step) between the skew
    of the planes into lanes and the unskew of its tiles. Returns [P, H, W]
    int32."""
    from . import hevc_tiles as HTT

    return HTT.scan_torch(resid, zidx, tu, mode, C=C, skew=skew,
                          max_tu=max_tu, is_chroma=is_chroma, strong=strong,
                          walk_fn=walk_reference, base=base)


def _check(resid, zidx, tu, mode, base, C, skew, max_tu):
    """Type, shape and contiguity first (so a CPU call shows a wrong
    argument too), then the device: CUDA, one for all, each plane starting
    on a 16-byte boundary."""
    T = min(C, max_tu)
    if (C not in (8, 16, 32, 64) or T < 4 or T > 32 or C // T > 2
            or skew not in (1, 2, 3, 4)):
        raise ValueError(f"unsupported scan geometry C={C} max_tu={max_tu} "
                         f"skew={skew}")
    if resid.dim() != 3 or zidx.dim() != 3:
        raise ValueError("resid and the cell maps are [planes, rows, cols]")
    P, H, W = resid.shape
    G = zidx.shape[0]
    if H % C or W % C or H == 0 or W == 0:
        raise ValueError(f"planes {H}x{W} are not whole {C}x{C} CTBs")
    if G == 0 or P % G:
        raise ValueError(f"{P} planes on {G} cell maps")
    want = {"resid": (resid, torch.int16, (P, H, W)),
            "zidx": (zidx, torch.int32, (G, H // 4, W // 4)),
            "tu": (tu, torch.int32, (G, H // 4, W // 4)),
            "mode": (mode, torch.int32, (G, H // 4, W // 4))}
    if base is not None:
        want["base"] = (base, torch.int16, (P, H, W))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if resid.device.type != "cuda":
        raise ValueError(f"the hevc_scan kernel takes CUDA tensors, not "
                         f"{resid.device}: the plain torch version is "
                         f"scan_reference")
    for name, (t, _, _) in want.items():
        if t.device != resid.device:
            raise ValueError(f"{name} on {t.device}, not {resid.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build
        lib = ctypes.CDLL(_build.build())
        fn = lib.hevc_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hevc_scan_resident.argtypes = ([ctypes.c_int] * 5
                                           + [ctypes.c_void_p] * 3)
        lib.hevc_scan_resident.restype = ctypes.c_int
        _lib = lib
    return _lib


def lanes(planes: int, maps: int, ctb_h: int) -> int:
    """The lanes of a scan_planes launch: each CTB row of up to two planes
    on one cell map (the chroma scan's Cb and Cr of a frame)."""
    return (planes // maps + 1) // 2 * maps * ctb_h


def resident_ctas(*, C: int, skew: int, max_tu: int, base: bool = False,
                  planes_per_map: int = 1, device=None):
    """(the CTAs a scan_planes launch of this geometry keeps on the card at
    once, the shared memory of each in bytes, the threads of each): a
    launch runs min(lanes(...), this many) CTAs, and the lanes beyond it
    wait for a CTA to finish a lane. planes_per_map: P / G of the launch
    (two planes on one map share a lane). device: a CUDA device (None: the
    current one)."""
    n, smem, threads = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _load().hevc_scan_resident(C, max_tu, skew, int(base),
                                         min(planes_per_map, 2),
                                         ctypes.byref(n), ctypes.byref(smem),
                                         ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"hevc_scan occupancy query failed: CUDA error "
                           f"{err}")
    return n.value, smem.value, threads.value


def scan_planes(resid, zidx, tu, mode, *, C: int, skew: int, max_tu: int,
                is_chroma: bool, strong: bool, base=None):
    """The whole scan on the card, one launch (and one fill of its scratch):
    CUDA tensors in the layout above; raises on any other. Returns new
    [P, H, W] int32 planes."""
    _check(resid, zidx, tu, mode, base, C, skew, max_tu)
    P, H, W = resid.shape
    ctb_h, ctb_w = H // C, W // C
    dev = resid.device
    out = torch.empty(resid.shape, dtype=torch.int32, device=dev)
    # the lanes' progress flags, then the ticket
    n_lanes = lanes(P, zidx.shape[0], ctb_h)
    scratch = torch.zeros(n_lanes + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _load().hevc_scan_launch(
            resid.data_ptr(), None if base is None else base.data_ptr(),
            zidx.data_ptr(), tu.data_ptr(), mode.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + 4 * n_lanes, P,
            zidx.shape[0], ctb_h, ctb_w, C, max_tu, skew, int(is_chroma),
            int(strong), ZIDX_NONE, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hevc_scan kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
