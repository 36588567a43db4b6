"""The HEVC TU-tree walk of one wavefront scan step: the CUDA kernel
(csrc/hevc_walk.cu) and its plain torch version. The torch scan
(hevc_tiles._intra_scan) calls it once a step; a decode on the card runs
the scan kernel instead (hevc_scan.py), which walks each CTB with this
kernel's device code (csrc/hevc_walk.cuh).

walk(F, Z, resid, tu, mode) -> F evaluates, for every lane (one CTB of one
frame or chroma plane), every z-order TU candidate (n, x0, y0) of the CTB
in order. Where tu marks a TU of size n at (x0, y0) it gathers the 4n+1
reference samples from F, substitutes the unavailable ones (6.4.1 z-index
availability, 8.4.4.2.2), filters them (8.4.4.2.3), predicts (planar, DC,
33 angular modes, 8.4.4.2.4-6), adds the residual, clips to 0..255 and
writes the block back into F, where later candidates read it.

Layout (hevc_tiles._intra_scan builds it), for CTB size C and largest TU
T = min(C, max_tu):
  F     [B, 1+C+T, WF] int16  composite: row 0 = top neighbours, column 0 =
                              left neighbours, the CTB at [1:1+C, 1:1+C]
  Z     [B, 1+C/4+T/4, WZ] int32  decode-order index per 4x4 cell, same
                              +1 border; ZIDX_NONE = never available
  resid [B, C, C] int16       residual, saturated to int16
  tu    [B, C/4, C/4] int32   log2 TU size per cell (0 = none)
  mode  [B, C/4, C/4] int32   intra mode per cell
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import hevc_tables as HT

# Kernel launches made by walk(); read by callers that must show the main
# path went through the kernel.
LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain torch version (vectorised over lanes, one candidate at a time)
# ---------------------------------------------------------------------------

_TABLES = {}


def _tables(n: int, device):
    key = (n, str(device))
    if key not in _TABLES:
        ext_idx, off_idx = HT.pred_idx_tables(n)
        _, _, frac, ishor = HT.pred_tables(n)
        t = lambda a, dt=torch.int64: torch.as_tensor(
            np.asarray(a), dtype=dt, device=device)
        _TABLES[key] = (t(ext_idx), t(off_idx), t(frac, torch.int32),
                        t(ishor, torch.bool),
                        t(HT.filter_flags(n), torch.bool))
    return _TABLES[key]


def _substitute(v, amask, bit_depth=8):
    """Reference-sample substitution (8.4.4.2.2). v [l, L] int32, amask
    [l, L] bool: each unavailable sample takes the nearest available one
    before it in scan order, a leading run the first available one."""
    L = v.shape[-1]
    pos = torch.arange(L, device=v.device).expand_as(v)
    fwd = torch.cummax(torch.where(amask, pos, -1), dim=-1).values
    first = torch.where(amask, pos, L).amin(dim=-1, keepdim=True)
    src = torch.where(fwd >= 0, fwd, first).clamp(max=L - 1)
    out = torch.gather(v, -1, src)
    return torch.where(amask.any(dim=-1, keepdim=True), out,
                       1 << (bit_depth - 1))


def _filter_refs(v, n: int, strong_smoothing: bool):
    """[1 2 1] smoothing, and for n == 32 the strong bilinear variant where
    its flatness test holds (8.4.4.2.3). v [l, 4n+1] int32."""
    sm = v.clone()
    sm[:, 1:-1] = (v[:, :-2] + 2 * v[:, 1:-1] + v[:, 2:] + 2) >> 2
    if n != 32 or not strong_smoothing:
        return sm
    tl, bl, tr = v[:, 2 * n:2 * n + 1], v[:, :1], v[:, 4 * n:]
    t_mid, l_mid = v[:, 3 * n:3 * n + 1], v[:, n:n + 1]
    cond = (((tl + tr - 2 * t_mid).abs() < 8)
            & ((tl + bl - 2 * l_mid).abs() < 8))
    k = torch.arange(2 * n, device=v.device, dtype=torch.int32)
    nl_down = ((2 * n - 1 - k) * tl + (k + 1) * bl + 32) >> 6
    nl_down[:, -1] = bl[:, 0]
    nt = ((2 * n - 1 - k) * tl + (k + 1) * tr + 32) >> 6
    nt[:, -1] = tr[:, 0]
    strong = torch.cat([nl_down.flip(-1), tl, nt], dim=-1)
    return torch.where(cond, strong, sm)


def _predict(vf, mode, n: int, is_chroma: bool):
    """All 35 modes on the substituted (and, per mode, filtered) refs vf
    [l, 4n+1] int32, per-lane mode [l] int64 -> pred [l, n, n] int32."""
    ext_idx, off_idx, frac_t, ishor_t, _ = _tables(n, vf.device)
    l = vf.shape[0]
    log2 = n.bit_length() - 1
    ar = lambda k: torch.arange(k, device=vf.device, dtype=torch.int32)

    # angular: main reference (with projection), then per-row windows
    vpad = torch.cat([vf, vf.new_zeros(l, 1)], dim=-1)
    ext = torch.gather(vpad, 1, ext_idx[mode])                # [l, 3n+2]
    seg_idx = 1 + off_idx[mode][:, :, None] + ar(n + 1).long()
    seg = torch.gather(ext[:, None, :].expand(l, n, 3 * n + 2), 2, seg_idx)
    f = frac_t[mode][:, :, None]
    ang = ((32 - f) * seg[:, :, :n] + f * seg[:, :, 1:] + 16) >> 5
    ang = torch.where(ishor_t[mode][:, None, None], ang.transpose(1, 2), ang)

    # planar (mode 0)
    xs = ar(n)
    left = vf[:, :2 * n].flip(-1)[:, :n + 1]                  # downward
    top = vf[:, 2 * n + 1:2 * n + 1 + n + 1]
    planar = ((n - 1 - xs)[None, None, :] * left[:, :n, None]
              + (xs + 1)[None, None, :] * top[:, n, None, None]
              + (n - 1 - xs)[None, :, None] * top[:, None, :n]
              + (xs + 1)[None, :, None] * left[:, n, None, None]
              + n) >> (log2 + 1)

    # DC (mode 1); vf == v for DC, which is never filtered
    t_row, l_col = top[:, :n], left[:, :n]
    dc = (vf[:, n:2 * n].sum(-1) + t_row.sum(-1) + n) >> (log2 + 1)
    dcp = dc[:, None, None].expand(l, n, n).clone()
    edges = not is_chroma and n < 32
    if edges:
        dcp[:, 0, :] = (t_row + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (l_col + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (l_col[:, 0] + 2 * dc + t_row[:, 0] + 2) >> 2

    m3 = mode[:, None, None]
    out = torch.where(m3 == 0, planar, torch.where(m3 == 1, dcp, ang))

    # pure vertical / horizontal edge filters (luma, n < 32)
    if edges:
        tl = vf[:, 2 * n:2 * n + 1]
        ver_col = (((l_col - tl) >> 1) + t_row[:, :1]).clamp(0, 255)
        hor_row = (((t_row - tl) >> 1) + l_col[:, :1]).clamp(0, 255)
        is_v, is_h = mode == 26, mode == 10
        out[:, :, 0] = torch.where(is_v[:, None], ver_col, out[:, :, 0])
        out[:, 0, :] = torch.where(is_h[:, None], hor_row, out[:, 0, :])
    return out.to(torch.int32)


def _tu_candidate(F, Z, resid, tu, mode, x0: int, y0: int, n: int,
                  is_chroma: bool, strong: bool):
    """One TU candidate of size n at (x0, y0) for every lane; writes the
    reconstruction into F (in place) where tu marks an n-sized TU."""
    cx0, cy0, n4 = x0 >> 2, y0 >> 2, n // 4
    active = tu[:, cy0, cx0] == n.bit_length() - 1
    i32 = lambda a: a.to(torch.int32)
    lcol = i32(F[:, y0 + 1:y0 + 1 + 2 * n, x0])
    corner = i32(F[:, y0, x0:x0 + 1])
    trow = i32(F[:, y0, x0 + 1:x0 + 1 + 2 * n])
    v = torch.cat([lcol.flip(-1), corner, trow], dim=-1)
    # availability: the covering recon event is strictly earlier (6.4.1)
    z_org = Z[:, 1 + cy0, 1 + cx0, None]
    a_l = (Z[:, 1 + cy0:1 + cy0 + 2 * n4, cx0] < z_org).flip(-1)
    a_t = Z[:, cy0, 1 + cx0:1 + cx0 + 2 * n4] < z_org
    a_c = Z[:, cy0, cx0:cx0 + 1] < z_org
    amask = torch.cat([a_l.repeat_interleave(4, -1), a_c,
                       a_t.repeat_interleave(4, -1)], dim=-1)
    vs = _substitute(v, amask)
    m = mode[:, cy0, cx0].long()
    if not is_chroma and n > 4:
        filt = _tables(n, F.device)[4][m]
        vf = torch.where(filt[:, None], _filter_refs(vs, n, strong), vs)
    else:
        vf = vs
    pred = _predict(vf, m, n, is_chroma)
    rec = (pred + i32(resid[:, y0:y0 + n, x0:x0 + n])).clamp(0, 255)
    blk = F[:, y0 + 1:y0 + 1 + n, x0 + 1:x0 + 1 + n]
    blk.copy_(torch.where(active[:, None, None], rec.to(F.dtype), blk))


def walk_reference(F, Z, resid, tu, mode, *, C: int, max_tu: int,
                   is_chroma: bool, strong: bool):
    """Plain torch walk on any device: every candidate of
    hevc_tables.zorder_candidates in order. Returns a new F."""
    F = F.clone()
    for n, x0, y0 in HT.zorder_candidates(C, max_tu):
        _tu_candidate(F, Z, resid, tu, mode, x0, y0, n, is_chroma, strong)
    return F


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _check(F, Z, resid, tu, mode, C, max_tu):
    T = min(C, max_tu)
    if C not in (8, 16, 32, 64) or T < 4 or T > 32 or C // T > 2:
        raise ValueError(f"unsupported walk geometry C={C} max_tu={max_tu}")
    B, _, WF = F.shape
    WZ = Z.shape[-1]
    C4 = C // 4
    want = {"F": (F, torch.int16, (B, 1 + C + T, WF)),
            "Z": (Z, torch.int32, (B, 1 + C4 + T // 4, WZ)),
            "resid": (resid, torch.int16, (B, C, C)),
            "tu": (tu, torch.int32, (B, C4, C4)),
            "mode": (mode, torch.int32, (B, C4, C4))}
    for name, (t, dt, shape) in want.items():
        if t.device != F.device:
            raise ValueError(f"{name} on {t.device}, F on {F.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if WF < 1 + C + T or WZ < 1 + (C + T) // 4:
        raise ValueError(f"F/Z too narrow: WF={WF} WZ={WZ}")


_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build
        lib = ctypes.CDLL(_build.build())
        fn = lib.hevc_walk_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def walk(F, Z, resid, tu, mode, *, C: int, max_tu: int, is_chroma: bool,
         strong: bool):
    """One scan step's TU walk. CPU tensors take walk_reference; CUDA
    tensors launch the kernel (or raise). Returns a new F."""
    if F.device.type == "cpu":
        return walk_reference(F, Z, resid, tu, mode, C=C, max_tu=max_tu,
                              is_chroma=is_chroma, strong=strong)
    if F.device.type != "cuda":
        raise ValueError(f"walk: unsupported device {F.device}")
    _check(F, Z, resid, tu, mode, C, max_tu)
    out = torch.empty_like(F)
    B, HF, WF = F.shape
    HZ, WZ = Z.shape[1:]
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = _load().hevc_walk_launch(
            F.data_ptr(), out.data_ptr(), Z.data_ptr(), resid.data_ptr(),
            tu.data_ptr(), mode.data_ptr(), B, HF, WF, HZ, WZ, C, max_tu,
            int(is_chroma), int(strong), stream)
    if err != 0:
        raise RuntimeError(f"hevc_walk kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
