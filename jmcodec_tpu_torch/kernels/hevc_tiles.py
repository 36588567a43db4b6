"""HEVC reconstruction in torch: plan tensors in, uint8 (Y, U, V) out. The
port of jmcodec_tpu/kernels/hevc_tiles.py, the all-intra batch path and the
inter (P/B) path:

  0. inter only - phase-plane motion compensation of both lists from the
                  references' phase pyramids (prep_hevc_ref), weighted
                  combine, + the inter residuals: the inter base
  1. residuals  - dequant + two-stage inverse DCT/DST a TU at a time: on
                  the card one launch of the hand-written CUDA kernel for
                  the luma planes of a call and one for Cb + Cr
                  (hevc_resid.py), on the CPU its plain torch version
                  (per-TU-size batched float64 matrix products)
  2. intra scan - CTB-diagonal wavefront, lanes = CTB rows of every frame
                  (and of Cb and Cr for chroma): on the card one launch of
                  the hand-written CUDA kernel a scan (hevc_scan.py), on the
                  CPU a torch loop over the diagonals, one walk() a diagonal
                  (the plain torch walk of hevc_walk.py). An inter picture
                  seeds the planes with its base; a CTB (on the card) or a
                  diagonal (on the CPU) without a TU is not walked.
  3. deblock    - whole-plane vectorised V pass then H pass (8.7.2)
  4. SAO        - per-CTB parameters broadcast to pixels (8.7.3)

Every function takes tensors on one device and keeps them there. The
entry points that take plans (stack_plans, decode_plans_batch, decode_plan,
decode_plan_inter) put them on the card unless the caller names another
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.hevc.plan import ZIDX_NONE
from ..utils.device import require_cuda
from . import hevc_resid as HR
from . import hevc_tables as HT
from ._planes import cell_origins, edge_pad
from ._tables import device_table as _t
from .hevc_scan import scan_planes
from .hevc_walk import walk

_I32 = torch.int32


# ---------------------------------------------------------------------------
# phase 2: intra reconstruction scan (CTB-diagonal wavefront)
# ---------------------------------------------------------------------------


def _plane_to_ctb_tiles(plane, ctb_h: int, ctb_w: int, C: int):
    """[..., ctb_h*C, ctb_w*C] -> [..., ctb_h, ctb_w, C, C]."""
    *lead, _, _ = plane.shape
    return plane.reshape(*lead, ctb_h, C, ctb_w, C).transpose(-3, -2)


def _skew(tiles, cys, cxs):
    """[F, ctb_h, ctb_w, ...] tiles -> [steps, F*ctb_h, ...]: lane k of
    frame f at step d holds CTB (cys[d, k], cxs[d, k])."""
    sk = tiles[:, cys, cxs]                       # [F, steps, ctb_h, ...]
    sk = sk.transpose(0, 1)
    return sk.reshape(sk.shape[0], -1, *sk.shape[3:])


def _unskew_to_plane(tiles, cys, cxs, valid, ctb_h: int, ctb_w: int,
                     C: int):
    """[steps, F*ctb_h, C, C] skewed tiles -> [F, ctb_h*C, ctb_w*C]. Slots
    of invalid (off-picture) steps land in a spare row that is dropped."""
    steps = tiles.shape[0]
    nf = tiles.shape[1] // ctb_h
    flat = torch.where(valid == 1, cys * ctb_w + cxs, ctb_h * ctb_w)
    src = tiles.reshape(steps, nf, ctb_h, C, C).transpose(0, 1)
    out = tiles.new_zeros((nf, ctb_h * ctb_w + 1, C, C))
    out[:, flat.reshape(-1)] = src.reshape(nf, steps * ctb_h, C, C)
    out = out[:, :-1].reshape(nf, ctb_h, ctb_w, C, C).transpose(2, 3)
    return out.reshape(nf, ctb_h * C, ctb_w * C)


def _intra_scan(resid_t, zidx_t, tu_t, mode_t, valid_t, has_left_t,
                C: int, skew: int, max_tu: int, is_chroma: bool,
                strong: bool, groups: int = 1, walk_fn=walk, base_t=None,
                has_tu=None):
    """One wavefront over skewed tiles: resid_t [steps, B, C, C] int16;
    zidx/tu/mode [steps, B, C/4, C/4] int32; valid/has_left [steps, B].
    Returns recon tiles [steps, B, C, C] int32.

    The lane axis holds `groups` stacks of CTB rows (frames, and Cb/Cr for
    chroma); the first lane of each stack has no top neighbour. Each step
    assembles the composite F (top/left borders from the carry) and Z,
    then runs the TU walk (walk_fn) of every lane.

    Inter pictures: base_t [steps, B, C, C] int16 seeds the interior of F
    (intra TUs overwrite their areas), and has_tu [steps] bool, decided on
    the host, marks the steps that hold a TU (None: every step). A step
    without one is its base: a walk without a TU returns F unchanged, so
    neither F nor Z is assembled and the walk is not launched."""
    n_steps, B = resid_t.shape[:2]
    dev = resid_t.device
    C4 = C // 4
    PB = min(C, max_tu)           # bottom rows: below-left references
    WF = 1 + skew * C
    WZ = 1 + skew * C4
    lane_has_top = (torch.arange(B, device=dev) % (B // groups)) > 0
    # an off-picture lane holds a copy of its row's first or last CTB; with
    # no TU marked the walk skips it (its output is dropped either way)
    tu_t = torch.where((valid_t == 1)[:, :, None, None], tu_t, 0)
    roll1 = lambda x: torch.roll(x, 1, dims=0)
    # carry: the last skew+1 bottom rows (newest first), the left column
    Rpx = [torch.zeros((B, C), dtype=_I32, device=dev)] * (skew + 1)
    Rz = [torch.full((B, C4), ZIDX_NONE, dtype=_I32, device=dev)] * (skew + 1)
    Cpx = torch.zeros((B, C), dtype=_I32, device=dev)
    Cz = torch.full((B, C4), ZIDX_NONE, dtype=_I32, device=dev)
    out = []
    for d in range(n_steps):
        zw = zidx_t[d]
        if has_tu is not None and not has_tu[d]:
            Yw = base_t[d].to(_I32)
        else:
            hl = has_left_t[d] == 1
            F = torch.zeros((B, 1 + C + PB, WF), dtype=torch.int16,
                            device=dev)
            if base_t is not None:
                F[:, 1:1 + C, 1:1 + C] = base_t[d]
            F[:, 0, 1:] = torch.cat([roll1(Rpx[skew - 1 - j])
                                     for j in range(skew)], dim=-1)
            F[:, 0, 0] = roll1(Rpx[skew])[:, -1]
            F[:, 1:1 + C, 0] = Cpx
            Z = torch.full((B, 1 + C4 + PB // 4, WZ), ZIDX_NONE, dtype=_I32,
                           device=dev)
            Z[:, 1:1 + C4, 1:1 + C4] = zw
            ztop = torch.cat([roll1(Rz[skew - 1 - j])
                              for j in range(skew)], dim=-1)
            Z[:, 0, 1:] = torch.where(lane_has_top[:, None], ztop,
                                      ZIDX_NONE)
            Z[:, 1:1 + C4, 0] = torch.where(hl[:, None], Cz, ZIDX_NONE)
            Z[:, 0, 0] = torch.where(lane_has_top & hl,
                                     roll1(Rz[skew])[:, -1], ZIDX_NONE)
            F = walk_fn(F, Z, resid_t[d], tu_t[d], mode_t[d], C=C,
                        max_tu=max_tu, is_chroma=is_chroma, strong=strong)
            Yw = F[:, 1:1 + C, 1:1 + C].to(_I32)
        vm = (valid_t[d] == 1)[:, None]
        Rpx = [torch.where(vm, Yw[:, C - 1, :], 0)] + Rpx[:-1]
        Rz = [torch.where(vm, zw[:, C4 - 1, :], ZIDX_NONE)] + Rz[:-1]
        Cpx = torch.where(vm, Yw[:, :, C - 1], 0)
        Cz = torch.where(vm, zw[:, :, C4 - 1], ZIDX_NONE)
        out.append(Yw)
    return torch.stack(out)


def scan_torch(resid, zidx, tu, mode, *, C: int, skew: int, max_tu: int,
               is_chroma: bool, strong: bool, walk_fn=walk, base=None,
               has_tu=None):
    """The scan in hevc_scan's plane layout on the torch route: the CTB rows
    of the planes skewed into lanes (plane p on cell map p % G), _intra_scan
    with walk_fn, its tiles unskewed. resid / base [P, H, W] int16, zidx /
    tu / mode [G, H/4, W/4] int32, has_tu as _intra_scan's. Returns
    [P, H, W] int32."""
    P, H, W = resid.shape
    G = zidx.shape[0]
    ctb_h, ctb_w = H // C, W // C
    cys, cxs, valid, has_left = (
        _t(a, resid.device, torch.int64)
        for a in HT.skew_geometry(ctb_h, ctb_w, skew))

    def lanes(planes, n):
        return _skew(_plane_to_ctb_tiles(planes, ctb_h, ctb_w, n), cys, cxs)

    cells = lambda a: lanes(a, C // 4).repeat(1, P // G, 1, 1)
    tiles = _intra_scan(
        lanes(resid, C), cells(zidx), cells(tu), cells(mode),
        valid.repeat(1, P), has_left.repeat(1, P), C, skew, max_tu,
        is_chroma=is_chroma, strong=strong, groups=P, walk_fn=walk_fn,
        base_t=None if base is None else lanes(base, C), has_tu=has_tu)
    return _unskew_to_plane(tiles, cys, cxs, valid, ctb_h, ctb_w, C)


def scan_kernel(device, walk_fn=walk) -> bool:
    """Does decode_frames_hevc_scan run each scan as the CUDA kernel
    (hevc_scan.scan_planes), and the residual stage as the CUDA kernel
    hevc_resid.resid_planes (there and in decode_frame_hevc_inter)? On a
    CUDA device with the default walk_fn; CPU tensors, and any other
    walk_fn (walk_reference: the plain route of the checks), take the
    torch scan with that walk and hevc_resid.planes_reference. No other
    route: a failed build or launch raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the HEVC scan runs on the CPU or a CUDA device, "
                         f"not {device}")
    return device.type == "cuda" and walk_fn is walk


# ---------------------------------------------------------------------------
# phase 3: deblocking (8.7.2), batched over frames: V pass, then H pass
# ---------------------------------------------------------------------------


def _deblock_luma_v(Y, bs_col, qp_p, qp_q, beta_off, tc_off):
    """Filter all vertical luma edges at x = 8, 16, ... in one shot.
    Y [N, Hp, Wp]; bs_col/qp_p/qp_q [N, Hp/4, ne] per 4-row segment per
    edge; beta_off/tc_off [N]."""
    N, Hp, Wp = Y.shape
    dev = Y.device
    ne = Wp // 8 - 1
    win = Y[:, :, 4:4 + ne * 8].reshape(N, Hp // 4, 4, ne, 8)
    p = win[..., :4].flip(-1)                # [N, seg, line, edge, 4] p0..p3
    q = win[..., 4:8]
    qpl = (qp_p + qp_q + 1) >> 1             # [N, seg, edge]
    bo, to = beta_off[:, None, None], tc_off[:, None, None]
    beta = _t(HT.BETA_T, dev)[(qpl + bo).clamp(0, 51).long()]
    tc = _t(HT.TC_T, dev)[(qpl + 2 * (bs_col - 1) + to).clamp(0, 53).long()]

    d2 = lambda a: (a[..., 2] - 2 * a[..., 1] + a[..., 0]).abs()
    dp0, dp3 = d2(p[:, :, 0]), d2(p[:, :, 3])    # [N, seg, edge]
    dq0, dq3 = d2(q[:, :, 0]), d2(q[:, :, 3])
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    act = (bs_col > 0) & (dpq0 + dpq3 < beta)

    def strong_i(i, dpq):
        pi, qi = p[:, :, i], q[:, :, i]
        return ((2 * dpq < (beta >> 2))
                & ((pi[..., 3] - pi[..., 0]).abs()
                   + (qi[..., 0] - qi[..., 3]).abs() < (beta >> 3))
                & ((pi[..., 0] - qi[..., 0]).abs() < ((5 * tc + 1) >> 1)))
    strong = strong_i(0, dpq0) & strong_i(3, dpq3)

    tc_l = tc[:, :, None, :]                 # broadcast over lines
    p0, p1, p2, p3 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    cl = lambda v, r: torch.minimum(torch.maximum(v, r - 2 * tc_l),
                                    r + 2 * tc_l)
    sp0 = cl((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = cl((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = cl((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = cl((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = cl((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = cl((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wact = delta0.abs() < tc_l * 10          # per line
    delta = torch.minimum(torch.maximum(delta0, -tc_l), tc_l)
    wp0 = (p0 + delta).clamp(0, 255)
    wq0 = (q0 - delta).clamp(0, 255)
    side_thr = (beta + (beta >> 1)) >> 3
    dep = (dp0 + dp3 < side_thr)[:, :, None, :]
    deq = (dq0 + dq3 < side_thr)[:, :, None, :]
    tch = tc_l >> 1
    dpv = torch.minimum(torch.maximum(
        (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tch), tch)
    dqv = torch.minimum(torch.maximum(
        (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tch), tch)
    wp1 = (p1 + dpv).clamp(0, 255)
    wq1 = (q1 + dqv).clamp(0, 255)

    sm = (act & strong)[:, :, None, :]
    wk = (act & ~strong)[:, :, None, :] & wact
    np0 = torch.where(sm, sp0, torch.where(wk, wp0, p0))
    np1 = torch.where(sm, sp1, torch.where(wk & dep, wp1, p1))
    np2 = torch.where(sm, sp2, p2)
    nq0 = torch.where(sm, sq0, torch.where(wk, wq0, q0))
    nq1 = torch.where(sm, sq1, torch.where(wk & deq, wq1, q1))
    nq2 = torch.where(sm, sq2, q2)
    new = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], dim=-1)
    return torch.cat([Y[:, :, :4], new.reshape(N, Hp, ne * 8),
                      Y[:, :, 4 + ne * 8:]], dim=2)


def _deblock_chroma_v(P, bs_col, qp_p, qp_q, qp_off, tc_off):
    """P [N, Hc, Wc] one chroma plane per frame; bs/qp [N, Hc/4, ne] per
    4-row chroma segment per edge (edges at chroma x = 8, 16, ...)."""
    N, Hc, Wc = P.shape
    dev = P.device
    ne = Wc // 8 - 1
    win = P[:, :, 6:6 + ne * 8].reshape(N, Hc // 4, 4, ne, 8)
    p1, p0, q0, q1 = win[..., :4].unbind(-1)
    qpl = (qp_p + qp_q + 1) >> 1
    qpc = _t(HT.QPC_T, dev)[(qpl + qp_off[:, None, None]).clamp(0, 57).long()]
    tc = _t(HT.TC_T, dev)[(qpc + 2 + tc_off[:, None, None]).clamp(0,
                                                                  53).long()]
    act = ((bs_col >= 2) & (tc > 0))[:, :, None, :]
    tc_l = tc[:, :, None, :]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc_l), tc_l)
    np0 = torch.where(act, (p0 + delta).clamp(0, 255), p0)
    nq0 = torch.where(act, (q0 - delta).clamp(0, 255), q0)
    new = torch.cat([torch.stack([p1, np0, nq0, q1], dim=-1),
                     win[..., 4:8]], dim=-1)
    return torch.cat([P[:, :, :6], new.reshape(N, Hc, ne * 8),
                      P[:, :, 6 + ne * 8:]], dim=2)


def _deblock(Y, U, V, bs_ver, bs_hor, qp_cell, beta_off, tc_off,
             cb_qp_off, cr_qp_off):
    """Full HEVC deblock over a frame batch: luma + chroma V pass, then
    luma + chroma H pass (as the V pass on transposed planes)."""
    T = lambda a: a.transpose(-1, -2)

    def luma_pass(Yp, bs_map, qp_map):
        ne = Yp.shape[-1] // 8 - 1
        return _deblock_luma_v(Yp, bs_map[..., 2::2][..., :ne],
                               qp_map[..., 1::2][..., :ne],
                               qp_map[..., 2::2][..., :ne], beta_off, tc_off)

    def chroma_pass(Pp, bs_map, qp_map, off):
        ne = Pp.shape[-1] // 8 - 1
        return _deblock_chroma_v(Pp, bs_map[..., 0::2, 4::4][..., :ne],
                                 qp_map[..., 0::2, 3::4][..., :ne],
                                 qp_map[..., 0::2, 4::4][..., :ne],
                                 off, tc_off)

    Y = luma_pass(Y, bs_ver, qp_cell)
    U = chroma_pass(U, bs_ver, qp_cell, cb_qp_off)
    V = chroma_pass(V, bs_ver, qp_cell, cr_qp_off)
    Y = T(luma_pass(T(Y), T(bs_hor), T(qp_cell)))
    U = T(chroma_pass(T(U), T(bs_hor), T(qp_cell), cb_qp_off))
    V = T(chroma_pass(T(V), T(bs_hor), T(qp_cell), cr_qp_off))
    return Y, U, V


# ---------------------------------------------------------------------------
# phase 4: SAO (8.7.3), batched over frames
# ---------------------------------------------------------------------------


def _sao_plane(plane, typ, offs, band, eo, log2n: int, pw: int, ph: int):
    """plane [N, H, W] post-deblock int32; typ/band/eo [N, ctbh, ctbw];
    offs [N, ctbh, ctbw, 4]. log2n = CTB size in this plane's samples;
    pw/ph = the coded size in this plane's samples."""
    N, H, W = plane.shape
    dev = plane.device
    n = 1 << log2n
    up = lambda a: a.repeat_interleave(n, 1).repeat_interleave(n, 2)[
        :, :H, :W]
    T, B, E = up(typ), up(band), up(eo)
    O = [up(offs[..., k]) for k in range(4)]
    src = plane

    b = src >> 3
    badd = torch.zeros_like(src)
    for k in range(4):
        badd = badd + torch.where(b == ((B + k) & 31), O[k], 0)

    rows = (torch.arange(-1, H + 1, device=dev)).clamp(0, H - 1)
    cols = (torch.arange(-1, W + 1, device=dev)).clamp(0, W - 1)
    pad = src[:, rows][:, :, cols]                    # edge padding by 1
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    eadd = torch.zeros_like(src)
    for c, (dx, dy) in enumerate(((1, 0), (0, 1), (1, 1), (-1, 1))):
        na = pad[:, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W]
        nb = pad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        sgn = torch.sign(src - na) + torch.sign(src - nb)
        # edge category (Table 8-12): -2, -1, 1, 2 -> O[0..3]; 0 -> none
        add_c = (torch.where(sgn == -2, O[0], 0)
                 + torch.where(sgn == -1, O[1], 0)
                 + torch.where(sgn == 1, O[2], 0)
                 + torch.where(sgn == 2, O[3], 0))
        valid = ((xs + dx >= 0) & (xs + dx < pw) & (xs - dx >= 0)
                 & (xs - dx < pw) & (ys + dy >= 0) & (ys + dy < ph)
                 & (ys - dy >= 0) & (ys - dy < ph))
        eadd = torch.where((E == c) & valid, add_c, eadd)

    return torch.where(T == 1, (src + badd).clamp(0, 255),
                       torch.where(T == 2, (src + eadd).clamp(0, 255), src))


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def decode_frames_hevc_batch(Hp: int, Wp: int, log2_ctb: int, strong: bool,
                             deblock_on: bool, pw: int, ph: int,
                             width: int, height: int,
                             coeff_y, tu_y, mode_y, zidx_y, qp_y,
                             coeff_cb, coeff_cr, tu_c, mode_c, zidx_c,
                             cb_qp_off, cr_qp_off, beta_off, tc_off,
                             bs_ver, bs_hor,
                             sao_type, sao_offsets, sao_band, sao_eo, *,
                             walk_fn=walk, base=None, has_tu=None):
    """Batched all-intra HEVC decode. Every tensor carries a leading frame
    axis [F, ...] (per-frame scalars are [F]) and lies on one device, in
    the compact dtypes of stack_plans. Frames are stacked on the
    wavefront's lane axis, so the sequential depth of the scan is shared
    by the whole batch. walk_fn is the torch scan's TU walk: the default
    (hevc_walk.walk) lets a decode on the card take the scan kernel
    (scan_kernel); checks pass hevc_walk.walk_reference for the plain
    route. Returns (Y, U, V) uint8 [F, height, width] (and half size for
    chroma) on the same device.

    decode_frame_hevc_inter passes base, the inter base planes (Y, Cb, Cr)
    [F, Hp, Wp] (half size for chroma) int32 that seed the scans, and
    has_tu, the (luma, chroma) steps of walk_steps that the torch scan
    walks (the kernel decides CTB by CTB on the card).

    The decode is its two stages in turn: decode_frames_hevc_scan, then
    decode_frames_hevc_filters (parallel/framepp.py runs them on two
    devices)."""
    Y, U, V = decode_frames_hevc_scan(
        Hp, Wp, log2_ctb, strong, coeff_y, tu_y, mode_y, zidx_y, qp_y,
        coeff_cb, coeff_cr, tu_c, mode_c, zidx_c, cb_qp_off, cr_qp_off,
        walk_fn=walk_fn, base=base, has_tu=has_tu)
    return decode_frames_hevc_filters(
        log2_ctb, deblock_on, pw, ph, width, height, Y, U, V, qp_y,
        cb_qp_off, cr_qp_off, beta_off, tc_off, bs_ver, bs_hor, sao_type,
        sao_offsets, sao_band, sao_eo)


def decode_frames_hevc_scan(Hp: int, Wp: int, log2_ctb: int, strong: bool,
                            coeff_y, tu_y, mode_y, zidx_y, qp_y,
                            coeff_cb, coeff_cr, tu_c, mode_c, zidx_c,
                            cb_qp_off, cr_qp_off, *, walk_fn=walk, base=None,
                            has_tu=None):
    """The scan stage of decode_frames_hevc_batch (its arguments of the
    same names): residuals (hevc_resid.resid_planes, one launch for luma
    and one for Cb + Cr, on scan_kernel's route; else planes_reference),
    then the luma and chroma
    wavefront scans, one hevc_scan.scan_planes launch each on the card
    (scan_kernel), the torch scan with walk_fn elsewhere (has_tu: the
    steps it walks). Returns the int32 coded-size planes (Y, U, V) [F, Hp,
    Wp] (half size for chroma), before the in-loop filters."""
    kernel = scan_kernel(coeff_y.device, walk_fn)
    residuals = HR.resid_planes if kernel else HR.planes_reference
    # ---- residuals: int16 planes, luma [F, ...]; [Cb of every frame, Cr
    # of every frame] ----
    resid_y = residuals((coeff_y,), tu_y, qp_y, sizes=HR.LUMA_SIZES,
                        dst4=True)
    resid_c = residuals((coeff_cb, coeff_cr), tu_c, qp_y,
                        sizes=HR.CHROMA_SIZES, offsets=(cb_qp_off, cr_qp_off))
    zidx_y, tu_y, mode_y, zidx_c, tu_c, mode_c = (
        a.to(_I32) for a in (zidx_y, tu_y, mode_y, zidx_c, tu_c, mode_c))
    nf = coeff_y.shape[0]
    C = 1 << log2_ctb
    skew = HT.skew_for(C)
    i16 = lambda a: a.clamp(-32768, 32767).to(torch.int16)

    # ---- luma: frames stacked on the lanes; chroma: [Cb of every frame,
    # Cr of every frame] on one map a frame ----
    luma = ((resid_y, zidx_y, tu_y, mode_y),
            dict(C=C, skew=skew, max_tu=32, is_chroma=False, strong=strong,
                 base=None if base is None else i16(base[0])))
    chroma = ((resid_c, zidx_c, tu_c, mode_c),
              dict(C=C // 2, skew=skew, max_tu=16, is_chroma=True,
                   strong=False,
                   base=None if base is None else i16(torch.cat(base[1:]))))
    if kernel:
        Y, UV = (scan_planes(*(a.contiguous() for a in args), **kw)
                 for args, kw in (luma, chroma))
    else:
        has_y, has_c = (None, None) if has_tu is None else has_tu
        Y, UV = (scan_torch(*args, **kw, walk_fn=walk_fn, has_tu=has)
                 for (args, kw), has in ((luma, has_y), (chroma, has_c)))
    return Y, UV[:nf], UV[nf:]


def decode_frames_hevc_filters(log2_ctb: int, deblock_on: bool, pw: int,
                               ph: int, width: int, height: int, Y, U, V,
                               qp_y, cb_qp_off, cr_qp_off, beta_off, tc_off,
                               bs_ver, bs_hor, sao_type, sao_offsets,
                               sao_band, sao_eo):
    """The filter stage of decode_frames_hevc_batch (its arguments of the
    same names) on the scan stage's planes: deblock, SAO and the
    conformance crop. Returns (Y, U, V) uint8 [F, height, width] (half
    size for chroma)."""
    (qp_y, cb_qp_off, cr_qp_off, beta_off, tc_off, bs_ver, bs_hor, sao_type,
     sao_offsets, sao_band, sao_eo) = (
        a.to(_I32) for a in (
            qp_y, cb_qp_off, cr_qp_off, beta_off, tc_off, bs_ver, bs_hor,
            sao_type, sao_offsets, sao_band, sao_eo))
    if deblock_on:
        Y, U, V = _deblock(Y, U, V, bs_ver, bs_hor, qp_y, beta_off, tc_off,
                           cb_qp_off, cr_qp_off)
    Y = _sao_plane(Y, sao_type[..., 0], sao_offsets[..., 0, :],
                   sao_band[..., 0], sao_eo[..., 0], log2_ctb, pw, ph)
    U = _sao_plane(U, sao_type[..., 1], sao_offsets[..., 1, :],
                   sao_band[..., 1], sao_eo[..., 1], log2_ctb - 1,
                   pw // 2, ph // 2)
    V = _sao_plane(V, sao_type[..., 2], sao_offsets[..., 2, :],
                   sao_band[..., 2], sao_eo[..., 2], log2_ctb - 1,
                   pw // 2, ph // 2)
    u8 = lambda a, h, w: a[:, :h, :w].to(torch.uint8)
    return (u8(Y, height, width), u8(U, height // 2, width // 2),
            u8(V, height // 2, width // 2))


def _geometry(p):
    return (p.Hp, p.Wp, p.log2_ctb, bool(p.strong_smoothing),
            not p.deblock_disabled, p.pw, p.ph, p.width, p.height)


def stack_plans(plans, device=None):
    """Same-geometry HevcFramePlans -> the argument tuple of
    decode_frames_hevc_batch, its tensors on `device` (None: the card,
    which must be there). Plan tensors travel in compact dtypes
    (coefficient levels fit int16, maps int8) and are widened once on the
    device."""
    if device is None:
        device = require_cuda()
    st = lambda f, dt: torch.from_numpy(
        np.stack([f(p) for p in plans]).astype(dt)).to(device)
    sc = lambda f: torch.tensor([f(p) for p in plans], dtype=_I32,
                                device=device)
    return (_geometry(plans[0]) +
            (st(lambda p: p.coeff_y, np.int16),
             st(lambda p: p.tu_log2_y, np.int8),
             st(lambda p: p.mode_y, np.int8),
             st(lambda p: p.zidx_y, np.int32),
             st(lambda p: p.qp_y, np.int8),
             st(lambda p: p.coeff_cb, np.int16),
             st(lambda p: p.coeff_cr, np.int16),
             st(lambda p: p.tu_log2_c, np.int8),
             st(lambda p: p.mode_c, np.int8),
             st(lambda p: p.zidx_c, np.int32)) +
            (sc(lambda p: p.cb_qp_off), sc(lambda p: p.cr_qp_off),
             sc(lambda p: p.beta_off), sc(lambda p: p.tc_off)) +
            (st(lambda p: p.bs_ver, np.int8),
             st(lambda p: p.bs_hor, np.int8),
             st(lambda p: p.sao_type, np.int8),
             st(lambda p: p.sao_offsets, np.int8),
             st(lambda p: p.sao_band, np.int8),
             st(lambda p: p.sao_eo, np.int8)))


def _check_plans(plans):
    key = _geometry(plans[0])
    for p in plans:
        if not p.supported:
            raise NotImplementedError(f"plan unsupported: {p.reason}")
        if _geometry(p) != key:
            raise NotImplementedError("mixed-geometry plan batch")


def decode_plans_batch(plans, device=None):
    """Same-geometry HevcFramePlans -> batched (Y, U, V) uint8 [F, h, w]
    on `device` (None: the card)."""
    _check_plans(plans)
    return decode_frames_hevc_batch(*stack_plans(plans, device))


def decode_plan(plan, device=None, coded: bool = False):
    """One HevcFramePlan -> (Y, U, V) uint8 on `device` (None: the card), a
    batch of one.
    coded=True returns the coded-size planes, before the conformance-window
    crop, as a reference picture store needs them."""
    _check_plans([plan])
    args = stack_plans([plan], device)
    h, w = (plan.ph, plan.pw) if coded else (plan.height, plan.width)
    Y, U, V = decode_frames_hevc_batch(*args[:7], w, h, *args[9:])
    return Y[0], U[0], V[0]


# ---------------------------------------------------------------------------
# inter pictures (P/B): phase-plane motion compensation
# ---------------------------------------------------------------------------
# MC is a per-4x4-cell gather from precomputed fractional-phase plane
# pyramids of each reference (16 luma quarter-pel phases; chroma keeps the
# 8 horizontal eighth-pel phases and applies the 4-tap vertical filter at
# gather time). Interpolated values are held at the spec's 14-bit
# intermediate precision so bi-prediction combines exactly (8.5.4.2.2).

MC_PAD_HEVC = 64   # luma pad; plan gates |mv| <= 4*(PAD-8) quarter-pel

_LUMA_F = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int32)
_CHROMA_F = np.array([
    [0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
    [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4],
    [-2, 10, 58, -2]], np.int32)


def _fir(a, taps, dim: int):
    """Each filter of taps [P, T] (a table of this module) along dim of the
    int32 tensor a, over its edge-padded window (T/2 - 1 samples before
    the sample, T/2 after) -> [P, *a.shape] int32."""
    P, T = taps.shape
    n = a.shape[dim]
    ap = edge_pad(a, dim, T // 2 - 1, T // 2)
    f = _t(taps, a.device).reshape(P, T, *([1] * a.dim()))
    out = 0
    for k in range(T):
        out = out + f[:, k] * ap.narrow(dim, k, n)
    return out


def prep_hevc_ref(Y, U, V):
    """Coded-size uint8 planes -> (luma_ph [16, Hp2, Wp2] int16,
    cb_ph [8, ...], cr_ph [8, ...]) fractional-phase pyramids, padded by
    MC_PAD_HEVC (luma) / MC_PAD_HEVC//2 (chroma), 14-bit sample scale.
    Luma phase yf*4 + xf is the horizontal filter of phase xf, then the
    vertical filter of phase yf, >> 6: phase 0's filter is 64 times the
    sample, so the integer positions keep sample << 6. The sums reach
    about 2e6 before the shift and stay within int16 after it."""
    P = MC_PAD_HEVC
    pad = lambda a, p: edge_pad(edge_pad(a.to(_I32), -2, p, p), -1, p, p)
    y = pad(Y, P)
    hor = _fir(y, _LUMA_F, -1)                          # [xf, Hp2, Wp2]
    luma = (_fir(hor, _LUMA_F, -2) >> 6).reshape(16, *y.shape)
    chroma = lambda c: _fir(pad(c, P // 2), _CHROMA_F, -1).to(torch.int16)
    return luma.to(torch.int16), chroma(U), chroma(V)


def _gather(src, *idx):
    """src[idx[0], idx[1], ...] over every dim of src, the indices
    broadcast together, with XLA's bounds: a negative index counts once
    from the end, then each is clamped into its dim. The plan's MV gate
    keeps every index in range; the clamp makes both packages agree on any
    plan. One flattened int64 index."""
    flat = 0
    for n, i in zip(src.shape, idx):
        flat = flat * n + torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return src.reshape(-1)[flat]


def _mc_hevc_luma(ref_ph, mv, slot):
    """ref_ph [R, 16, Hp2, Wp2] int16; mv [Hc, Wc, 2] / slot [Hc, Wc] per
    4x4 cell -> [Hc, Wc, 4, 4] int32 14-bit prediction."""
    mv, slot = mv.long(), slot.long()
    y0, x0 = cell_origins(slot, 4, MC_PAD_HEVC)
    xi = x0 + (mv[..., 0] >> 2)
    yi = y0 + (mv[..., 1] >> 2)
    ph = (mv[..., 1] & 3) * 4 + (mv[..., 0] & 3)
    r4 = torch.arange(4, device=slot.device)
    rows = yi[..., None, None] + r4[:, None]
    cols = xi[..., None, None] + r4[None, :]
    return _gather(ref_ph, slot[..., None, None], ph[..., None, None],
                   rows, cols).to(_I32)


def _mc_hevc_chroma(ref_ph, mv, slot):
    """ref_ph [R, 8, Hc2, Wc2] int16 horizontal phases; 4-tap vertical at
    gather time -> [Hc, Wc, 2, 2] int32 14-bit (per co-located 2x2 block)."""
    mv, slot = mv.long(), slot.long()
    dev = slot.device
    y0, x0 = cell_origins(slot, 2, MC_PAD_HEVC // 2)
    xi = x0 + (mv[..., 0] >> 3)
    yi = y0 + (mv[..., 1] >> 3)
    xf = mv[..., 0] & 7
    taps = _t(_CHROMA_F, dev)[mv[..., 1] & 7]          # [Hc, Wc, 4]
    rows = yi[..., None, None] + (torch.arange(5, device=dev) - 1)[:, None]
    cols = xi[..., None, None] + torch.arange(2, device=dev)[None, :]
    win = _gather(ref_ph, slot[..., None, None], xf[..., None, None],
                  rows, cols).to(_I32)                  # [Hc, Wc, 5, 2]
    out = sum(taps[..., k, None, None] * win[..., k:k + 2, :]
              for k in range(4))
    return out >> 6


def _combine_pred(p0, p1, fl0, fl1, w0, o0, w1, o1, log2wd: int):
    """14-bit list predictions -> 8-bit samples. ONE uniform formula for
    default AND explicit weighted prediction (8.5.4.2.3.3): the default
    combine equals the explicit one at identity weights (w=1, o=0,
    denom=0, so log2wd=6), which is what the plan carries for unweighted
    slices. w/o are per-4x4-cell planes."""
    e = lambda a: a[..., None, None]
    bi = e((fl0 & fl1) != 0)
    f0 = e(fl0 != 0)
    w0e, o0e, w1e, o1e = e(w0), e(o0), e(w1), e(o1)
    half = 1 << (log2wd - 1)
    bi_v = (p0 * w0e + p1 * w1e +
            ((o0e + o1e + 1) << log2wd)) >> (log2wd + 1)
    uni0 = ((p0 * w0e + half) >> log2wd) + o0e
    uni1 = ((p1 * w1e + half) >> log2wd) + o1e
    out = torch.where(bi, bi_v, torch.where(f0, uni0, uni1))
    return out.clamp(0, 255)


def _cells_to_plane_j(cells):
    gh, gw, n, _ = cells.shape
    return cells.permute(0, 2, 1, 3).reshape(gh * n, gw * n)


def walk_steps(plan):
    """(luma, chroma) lists of bool over the scan steps: does a lane of
    the step hold a TU of the plan? Read from its numpy TU maps on the
    host, so the scan skips a step without a TU with no device-to-host
    copy."""
    C = 1 << plan.log2_ctb
    ctb_h, ctb_w = plan.Hp // C, plan.Wp // C
    cys, cxs, valid, _ = HT.skew_geometry(ctb_h, ctb_w, HT.skew_for(C))

    def steps(tu, n4):
        has = (tu > 0).reshape(ctb_h, n4, ctb_w, n4).any(axis=(1, 3))
        return (has[cys, cxs] & (valid == 1)).any(axis=1).tolist()

    return steps(plan.tu_log2_y, C // 4), steps(plan.tu_log2_c, C // 8)


def decode_frame_hevc_inter(Hp: int, Wp: int, log2_ctb: int, strong: bool,
                            deblock_on: bool, pw: int, ph: int,
                            width: int, height: int,
                            coeff_y, tu_y, mode_y, zidx_y, qp_y,
                            coeff_cb, coeff_cr, tu_c, mode_c, zidx_c,
                            cb_qp_off, cr_qp_off, beta_off, tc_off,
                            bs_ver, bs_hor,
                            sao_type, sao_offsets, sao_band, sao_eo,
                            inter4, mv, ref_slot, pred_fl,
                            tu_inter_y, tu_inter_c,
                            wp_w, luma_log2wd: int, chroma_log2wd: int,
                            refs_y, refs_cb, refs_cr, *, has_tu=None,
                            walk_fn=walk):
    """Inter (P/B) HEVC decode of one picture: phase-plane MC + inter
    residuals seed the intra wavefront; deblock bS comes precomputed from
    the host (full 8.7.2.4 derivation incl. motion comparisons).

    The arguments up to sao_eo are decode_frames_hevc_batch's for a batch
    of one (stack_plans([plan])); then the plan's inter tensors, without a
    frame axis, its weighted-prediction denominators, and the references'
    phase pyramids stacked in slot order (refs_y [R, 16, ...], refs_cb and
    refs_cr [R, 8, ...], from prep_hevc_ref). has_tu: walk_steps(plan), or
    None to walk every step (the torch scan's; the kernel's route reads
    no has_tu). Returns (Y, U, V) uint8 [height, width] (half
    size for chroma) on the tensors' device."""
    inter4, mv, ref_slot, pred_fl, wp_w = (
        a.to(_I32) for a in (inter4, mv, ref_slot, pred_fl, wp_w))
    residuals = (HR.resid_planes if scan_kernel(coeff_y.device, walk_fn)
                 else HR.planes_reference)

    # ---- motion compensation (whole frame, both lists) ----
    def predict(mc, refs, c, log2wd):
        p0 = mc(refs, mv[0], ref_slot[0])
        p1 = mc(refs, mv[1], ref_slot[1])
        return _cells_to_plane_j(_combine_pred(
            p0, p1, pred_fl[0], pred_fl[1], wp_w[0, ..., 2 * c],
            wp_w[0, ..., 2 * c + 1], wp_w[1, ..., 2 * c],
            wp_w[1, ..., 2 * c + 1], log2wd + 6))

    pred_y = predict(_mc_hevc_luma, refs_y, 0, luma_log2wd)
    pred_cb = predict(_mc_hevc_chroma, refs_cb, 1, chroma_log2wd)
    pred_cr = predict(_mc_hevc_chroma, refs_cr, 2, chroma_log2wd)

    # ---- inter residuals (the DCT at every size, also 4x4 luma), int16:
    # clip(pred + r, 0, 255) is the same for r and its saturation ----
    resid_y = residuals((coeff_y,), tu_inter_y[None], qp_y,
                        sizes=HR.LUMA_SIZES)
    # 4:2:0 chroma TUs are at most 16 (half the 32 luma max, 7.4.9.8)
    resid_cb, resid_cr = residuals(
        (coeff_cb, coeff_cr), tu_inter_c[None], qp_y, sizes=HR.CHROMA_SIZES,
        offsets=(cb_qp_off, cr_qp_off)).split(1)

    # ---- inter base = clip(MC + residual), masked to inter cells ----
    up4 = lambda m: m.repeat_interleave(4, 0).repeat_interleave(4, 1)
    px_inter = up4(inter4) != 0
    cx_inter = up4(inter4[::2, ::2])[:Hp // 2, :Wp // 2] != 0
    base = (torch.where(px_inter, (pred_y + resid_y).clamp(0, 255), 0),
            torch.where(cx_inter, (pred_cb + resid_cb).clamp(0, 255), 0),
            torch.where(cx_inter, (pred_cr + resid_cr).clamp(0, 255), 0))

    # inter cells carry their CU's z-scan index (plan.record_inter_cu_done)
    # so the zidx availability compare matches 6.4.1 exactly
    Y, U, V = decode_frames_hevc_batch(
        Hp, Wp, log2_ctb, strong, deblock_on, pw, ph, width, height,
        coeff_y, tu_y, mode_y, zidx_y, qp_y, coeff_cb, coeff_cr, tu_c,
        mode_c, zidx_c, cb_qp_off, cr_qp_off, beta_off, tc_off, bs_ver,
        bs_hor, sao_type, sao_offsets, sao_band, sao_eo, walk_fn=walk_fn,
        base=base, has_tu=has_tu)
    return Y[0], U[0], V[0]


def decode_plan_inter(plan, refs, device=None, coded: bool = False, *,
                      walk_fn=walk):
    """Inter HevcFramePlan + its references' phase pyramids, [(luma_ph,
    cb_ph, cr_ph), ...] of prep_hevc_ref in plan.ref_pocs order, on
    `device` (None: the card) -> (Y, U, V) uint8 there (coded size when
    coded=True). A picture without references (an I picture, zeroed
    motion) passes [] and is predicted from a zero reference. walk_fn as
    in decode_frames_hevc_batch; the torch scan skips the steps without a
    TU (walk_steps, read from the plan on the host)."""
    _check_plans([plan])
    args = stack_plans([plan], device)
    dev = args[9].device
    up = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(dev)
    inter = (up(plan.inter4, np.int8), up(plan.mv, np.int16),
             up(plan.ref_slot, np.int8), up(plan.pred_fl, np.int8),
             up(plan.tu_log2_inter_y, np.int8),
             up(plan.tu_log2_inter_c, np.int8), up(plan.wp_w, np.int16))
    if not refs:
        ph2, pw2 = plan.ph + 2 * MC_PAD_HEVC, plan.pw + 2 * MC_PAD_HEVC
        z = lambda *s: torch.zeros(s, dtype=torch.int16, device=dev)
        refs = [(z(16, ph2, pw2), z(8, ph2 // 2, pw2 // 2),
                 z(8, ph2 // 2, pw2 // 2))]
    stacks = [torch.stack([r[i] for r in refs]) for i in range(3)]
    h, w = (plan.ph, plan.pw) if coded else (plan.height, plan.width)
    return decode_frame_hevc_inter(
        *args[:7], w, h, *args[9:], *inter, int(plan.luma_log2wd),
        int(plan.chroma_log2wd), *stacks,
        has_tu=None if scan_kernel(dev, walk_fn) else walk_steps(plan),
        walk_fn=walk_fn)
