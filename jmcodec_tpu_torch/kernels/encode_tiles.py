"""H.264 P-frame encoder core on the device: an exhaustive full-pel motion
search with half- and quarter-pel refinement for every macroblock at
once, then the final motion compensation, the 4x4 forward transform and
quantisation, a per-block rate-distortion threshold and the chroma DC
Hadamard. The port of jmcodec_tpu/kernels/encode_tiles.py; the
codec/h264/devenc.py encoder packs its symbol planes on the host and
reconstructs them through the device decode (recon_tiles).

The full-pel search scores one row of candidate offsets (dy fixed, every
dx) per step as a strided window of the padded reference; the sub-pel
steps score their eight candidates in one batched gather from the
reference's half-pel planes (recon_tiles._halfpel_planes), so the
prediction of a chosen vector is the decoder's. Ties keep the first
candidate in the reference's scan order (dy major, dx minor, then the
eight refinement offsets in order), as its strict `<` does: every pick
takes the lowest index among the minima.

Functions take int32 tensors on the caller's device and return tensors
there; qp and lambda are Python ints. All arithmetic is exact int32
(sums are taken with dtype=torch.int32).

The rate-bias tables approximate the mvd cost against a zero predictor
(the true predictor is the serial median; the bias only steers ties
toward short vectors, and the chosen MV is coded exactly downstream).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import transform as T
from ._tables import device_table as _t
from .recon_tiles import (MC_PAD, _halfpel_planes, _mc_chroma_batched,
                          _mc_luma_batched_from_planes)

_I32 = torch.int32

SEARCH_RANGE = 16  # full-pel; MC_PAD = 32 leaves margin for the sub-pel taps

# the eight refinement offsets (dx, dy) of the half- and the quarter-pel
# step, in the reference's order
_REFINE = {q: np.array([(dx * q, dy * q) for dy, dx in (
    (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, 1), (-1, 1), (1, -1))],
    np.int32) for q in (2, 1)}

# mode-decision lambda2 table: round(0.85 * 2^((qp-12)/3)) per QP
_LAMBDA2_T = np.maximum(1, np.round(
    0.85 * 2.0 ** ((np.arange(52) - 12) / 3.0))).astype(np.int32)


def _se_len(v: int) -> int:
    """Bit length of se(v) Exp-Golomb (host-side table builder)."""
    k = 2 * abs(v) - (1 if v > 0 else 0)
    return 2 * (k + 1).bit_length() - 1


@functools.lru_cache()
def _fullpel_bias(rng: int):
    """[(2R+1)^2] int32 mvd-bit counts of (4dx, 4dy) vs a zero predictor,
    in scan order (dy major, dx minor)."""
    bits = np.zeros((2 * rng + 1) * (2 * rng + 1), np.int32)
    i = 0
    for dy in range(-rng, rng + 1):
        for dx in range(-rng, rng + 1):
            bits[i] = _se_len(4 * dx) + _se_len(4 * dy)
            i += 1
    return bits


@functools.lru_cache()
def _qpel_bits_table(rng: int):
    """Bits of se(v) for quarter-pel component v in [-4(R+2), 4(R+2)]."""
    lim = 4 * (rng + 2)
    return np.array([_se_len(v) for v in range(-lim, lim + 1)],
                    np.int32), lim


def _mb_sad(diff_abs):
    """[..., H, W] absolute differences -> per-MB SAD [..., H/16, W/16]
    int32."""
    *lead, H, W = diff_abs.shape
    return diff_abs.reshape(*lead, H // 16, 16, W // 16, 16).sum(
        dim=(-3, -1), dtype=_I32)


def _cells_to_plane(cells):
    """[..., gh, gw, n, n] -> [..., gh*n, gw*n]."""
    *lead, gh, gw, n, _ = cells.shape
    return cells.transpose(-3, -2).reshape(*lead, gh * n, gw * n)


def _plane_to_cells(plane, n: int):
    """[..., H, W] -> [..., H/n, W/n, n, n]."""
    *lead, H, W = plane.shape
    return plane.reshape(*lead, H // n, n, W // n, n).transpose(-3, -2)


def _first_min(costs):
    """costs [K, ...] -> (the minimum over K, the lowest index k holding
    it), int64 indices: the winner of a sequential scan under strict <."""
    best = costs.amin(0)
    k = torch.arange(costs.shape[0], device=costs.device).reshape(
        -1, *([1] * (costs.dim() - 1)))
    idx = torch.where(costs == best, k, costs.shape[0]).amin(0)
    return best, idx


def _pick(cands, idx):
    """cands [K, ...] (any trailing axes beyond idx's), idx [...] -> the
    candidate at idx per position."""
    extra = cands.dim() - 1 - idx.dim()
    at = idx.reshape(1, *idx.shape, *([1] * extra)).expand(
        1, *cands.shape[1:])
    return cands.gather(0, at)[0]


def me_p_frame(rng: int, src_y, ref_y, lam: int):
    """Full-pel exhaustive ME + half/quarter-pel refinement, all MBs at
    once. src_y [H, W] int32 (whole macroblocks); ref_y [Hp, Wp] int32
    padded by MC_PAD. Returns (mv [H/16, W/16, 2] quarter-pel int32, sad
    [H/16, W/16] int32)."""
    return _search(rng, src_y, ref_y, _halfpel_planes(ref_y[None]), lam)


def _search(rng: int, src_y, ref_y, planes, lam: int):
    """me_p_frame with the reference's half-pel planes given."""
    if not 0 <= rng <= SEARCH_RANGE:
        # the full-pel windows read MC_PAD samples around the picture and
        # are not clamped: the range must leave the sub-pel taps in the pad
        raise ValueError(f"search range {rng} outside 0..{SEARCH_RANGE}")
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    dev = src_y.device
    n = 2 * rng + 1
    bias = _t(_fullpel_bias(rng), dev).reshape(n, n, 1, 1)
    dxs = torch.arange(-rng, rng + 1, device=dev, dtype=_I32)
    best_cost = torch.full((mbh, mbw), 1 << 30, dtype=_I32, device=dev)
    best_mv = torch.zeros((mbh, mbw, 2), dtype=_I32, device=dev)
    for j, dy in enumerate(range(-rng, rng + 1)):
        # every dx of this dy: [H, n, W] windows of the padded reference
        rows = ref_y[MC_PAD + dy:MC_PAD + dy + H,
                     MC_PAD - rng:MC_PAD + rng + W]
        diff = (rows.unfold(1, W, 1) - src_y[:, None, :]).abs()
        sad = diff.reshape(mbh, 16, n, mbw, 16).sum(dim=(1, 4), dtype=_I32)
        cost, k = _first_min(sad.permute(1, 0, 2) + lam * bias[j])
        better = cost < best_cost
        mv = torch.stack([4 * dxs[k], torch.full_like(k, 4 * dy,
                                                       dtype=_I32)], -1)
        best_mv = torch.where(better[..., None], mv, best_mv)
        best_cost = torch.where(better, cost, best_cost)

    # sub-pel refinement on the half-pel planes (the decoder's MC)
    bits_np, lim = _qpel_bits_table(rng)
    bits = _t(bits_np, dev)

    def mb_cost(cand):
        """cand [..., mbh, mbw, 2] quarter-pel -> (cost, sad)."""
        cell_mv = cand.repeat_interleave(4, -3).repeat_interleave(4, -2)
        zref = torch.zeros(cell_mv.shape[:-1], dtype=_I32, device=dev)
        pred = _cells_to_plane(
            _mc_luma_batched_from_planes(planes, cell_mv, zref))
        sad = _mb_sad((pred - src_y).abs())
        b = (bits[(cand[..., 0].clamp(-lim, lim) + lim).long()]
             + bits[(cand[..., 1].clamp(-lim, lim) + lim).long()])
        return sad + lam * b, sad

    best_cost, best_sad = mb_cost(best_mv)
    for stepq in (2, 1):
        cand = best_mv[None] + _t(_REFINE[stepq], dev)[:, None, None, :]
        cost_c, sad_c = mb_cost(cand)
        # the running best first: a candidate wins only below it
        best_cost, k = _first_min(torch.cat([best_cost[None], cost_c]))
        best_mv = _pick(torch.cat([best_mv[None], cand]), k)
        best_sad = _pick(torch.cat([best_sad[None], sad_c]), k)
    return best_mv, best_sad


def _bit_length(a):
    """floor(log2(a)) + 1 for a > 0, 0 for a == 0, of an int32 tensor of
    values below 2^24 (exact in float32): frexp's exponent. The reference
    takes floor(log2(float32(a))) + 1, which XLA's CPU log2 makes one less
    at 8192 and 32768; a 4x4 level stays below 2^11."""
    return torch.frexp(a.float())[1].to(_I32)


def encode_p_frame(rng: int, src_y, src_u, src_v, ref_y, ref_u, ref_v,
                   qp: int, qpc_cb: int, qpc_cr: int, lam: int):
    """The device P-frame encode front end (one reference, P_16x16).

    src planes int32 (whole macroblocks); ref planes int32, padded by
    pad_ref_device. Returns (mv [mbh, mbw, 2], luma_z [mbh*4, mbw*4, 4,
    4], chroma_ac [2, mbh*2, mbw*2, 4, 4] (DC position zeroed), chroma_dc
    [2, mbh, mbw, 2, 2], sad [mbh, mbw]), all int32: the symbol planes a
    decoder needs (FrameSymbols layout)."""
    dev = src_y.device
    planes = _halfpel_planes(ref_y[None])
    mv, sad = _search(rng, src_y, ref_y, planes, lam)

    # final prediction (spec-exact, shared with the decoder)
    cell_mv = mv.repeat_interleave(4, 0).repeat_interleave(4, 1)
    zref = torch.zeros(cell_mv.shape[:-1], dtype=_I32, device=dev)
    pred_y = _cells_to_plane(_mc_luma_batched_from_planes(planes, cell_mv,
                                                          zref))
    pred_u = _cells_to_plane(_mc_chroma_batched(ref_u[None], cell_mv, zref))
    pred_v = _cells_to_plane(_mc_chroma_batched(ref_v[None], cell_mv, zref))

    mf = _t(T.QUANT_MF4x4, dev)

    # luma residual -> 4x4 DCT -> quant (inter rounding)
    resid = _plane_to_cells(src_y - pred_y, 4)
    luma_z = T.quant_4x4(T.forward_transform_4x4(resid), qp, False, mf)

    # per-4x4-block rate-distortion threshold: J = SSD + lambda2 * R; a
    # block's levels are dropped when the distortion they remove is worth
    # less than the bits they cost, lambda2 = 0.85 * 2^((qp-12)/3)
    lam2 = int(_LAMBDA2_T[min(max(qp, 0), 51)])
    dq = _t(T.DEQUANT4x4, dev)
    rec_res = T.inverse_transform_4x4((luma_z * dq[qp % 6]) << (qp // 6))
    d_keep = ((resid - rec_res) ** 2).sum(dim=(-1, -2), dtype=_I32)
    d_zero = (resid ** 2).sum(dim=(-1, -2), dtype=_I32)
    absz = luma_z.abs()
    # CAVLC-flavoured rate: ~2*bitlen(level)+1 per nonzero coefficient
    # plus a coeff_token/run overhead per coded block
    coded = absz > 0
    r_blk = (torch.where(coded, 2 * _bit_length(absz) + 1, 0).sum(
        dim=(-1, -2), dtype=_I32)
        + 4 * coded.flatten(-2).any(-1).to(_I32))
    drop = (d_zero - d_keep) <= lam2 * r_blk
    luma_z = torch.where(drop[..., None, None], 0, luma_z)

    # chroma: per-plane 4x4 DCT; 2x2 DC Hadamard quant + AC quant
    chroma_ac, chroma_dc = [], []
    for srcc, predc, qpc in ((src_u, pred_u, qpc_cb), (src_v, pred_v,
                                                       qpc_cr)):
        wc = T.forward_transform_4x4(_plane_to_cells(srcc - predc, 4))
        dch = T.hadamard_2x2(_plane_to_cells(wc[..., 0, 0], 2))
        zac = T.quant_4x4(wc, qpc, False, mf)
        zac[..., 0, 0] = 0
        chroma_ac.append(zac)
        chroma_dc.append(T.quant_dc(dch, qpc))
    return mv, luma_z, torch.stack(chroma_ac), torch.stack(chroma_dc), sad
