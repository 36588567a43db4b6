"""The order in which the hevc_scan kernel (csrc/hevc_scan.cu) walks the
TUs of a CTB: by dependency level, with its plain versions.

The JAX package walks a CTB's TUs one after another in z-order. A TU
reads only its available reference cells (6.4.1: those whose decode-order
index in Z is below its own) and writes only its own block, so most TUs
of a CTB do not depend on each other. The kernel walks them by level, the
TUs of one level at the same time:

    level(Y) = 1 + max(wl[c] for c in R(Y) + W(Y), rl[c] for c in W(Y), 0)

over the active TUs Y of the CTB in z-order, where W(Y) are the 4x4 cells
Y writes, R(Y) the available reference cells it reads that lie inside the
CTB (its left column, corner and top row, as far as 2n samples reach),
wl[c] the level of the last TU before Y that wrote cell c and rl[c] the
highest level of a TU before Y that read it; then wl[c] = level(Y) for c
in W(Y) and rl[c] = max(rl[c], level(Y)) for c in R(Y). Cells outside the
CTB (the borders) are never written by a TU of it. So a TU comes after
every earlier TU whose block it reads (read after write) or overlaps
(write after write: the TU map lets TUs overlap), and after every earlier
TU that reads a cell it writes (write after read: with an arbitrary Z a
TU may read a cell that a later TU overwrites). The TUs of one level
write disjoint cells and read none that another TU of the level writes,
so any order within a level gives the z-order walk's samples.

ctb_tus and tu_levels are that rule in plain Python; walk_levels is
hevc_walk.walk_reference's walk in that order, each level's TUs in
reverse z-order, for the torch scan (hevc_tiles.scan_torch(...,
walk_fn=walk_levels)); tools/hevc_scan_chain.py counts the chains.
"""

from __future__ import annotations

import numpy as np

from .hevc_walk import _tu_candidate


def _even_bits(z: int) -> int:
    """The even bits of a z-order index, packed (x; y is _even_bits(z >>
    1))."""
    v = 0
    for k in range(8):
        v |= ((z >> (2 * k)) & 1) << k
    return v


def ctb_tus(tu, log2T: int):
    """The active TUs of one CTB's TU map tu [C/4, C/4] in z-order, as
    (log2 size, x4, y4) in 4x4 cells: a cell at z-index zi with map value
    v in 2..log2T marks a TU of size 1 << v when zi is a multiple of the
    TU's cell count, as the walk's candidates do."""
    C4 = tu.shape[0]
    out = []
    for zi in range(C4 * C4):
        x4, y4 = _even_bits(zi), _even_bits(zi >> 1)
        v = int(tu[y4, x4])
        if 2 <= v <= log2T and zi % (1 << (2 * (v - 2))) == 0:
            out.append((v, x4, y4))
    return out


def ref_cells(v: int, x4: int, y4: int, avail, C4: int):
    """The reference cells inside the CTB that a TU of log2 size v at cell
    (x4, y4) reads: its left column and top row as far as 2n samples reach
    and its corner, those that lie in the C4 x C4 CTB and for which
    avail(x, y) holds."""
    n2 = 2 << (v - 2)
    cand = ([(x4 - 1, y4 + i) for i in range(n2)] + [(x4 - 1, y4 - 1)]
            + [(x4 + i, y4 - 1) for i in range(n2)])
    return [(x, y) for x, y in cand
            if 0 <= x < C4 and 0 <= y < C4 and avail(x, y)]


def tu_levels(tus, Z, C4: int):
    """The level (1, 2, ...) of each TU of ctb_tus' list, by the module's
    rule. Z: the walk's z-index border of the CTB ([1 + C/4 + T/4, WZ],
    the CTB's cell (x, y) at Z[1 + y, 1 + x])."""
    wl = np.zeros((C4, C4), np.int64)
    rl = np.zeros((C4, C4), np.int64)
    levels = []
    for v, x4, y4 in tus:
        n4 = 1 << (v - 2)
        z_org = Z[1 + y4, 1 + x4]
        reads = ref_cells(v, x4, y4,
                          lambda x, y: Z[1 + y, 1 + x] < z_org, C4)
        ry = [y for _, y in reads]
        rx = [x for x, _ in reads]
        own = (slice(y4, y4 + n4), slice(x4, x4 + n4))
        lvl = 1 + max(int(wl[ry, rx].max(initial=0)), int(wl[own].max()),
                      int(rl[own].max()))
        wl[own] = lvl
        rl[ry, rx] = np.maximum(rl[ry, rx], lvl)
        levels.append(lvl)
    return levels


def walk_levels(F, Z, resid, tu, mode, *, C: int, max_tu: int,
                is_chroma: bool, strong: bool, reverse: bool = True):
    """walk_reference's walk (a walk_fn of hevc_tiles._intra_scan) with
    each lane's TUs in the kernel's order: by level, and within a level in
    reverse z-order (reverse=False: in z-order). Returns a new F."""
    F = F.clone()
    log2T = min(C, max_tu).bit_length() - 1
    Zn, tun = Z.cpu().numpy(), tu.cpu().numpy()
    for b in range(F.shape[0]):
        tus = ctb_tus(tun[b], log2T)
        lv = tu_levels(tus, Zn[b], C // 4)
        sign = -1 if reverse else 1
        order = sorted(range(len(tus)), key=lambda i: (lv[i], sign * i))
        one = lambda a: a[b:b + 1]
        for i in order:
            v, x4, y4 = tus[i]
            _tu_candidate(one(F), one(Z), one(resid), one(tu), one(mode),
                          4 * x4, 4 * y4, 1 << v, is_chroma, strong)
    return F


def level_counts(tu, zidx, C: int, max_tu: int):
    """Per CTB of a plane's maps (tu, zidx [H/4, W/4]): (active TUs, levels)
    as two [ctb_h, ctb_w] arrays, each CTB's levels from its own cells'
    Z (its borders are no dependency inside the CTB)."""
    C4 = C // 4
    log2T = min(C, max_tu).bit_length() - 1
    ctb_h, ctb_w = tu.shape[0] // C4, tu.shape[1] // C4
    n_tus = np.zeros((ctb_h, ctb_w), np.int64)
    n_lvl = np.zeros((ctb_h, ctb_w), np.int64)
    for cy in range(ctb_h):
        for cx in range(ctb_w):
            sl = (slice(cy * C4, (cy + 1) * C4),
                  slice(cx * C4, (cx + 1) * C4))
            Zb = np.zeros((1 + C4, 1 + C4), np.int64)
            Zb[1:, 1:] = zidx[sl]
            tus = ctb_tus(tu[sl], log2T)
            lv = tu_levels(tus, Zb, C4)
            n_tus[cy, cx] = len(tus)
            n_lvl[cy, cx] = max(lv, default=0)
    return n_tus, n_lvl


def ctb_chain(weight, has_tu, skew: int) -> int:
    """The longest path through the scan's CTB chain with each CTB costing
    weight[cy, cx]: CTB (cy, cx) follows (cy, cx - 1) and, when it holds a
    TU, CTB min(cx + skew - 1, ctb_w - 1) of the row above, as the kernel's
    lanes wait."""
    ctb_h, ctb_w = weight.shape
    done = np.zeros((ctb_h, ctb_w), np.int64)
    for cy in range(ctb_h):
        for cx in range(ctb_w):
            start = done[cy, cx - 1] if cx else 0
            if cy and has_tu[cy, cx]:
                start = max(start, done[cy - 1, min(cx + skew - 1,
                                                    ctb_w - 1)])
            done[cy, cx] = start + weight[cy, cx]
    return int(done.max())


def plane_levels(tu, zidx, C: int, max_tu: int) -> int:
    """The TU critical path of a whole plane (tu, zidx [H/4, W/4]): the
    module's rule over the plane's TUs in decode order (CTBs in raster
    order, each one's TUs in z-order), with reference cells in any CTB.
    Returns the highest level."""
    C4 = C // 4
    log2T = min(C, max_tu).bit_length() - 1
    H4, W4 = tu.shape
    wl = np.zeros((H4, W4), np.int64)
    rl = np.zeros((H4, W4), np.int64)
    top = 0
    for cy in range(H4 // C4):
        for cx in range(W4 // C4):
            sl = (slice(cy * C4, (cy + 1) * C4),
                  slice(cx * C4, (cx + 1) * C4))
            for v, x4, y4 in ctb_tus(tu[sl], log2T):
                X, Y, n4 = cx * C4 + x4, cy * C4 + y4, 1 << (v - 2)
                z_org = zidx[Y, X]
                n2 = 2 * n4
                cand = ([(X - 1, Y + i) for i in range(n2)]
                        + [(X - 1, Y - 1)]
                        + [(X + i, Y - 1) for i in range(n2)])
                reads = [(x, y) for x, y in cand
                         if 0 <= x < W4 and 0 <= y < H4
                         and zidx[y, x] < z_org]
                ry = [y for _, y in reads]
                rx = [x for x, _ in reads]
                own = (slice(Y, Y + n4), slice(X, X + n4))
                lvl = 1 + max(int(wl[ry, rx].max(initial=0)),
                              int(wl[own].max()), int(rl[own].max()))
                wl[own] = lvl
                rl[ry, rx] = np.maximum(rl[ry, rx], lvl)
                top = max(top, lvl)
    return top


def all_4x4_levels(C: int):
    """The levels of a CTB of C/4 x C/4 4x4 TUs in z-scan order with
    borders that no TU writes, as a [C/4, C/4] array: the widest levels a
    CTB can have."""
    C4 = C // 4
    Z = np.zeros((1 + C4, 1 + C4), np.int64)
    for zi in range(C4 * C4):
        Z[1 + _even_bits(zi >> 1), 1 + _even_bits(zi)] = zi
    tus = ctb_tus(np.full((C4, C4), 2), 2)
    out = np.zeros((C4, C4), np.int64)
    for (_, x4, y4), lvl in zip(tus, tu_levels(tus, Z, C4)):
        out[y4, x4] = lvl
    return out

