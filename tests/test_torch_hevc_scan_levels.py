"""The hevc_scan kernel's order of TUs on the CPU (kernels/hevc_levels.py):
the torch scan with each CTB's TUs walked by dependency level, each
level's TUs in reverse z-order (walk_levels), equals jmcodec_tpu's scan
(hevc_tiles._intra_scan with its Pallas walk in interpret mode, between
the skew and the unskew, as tests/test_torch_hevc_scan.py runs it) bit for
bit on that file's seeded planes at CTU 16 and 32, luma and Cb + Cr, with
and without an inter base, and on planes of random TU maps and random Z,
whose TUs overlap and read cells that later TUs overwrite; a walk by level
equals walk_reference on synth_state_hard's states; a CTB of 4x4 TUs has
the expected wavefront of levels; tools/hevc_scan_chain.py counts a
committed stream's chains. No card needed."""

import os

import numpy as np
import pytest
import torch

from test_torch_hevc_scan import CASES, _inputs, _jax_scan

from jmcodec_tpu_torch.kernels import hevc_levels as HL
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools import hevc_scan_chain
from jmcodec_tpu_torch.tools.fixtures import synth_state_hard

DATA = os.path.join(os.path.dirname(__file__), "data")


def _random_maps(name, seed=3):
    """CASES[name]'s planes with a random TU map (every cell any size, so
    TUs overlap) and a random Z (any cell may be available to any TU)."""
    (resid, zidx, tu, mode, base), kw = _inputs(name, False)
    rng = np.random.default_rng(seed)
    T = min(kw["C"], kw["max_tu"])
    tu = rng.choice(np.array([0, *range(2, T.bit_length())], np.int32),
                    tu.shape).astype(np.int32)
    zidx = rng.integers(0, 1 << 12, zidx.shape).astype(np.int32)
    return (resid, zidx, tu, mode, base), kw


def _hazards(tu, zidx, C, max_tu):
    """(write-after-write, write-after-read) pairs of TUs in one CTB, over
    the CTBs of the maps: an earlier TU whose block a later one overlaps,
    and an earlier TU that reads a cell a later one writes."""
    C4 = C // 4
    log2T = min(C, max_tu).bit_length() - 1
    waw = war = 0
    for g in range(tu.shape[0]):
        for cy in range(tu.shape[1] // C4):
            for cx in range(tu.shape[2] // C4):
                sl = (g, slice(cy * C4, (cy + 1) * C4),
                      slice(cx * C4, (cx + 1) * C4))
                Z = np.zeros((1 + C4, 1 + C4), np.int64)
                Z[1:, 1:] = zidx[sl]
                tus = HL.ctb_tus(tu[sl], log2T)
                cells = []
                for v, x4, y4 in tus:
                    n4 = 1 << (v - 2)
                    own = {(x4 + i, y4 + j) for i in range(n4)
                           for j in range(n4)}
                    z = Z[1 + y4, 1 + x4]
                    reads = set(HL.ref_cells(
                        v, x4, y4, lambda x, y: Z[1 + y, 1 + x] < z, C4))
                    for o_own, o_reads in cells:
                        waw += bool(own & o_own)
                        war += bool(own & o_reads)
                    cells.append((own, reads))
    return waw, war


def _scan(arrays, kw, walk_fn):
    resid, zidx, tu, mode, base = arrays
    t = lambda a: None if a is None else torch.from_numpy(a)
    return PT.scan_torch(t(resid), t(zidx), t(tu), t(mode),
                         base=t(base), walk_fn=walk_fn, **kw).numpy()


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
@pytest.mark.parametrize("name", list(CASES))
def test_walk_by_level_matches_jax(name, inter):
    arrays, kw = _inputs(name, inter)
    got = _scan(arrays, kw, HL.walk_levels)
    assert np.array_equal(got, _jax_scan(*arrays, **kw))


@pytest.mark.parametrize("name", ["luma_ctu16", "luma_ctu32",
                                  "chroma_ctu32_2f"])
def test_walk_by_level_with_overlaps_matches_jax(name):
    arrays, kw = _random_maps(name)
    waw, war = _hazards(arrays[2], arrays[1], kw["C"], kw["max_tu"])
    assert waw > 0 and war > 0
    got = _scan(arrays, kw, HL.walk_levels)
    assert np.array_equal(got, _jax_scan(*arrays, **kw))


def test_levels_without_the_write_after_read_rule_differ():
    """The rule's read levels (rl) are needed: without them a TU that
    overwrites a cell an earlier TU reads may come first."""
    arrays, kw = _random_maps("luma_ctu16")
    saved = HL.tu_levels

    def no_war(tus, Z, C4):
        wl = np.zeros((C4, C4), np.int64)
        out = []
        for v, x4, y4 in tus:
            n4 = 1 << (v - 2)
            z = Z[1 + y4, 1 + x4]
            reads = HL.ref_cells(v, x4, y4,
                                 lambda x, y: Z[1 + y, 1 + x] < z, C4)
            own = (slice(y4, y4 + n4), slice(x4, x4 + n4))
            lvl = 1 + max([int(wl[y, x]) for x, y in reads]
                          + [int(wl[own].max())])
            wl[own] = lvl
            out.append(lvl)
        return out

    HL.tu_levels = no_war
    try:
        got = _scan(arrays, kw, HL.walk_levels)
    finally:
        HL.tu_levels = saved
    assert not np.array_equal(got, _scan(arrays, kw, HW.walk_reference))


@pytest.mark.parametrize("reverse", [True, False], ids=["reversed", "zorder"])
@pytest.mark.parametrize("C,max_tu", [(16, 32), (32, 32), (64, 32), (8, 16)])
def test_walk_by_level_matches_walk_reference(C, max_tu, reverse):
    F, Z, resid, tu, mode = (torch.from_numpy(a) for a in synth_state_hard(
        C, max_tu, 6, seed=C + max_tu))
    kw = dict(C=C, max_tu=max_tu, is_chroma=C == 8, strong=True)
    got = HL.walk_levels(F, Z, resid, tu, mode, reverse=reverse, **kw)
    assert torch.equal(got, HW.walk_reference(F, Z, resid, tu, mode, **kw))


def test_all_4x4_levels_are_a_wavefront():
    """A CTB of 4x4 TUs in z-scan order: a TU follows its left, top-left
    and top neighbours, its top-right one where that comes earlier in
    z-order and its below-left one where that does."""
    assert np.array_equal(HL.all_4x4_levels(16), [[1, 2, 5, 6],
                                                  [3, 4, 7, 8],
                                                  [5, 8, 11, 12],
                                                  [9, 10, 13, 14]])
    lv = HL.all_4x4_levels(64)
    widths = np.bincount(lv.ravel())[1:]
    assert lv.max() == 90 and widths.max() == 6 and widths.sum() == 256
    # a TU comes after its left and its top neighbour
    assert (lv[:, 1:] > lv[:, :-1]).all() and (lv[1:] > lv[:-1]).all()


def test_scan_chain_tool_on_a_small_stream(capsys):
    with open(os.path.join(DATA, "hevc_128x96_ctu32.h265"), "rb") as fh:
        recs = hevc_scan_chain.stream_chains(fh.read(), frames=1)
    luma, chroma = recs
    assert (luma["zorder"], luma["levels"], luma["plane"]) == (232, 159, 88)
    assert (chroma["zorder"], chroma["levels"], chroma["plane"]) == (76, 69,
                                                                     43)
    for r in recs:
        assert r["plane"] <= r["levels"] <= r["zorder"] <= r["tus"]
    hevc_scan_chain.main([os.path.join(DATA, "hevc_128x96_ctu32.h265"),
                          "--frames", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("frame 0 luma: zorder 232, levels 159")
