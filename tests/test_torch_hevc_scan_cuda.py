"""On an NVIDIA GPU: the HEVC scan kernel (kernels/hevc_scan.py:
scan_planes, csrc/hevc_scan.cu) equals its plain torch version
(scan_reference) bit for bit, one launch a scan, on seeded planes of
tools/fixtures.synth_scan_planes (synth_state_hard's kinds laid over whole
planes: all-4x4 CTBs, CTBs without a TU, residuals and bases at the int16
extremes, z-scan Z, CTBs with no neighbour available, a partial right
column) at CTU 16, 32 and 64, luma and Cb + Cr, 1 and 17 frames, with and
without an inter base; with more lanes than the card holds CTAs of the
kernel at once; the same inputs through the kernel 50 times give the same
bits every time (a flag read too early would not); on planes of all-4x4
CTBs (the widest levels of its walk by level), of 32x32 TUs on nearly flat
references (the strong filter), and of random TU maps and Z (overlapping
TUs, cells read before a later TU overwrites them); and the decodes of the committed small HEVC streams go through it, two launches a
picture and no hevc_walk launch. Marked `cuda`; skips without a card.
Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_hevc_scan_cuda.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_tables as HT
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import synth_scan_planes

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")

# plane: (plane C, max_tu, is_chroma, strong) of a luma CTB size
PLANES = {"luma": lambda ctu: (ctu, 32, False, True),
          "chroma": lambda ctu: (ctu // 2, 16, True, False)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _inputs(dev, ctu, plane, frames, ctb_h, ctb_w, inter, seed=5):
    C, max_tu, chroma, strong = PLANES[plane](ctu)
    P = frames * (2 if chroma else 1)
    arrays = synth_scan_planes(C, max_tu, P, frames, ctb_h, ctb_w,
                               seed=seed, inter=inter, partial=True)
    t = [None if a is None else torch.from_numpy(a).to(dev) for a in arrays]
    kw = dict(C=C, skew=HT.skew_for(ctu), max_tu=max_tu, is_chroma=chroma,
              strong=strong, base=t[4])
    return t[:4], kw


def _check(args, kw):
    """The kernel against scan_reference, one launch; returns its
    planes."""
    n0 = HSC.LAUNCHES
    got = HSC.scan_planes(*args, **kw)
    assert HSC.LAUNCHES == n0 + 1
    want = HSC.scan_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


def _with_maps(dev, args, kw, tu=None, zidx=None, mode=None, resid=None):
    """args with some of its arrays replaced by numpy ones."""
    out = list(args)
    for i, a in ((0, resid), (1, zidx), (2, tu), (3, mode)):
        if a is not None:
            out[i] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out, kw


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
@pytest.mark.parametrize("frames", [1, 17])
@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("ctu", [16, 32, 64])
def test_kernel_matches_the_torch_scan(dev, ctu, plane, frames, inter):
    # a few CTB rows and columns; a row wider than the skew's reach
    ctb_h, ctb_w = (3, 4) if frames == 1 else (2, 3)
    _check(*_inputs(dev, ctu, plane, frames, ctb_h, ctb_w, inter))


@pytest.mark.parametrize("ctu,plane,inter", [(16, "chroma", False),
                                             (64, "luma", True)])
def test_more_lanes_than_resident_ctas(dev, ctu, plane, inter):
    """The lanes beyond the CTAs that fit wait for a CTA to finish a lane:
    planes of three CTB rows, enough of them to outnumber the CTAs (a
    chroma lane holds the CTB row of a frame's Cb and Cr planes)."""
    C, max_tu, chroma, _ = PLANES[plane](ctu)
    geo = dict(C=C, skew=HT.skew_for(ctu), max_tu=max_tu, base=inter,
               planes_per_map=2 if chroma else 1)
    n = HSC.resident_ctas(**geo)[0]
    frames = n // 3 + 1
    args, kw = _inputs(dev, ctu, plane, frames, 3, 2, inter)
    assert HSC.lanes(args[0].shape[0], args[1].shape[0], 3) > n
    _check(args, kw)


def test_repeated_launches_agree(dev):
    args, kw = _inputs(dev, 64, "luma", 4, 6, 8, inter=False, seed=9)
    first = _check(args, kw)
    for _ in range(50):
        assert torch.equal(HSC.scan_planes(*args, **kw), first)
    args, kw = _inputs(dev, 32, "chroma", 4, 6, 8, inter=True, seed=9)
    first = _check(args, kw)
    for _ in range(50):
        assert torch.equal(HSC.scan_planes(*args, **kw), first)


@pytest.mark.parametrize("name", ["hevc_128x96_ctu32.h265",
                                  "hevc_168x80.h265", "hevc_ctu16_64x64.h265"])
def test_decode_goes_through_the_kernel(dev, name):
    plans = parse_hevc_intra_plans(open(os.path.join(DATA, name),
                                        "rb").read())
    want = PT.decode_plans_batch(plans, "cpu")
    n0, w0 = HSC.LAUNCHES, HW.LAUNCHES
    got = PT.decode_plans_batch(plans, dev)
    torch.cuda.synchronize()
    assert (HSC.LAUNCHES - n0, HW.LAUNCHES - w0) == (2, 0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("ctu,plane", [(64, "luma"), (32, "chroma"),
                                       (16, "luma")])
def test_all_4x4_ctbs(dev, ctu, plane):
    """Every cell a 4x4 TU: a 64x64 CTB's 256 TUs on 90 levels of up to 6
    TUs, three warps' pairs at once."""
    args, kw = _inputs(dev, ctu, plane, 2, 3, 4, False, seed=13)
    tu = np.full(tuple(args[2].shape), 2, np.int32)
    _check(*_with_maps(dev, args, kw, tu=tu))


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
def test_32x32_tus_with_the_strong_filter(dev, inter):
    """Luma 32x32 TUs on nearly flat references (a residual of -1..1), so
    that the bilinear (strong) filter's flatness test holds for most of
    them, in every mode."""
    args, kw = _inputs(dev, 64, "luma", 2, 3, 4, inter, seed=17)
    rng = np.random.default_rng(17)
    shape = tuple(args[2].shape)
    tu = np.zeros(shape, np.int32)
    tu[:, ::8, ::8] = 5
    resid = rng.integers(-1, 2, tuple(args[0].shape)).astype(np.int16)
    mode = rng.integers(0, 35, shape).astype(np.int32)
    assert kw["strong"]
    _check(*_with_maps(dev, args, kw, tu=tu, resid=resid, mode=mode))


@pytest.mark.parametrize("ctu,plane", [(64, "luma"), (32, "luma"),
                                       (64, "chroma")])
def test_random_maps_overlapping_tus(dev, ctu, plane):
    """Every cell any TU size (TUs overlap) and a random Z (a TU may read a
    cell that a later TU overwrites): the levels' order must still give
    the z-order walk's samples."""
    args, kw = _inputs(dev, ctu, plane, 2, 3, 4, False, seed=19)
    rng = np.random.default_rng(19)
    shape = tuple(args[2].shape)
    T = min(kw["C"], kw["max_tu"])
    tu = rng.choice(np.array([0, *range(2, T.bit_length())], np.int32),
                    shape).astype(np.int32)
    zidx = rng.integers(0, 1 << 12, shape).astype(np.int32)
    _check(*_with_maps(dev, args, kw, tu=tu, zidx=zidx))


def test_repeated_launches_of_many_lanes(dev):
    """50 launches of 1080p's lanes at CTU 64 (17 CTB rows of 16 planes,
    272 lanes, each waiting on the lane above) give the same bits."""
    args, kw = _inputs(dev, 64, "luma", 16, 17, 6, False, seed=23)
    want = HSC.scan_reference(*args, **kw)
    for _ in range(50):
        got = HSC.scan_planes(*args, **kw)
        assert torch.equal(got, want)
