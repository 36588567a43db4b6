"""On an NVIDIA GPU: the HEVC scan kernel (kernels/hevc_scan.py:
scan_planes, csrc/hevc_scan.cu) equals its plain torch version
(scan_reference) bit for bit, one launch a scan, on seeded planes of
tools/fixtures.synth_scan_planes (synth_state_hard's kinds laid over whole
planes: all-4x4 CTBs, CTBs without a TU, residuals and bases at the int16
extremes, z-scan Z, CTBs with no neighbour available, a partial right
column) at CTU 16, 32 and 64, luma and Cb + Cr, 1 and 17 frames, with and
without an inter base; with more lanes than the card holds CTAs of the
kernel at once; the same inputs through the kernel 50 times give the same
bits every time (a flag read too early would not); and the decodes of the
committed small HEVC streams go through it, two launches a picture and no
hevc_walk launch. Marked `cuda`; skips without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_hevc_scan_cuda.py -m cuda
"""

import os

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
    n0 = HSC.LAUNCHES
    got = HSC.scan_planes(*args, **kw)
    assert HSC.LAUNCHES == n0 + 1
    want = HSC.scan_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


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
    planes of three CTB rows, enough of them to outnumber the CTAs."""
    C, max_tu, _, _ = PLANES[plane](ctu)
    n, _ = HSC.resident_ctas(C=C, skew=HT.skew_for(ctu), max_tu=max_tu,
                             base=inter)
    frames = n // (3 if plane == "luma" else 6) + 1
    args, kw = _inputs(dev, ctu, plane, frames, 3, 2, inter)
    assert args[0].shape[0] * 3 > n
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
