"""On an NVIDIA GPU: the HEVC residual kernel (kernels/hevc_resid.py:
resid_planes, csrc/hevc_resid.cu) equals its plain torch version
(planes_reference) bit for bit, one launch a call, on the seeded planes of
tools/fixtures.synth_resid_planes (every QP 0..51, levels at -32768 and
32767, all-zero blocks, random per-cell TU maps whose blocks overlap, cells
outside `sizes`): intra luma with the DST, the inter luma form, Cb + Cr
with per-frame offsets, maps of one TU size under the full set; on levels
all zero and on maps without a TU of `sizes`; on the 1080p fixture's plans
(luma and Cb + Cr, as decode_frames_hevc_scan gives them); and the decodes
of the committed small HEVC streams, all-intra and inter, launch it twice a
call of decode_frames_hevc_scan and twice more a picture for the inter
residuals, every plane its libavcodec digest. Marked `cuda`; skips
without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_hevc_resid_cuda.py -m cuda
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api import hevc_inter
from jmcodec_tpu_torch.api.hevc_inter import decode_hevc
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.tools.fixtures import (fixture_batch_stream,
                                              synth_resid_planes)

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")
LUMA, CHROMA = HR.LUMA_SIZES, HR.CHROMA_SIZES


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _on(dev, coeffs, tu, qp, offs):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (tuple(map(t, coeffs)), t(tu), t(qp),
            None if offs is None else tuple(map(t, offs)))


def _check(coeffs, tu, qp, offs, sizes, dst4):
    """The kernel against planes_reference, one launch; returns its
    planes."""
    kw = dict(sizes=sizes, dst4=dst4, offsets=offs)
    want = HR.planes_reference(coeffs, tu, qp, **kw)
    n0 = HR.LAUNCHES
    got = HR.resid_planes(coeffs, tu, qp, **kw)
    torch.cuda.synchronize()
    assert HR.LAUNCHES == n0 + 1
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("form", ["intra_luma", "inter_luma", "chroma"])
@pytest.mark.parametrize("frames,H,W", [(1, 64, 96), (3, 96, 64)])
def test_kernel_matches_planes_reference(dev, form, frames, H, W):
    chroma = form == "chroma"
    sizes = CHROMA if chroma else LUMA
    args = _on(dev, *synth_resid_planes(frames, H, W, seed=frames + H,
                                        chroma=chroma, sizes=sizes))
    qp = args[2].cpu().numpy()
    assert set(np.unique(qp)) == set(range(52))
    assert int(args[0][0].min()) == -32768 and int(args[0][0].max()) == 32767
    got = _check(*args, sizes, form == "intra_luma")
    assert got.any()


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_one_size_at_a_time(dev, log2, chroma):
    """A map whose TUs are all of one size (the cells holding 0 or a value
    outside the sizes kept), under the path's full set of sizes; 32 on a
    chroma map is outside its set and gives zeros."""
    sizes = CHROMA if chroma else LUMA
    coeffs, tu, qp, offs = synth_resid_planes(2, 64, 64, seed=log2,
                                              chroma=chroma, sizes=sizes)
    tu = np.where(np.isin(tu, sizes), log2, tu).astype(np.int8)
    got = _check(*_on(dev, coeffs, tu, qp, offs), sizes, not chroma)
    assert got.any() == (log2 in sizes)


def test_zero_levels_and_no_tu(dev):
    """Levels all zero, or a map without a TU of `sizes`: zero planes."""
    coeffs, tu, qp, offs = _on(dev, *synth_resid_planes(2, 64, 64, seed=1))
    zero = (torch.zeros_like(coeffs[0]),)
    assert not _check(zero, tu, qp, offs, LUMA, True).any()
    none = torch.where(tu >= 2, 0, tu)
    assert not _check(coeffs, none, qp, offs, LUMA, True).any()


def test_1080p_fixture_plans(dev):
    """The 1080p fixture's plans (two pictures), luma and Cb + Cr, in the
    tensors stack_plans gives the decode."""
    plans = parse_hevc_intra_plans(fixture_batch_stream(2))
    a = PT.stack_plans(plans, dev)
    coeff_y, tu_y, qp_y = a[9], a[10], a[13]
    coeff_cb, coeff_cr, tu_c, cb, cr = a[14], a[15], a[16], a[19], a[20]
    assert _check((coeff_y,), tu_y, qp_y, None, LUMA, True).any()
    assert _check((coeff_cb, coeff_cr), tu_c, qp_y, (cb, cr), CHROMA,
                  False).any()


@pytest.mark.parametrize("name", ["hevc_128x96_ctu32.h265",
                                  "hevc_ctu16_64x64.h265"])
def test_intra_decode_goes_through_the_kernel(dev, name):
    plans = parse_hevc_intra_plans(open(os.path.join(DATA, name),
                                        "rb").read())
    want = PT.decode_plans_batch(plans, "cpu")
    n0 = HR.LAUNCHES
    got = PT.decode_plans_batch(plans, dev)
    torch.cuda.synchronize()
    assert HR.LAUNCHES - n0 == 2
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", ["hevc_inter_b3_64x64", "hevc_inter_100x60",
                                  "hevc_inter_ctu32_192x128"])
def test_inter_decode_goes_through_the_kernel(monkeypatch, dev, name):
    """Each picture decoded on the card: its intra residuals (two launches)
    and its inter residuals (two more); every plane its libavcodec
    digest."""
    s = open(os.path.join(DATA, name + ".h265"), "rb").read()
    meta = json.load(open(os.path.join(DATA, name + ".sha256.json")))
    on_card = []
    call = hevc_inter.DeviceRecon.__call__

    def recording(self, plan, ref_pixels):
        on_card.append(plan.poc)
        return call(self, plan, ref_pixels)

    monkeypatch.setattr(hevc_inter.DeviceRecon, "__call__", recording)
    n0 = HR.LAUNCHES
    frames = decode_hevc(s, dev)
    torch.cuda.synchronize()
    assert on_card and HR.LAUNCHES - n0 == 4 * len(on_card)
    assert len(frames) == len(meta["frames"])
    for frame, want in zip(frames, meta["frames"]):
        for plane, a in zip("YUV", frame):
            h = hashlib.sha256(np.ascontiguousarray(a.cpu().numpy()))
            assert h.hexdigest() == want[plane]
