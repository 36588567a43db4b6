"""On an NVIDIA GPU: the HEVC residual kernel (kernels/hevc_resid.py:
resid_planes, csrc/hevc_resid.cu) equals its plain torch version
(planes_reference) bit for bit, one launch a call, on the seeded planes of
tools/fixtures.synth_resid_planes (every QP 0..51, levels at -32768 and
32767, all-zero blocks, random per-cell TU maps whose blocks overlap, cells
outside `sizes`): intra luma with the DST, the inter luma form, Cb + Cr
with per-frame offsets, maps of one TU size under the full set; on
columns whose one level is in their block's first or last row, on blocks
of every size nested in one area, and on chroma planes whose sides are
multiples of 16 but not of 32; on levels
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


@pytest.mark.parametrize("row", ["first", "last"])
@pytest.mark.parametrize("form,log2", [
    (form, v) for form in ("intra_luma", "inter_luma", "chroma")
    for v in (CHROMA if form == "chroma" else LUMA)])
def test_one_level_a_column(dev, form, log2, row):
    """Columns whose only level is in their block's first row, or in its
    last (where a column stage that stops at its last level would go
    wrong): maps of one TU size, every column of a block a different
    level, QPs from 0 to 51."""
    chroma = form == "chroma"
    sizes = CHROMA if chroma else LUMA
    n, F, H, W = 1 << log2, 2, 64, 96
    rng = np.random.default_rng(7 * log2 + (row == "last"))
    coeffs = []
    for _ in range(2 if chroma else 1):
        c = np.zeros((F, H, W), np.int16)
        r = 0 if row == "first" else n - 1
        c[:, r::n] = rng.integers(-3000, 3001, (F, H // n, W))
        c[:, r::n][rng.random((F, H // n, W)) < 0.02] = -32768
        coeffs.append(c)
    tu = np.full((F, H // 4, W // 4), log2, np.int8)
    qp = rng.integers(0, 52, (F, (1 + chroma) * H // 4,
                              (1 + chroma) * W // 4)).astype(np.int8)
    offs = (tuple(rng.integers(-12, 13, F).astype(np.int32)
                  for _ in range(2)) if chroma else None)
    got = _check(*_on(dev, coeffs, tu, qp, offs), sizes,
                 form == "intra_luma")
    assert got.any()


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_nested_blocks_of_every_size(dev, chroma):
    """One block of each size inside the largest block of its area (the
    origins of a 32x32 (luma), 16x16, 8x8 and 4x4 block nested in every
    area), on seeded levels at the extremes and QP 51: the overlapping
    blocks' sum."""
    sizes = CHROMA if chroma else LUMA
    coeffs, _, qp, offs = synth_resid_planes(2, 64, 64, seed=9,
                                             chroma=chroma, sizes=sizes)
    tu = np.zeros((2, 16, 16), np.int8)
    for y0 in range(0, 16, 8):
        for x0 in range(0, 16, 8):
            if not chroma:
                tu[:, y0, x0] = 5
            tu[:, y0 + 4, x0 + 4] = 4
            tu[:, y0 + 6, x0 + 6], tu[:, y0 + 7, x0 + 7] = 3, 2
    if chroma:  # the 16x16 origins of every area, without a 32x32 block
        tu[:, ::8, ::8] = 4
    qp = np.full_like(qp, 51)
    got = _check(*_on(dev, coeffs, tu, qp, offs), sizes, not chroma)
    assert got.any()


@pytest.mark.parametrize("frames,H,W", [(1, 16, 16), (2, 48, 80),
                                        (3, 80, 48), (1, 112, 144)])
def test_chroma_ragged_areas(dev, frames, H, W):
    """Chroma planes whose height and width are multiples of 16 but not of
    32: the kernel's 32x32 areas of the last row and column lie half
    outside the plane."""
    args = _on(dev, *synth_resid_planes(frames, H, W, seed=H + W,
                                        chroma=True, sizes=CHROMA))
    got = _check(*args, CHROMA, False)
    assert got.any()


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
