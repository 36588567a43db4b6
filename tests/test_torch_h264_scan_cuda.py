"""On an NVIDIA GPU: the H.264 scan kernels (kernels/h264_scan.py:
intra_tiles, csrc/h264_intra.cu; deblock_tiles, csrc/h264_deblock.cu) equal
their plain torch versions (recon_tiles._intra_tile_scan /
_deblock_tile_scan) bit for bit on seeded tiles (every class, mode and
availability pattern; bS 0-4 per sub-edge, QP 0-51, offsets -12..12; a P
picture's mix with inter macroblocks and a walk that skips diagonals;
F = 1 and F = 3), also band by band with the lane above each band as a
halo (the row-sharded route), and the committed small H.264 fixtures
decode on the card to their libavcodec digests with one intra launch per
walked diagonal and one deblock launch per diagonal. Marked `cuda`; skips
without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_h264_scan_cuda.py -m cuda
"""

import hashlib

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api.h264_inter import decode_h264, parse_h264
from jmcodec_tpu_torch.kernels import h264_scan as HS
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.tools.fixtures import (session_fixture,
                                              synth_deblock_scan,
                                              synth_intra_scan)

pytestmark = pytest.mark.cuda

FIXTURES = ["h264_session_idr3_96x64", "h264_inter_p_64x64",
            "h264_inter_idr2_64x64", "h264_inter_72x40",
            "h264_inter_static_64x48", "h264_inter_slices3_96x64",
            "h264_inter_veryslow_96x64", "h264_inter_cabac_wp_64x64"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _on(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            if isinstance(a, np.ndarray) else a for a in arrays]


@pytest.mark.parametrize("mbh,mbw", [(3, 5), (7, 10)])
@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("inter", [False, True], ids=["intra", "p"])
def test_intra_kernel_matches_the_torch_scan(dev, mbh, mbw, nf, inter):
    a = _on(dev, synth_intra_scan(mbh, mbw, nf, seed=10 * mbh + nf,
                                  inter=inter))
    args = a[:11]
    inter_t, walk = (tuple(a[11:14]), a[14]) if inter else (None, None)
    before = [t.clone() for t in args]
    n0 = HS.INTRA_LAUNCHES
    got = HS.intra_tiles(*args, inter_t, walk)
    n_steps = args[10].shape[0]
    assert HS.INTRA_LAUNCHES - n0 == (sum(walk) if inter else n_steps)
    want = RT._intra_tile_scan(*args, inter_t, walk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    for t, b in zip(args, before):
        assert torch.equal(t, b)


@pytest.mark.parametrize("mbh,mbw", [(3, 5), (7, 10)])
@pytest.mark.parametrize("nf", [1, 3])
def test_deblock_kernel_matches_the_torch_scan(dev, mbh, mbw, nf):
    a = _on(dev, synth_deblock_scan(mbh, mbw, nf, seed=10 * mbh + nf))
    before = [t.clone() for t in a[:3]]
    n0 = HS.DEBLOCK_LAUNCHES
    got = HS.deblock_tiles(*a)
    assert HS.DEBLOCK_LAUNCHES - n0 == a[4].shape[0]
    want = RT._deblock_tile_scan(*a)
    torch.cuda.synchronize()
    changed = 0
    for g, w, b in zip(got, want, before):
        assert torch.equal(g, w)
        changed += int((w != b).sum())
    assert changed > 500, "the filter hardly touched the tiles"
    for t, b in zip(a[:3], before):
        assert torch.equal(t, b)


def test_deblock_kernel_with_the_intra_pattern(dev):
    """The all-intra bS of one frame, broadcast over three, against the
    all-intra torch scan."""
    mbh, mbw = 6, 9
    a = _on(dev, synth_deblock_scan(mbh, mbw, 3, seed=5))
    mys, mxs, valid = _on(dev, RT._skew_geometry(mbh, mbw))
    got = HS.deblock_tiles(*a[:9], *RT.intra_bs_tiles(mxs, mys, valid))
    want = RT._deblock_tile_scan_intra(*a[:4], mxs, mys, valid, *a[5:9])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bands(x, sl):
    """A band of lanes of a scan argument: [n_steps, lanes] (valid) or
    [F, n_steps, lanes, ...]; anything else (the offsets) whole."""
    if not isinstance(x, torch.Tensor) or x.dim() < 2:
        return x
    return (x[:, sl] if x.dim() == 2 else x[:, :, sl]).contiguous()


@pytest.mark.parametrize("bands", [2, 3])
def test_kernels_on_row_bands_with_the_lane_above(dev, bands):
    """The kernels of the row-sharded route, one band of lanes after the
    other on one card: each band's launches, with the lane above it as the
    halo (its first lane k0 > 0), equal the whole scan's band. A band
    reads a tile of the lane above only once the band above is done with
    it, so the bands may run in turn; the deblock's filtered halo rows go
    back to the band above, as h264_scan.deblock_tiles hands them back."""
    mbh, mbw, nf = 6, 7, 2
    lanes = mbh // bands
    a = _on(dev, synth_intra_scan(mbh, mbw, nf, seed=40 + bands, inter=True))
    walk = a[14]
    want = HS.intra_tiles(*a[:11], tuple(a[11:14]), walk)
    n_steps = a[10].shape[0]
    for b in range(bands):
        sl = slice(b * lanes, (b + 1) * lanes)
        band = [_bands(x, sl) for x in a[:14]]
        named = dict(zip(HS.INTRA_ARGS + ("inter_y", "inter_u", "inter_v"),
                         band))
        vm = (band[10] == 1)[..., None, None]
        out = tuple(torch.where(vm, t, 0) for t in band[11:14])
        above = tuple(w[:, :, :b * lanes] for w in want)
        halo = HS._lane_tiles(above, slice(None)) if b else None
        HS._launch_intra(out, named, True, walk, 0, n_steps, halo,
                         b * lanes)
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert torch.equal(g, w[:, :, sl])

    d = _on(dev, synth_deblock_scan(mbh, mbw, nf, seed=50 + bands))
    want = HS.deblock_tiles(*d)
    outs = []
    for b in range(bands):
        sl = slice(b * lanes, (b + 1) * lanes)
        band = [_bands(x, sl) for x in d]
        named = dict(zip(HS.DEBLOCK_ARGS, band))
        out = tuple(t.clone() for t in band[:3])
        halo = hqp = None
        if b:
            halo = HS._lane_tiles(outs[-1], slice(None))
            hqp = d[3][:, :, b * lanes - 1].contiguous()
        HS._launch_deblock(out, named, 0, n_steps, halo, hqp, b * lanes)
        if b:
            for t, h, n, r in zip(outs[-1], halo.split((256, 64, 64), -1),
                                  (16, 8, 8), (12, 6, 6)):
                t[:, :, -1, r:] = h.unflatten(-1, (n, n))[..., r:, :]
        outs.append(out)
    torch.cuda.synchronize()
    for k, w in enumerate(want):
        assert torch.equal(torch.cat([o[k] for o in outs], 2), w)


def test_kernels_reject_misuse_on_the_card(dev):
    a = _on(dev, synth_intra_scan(2, 3, 1, seed=1))
    bad = list(a)
    bad[5] = bad[5].cpu()
    with pytest.raises(ValueError, match="i16_t on cpu"):
        HS.intra_tiles(*bad)
    bad = list(a)
    bad[0] = bad[0].to(torch.int16)
    with pytest.raises(TypeError):
        HS.intra_tiles(*bad)
    d = _on(dev, synth_deblock_scan(2, 3, 2, seed=1))
    with pytest.raises(ValueError, match="bs_h_t shape"):
        HS.deblock_tiles(*d[:10], d[10][:1].contiguous().expand(3, -1, -1,
                                                                -1, -1))
    with pytest.raises(ValueError, match="must be contiguous"):
        HS.deblock_tiles(*d[:9], d[9], d[10].transpose(-1, -2))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_on_the_card(dev, name):
    stream, digests = session_fixture(name)
    pics = list(parse_h264(stream))
    n_steps = lambda fs: fs.mb_width + 2 * (fs.mb_height - 1)
    walked = sum(n_steps(fs) if fs.mv is None
                 else sum(RT.intra_steps(fs.mb_class)) for fs, _ in pics)
    deblocked = sum(n_steps(fs) for fs, _ in pics if fs.deblock_enabled)
    i0, d0 = HS.INTRA_LAUNCHES, HS.DEBLOCK_LAUNCHES
    frames = decode_h264(stream)            # no device named: the card
    torch.cuda.synchronize()
    assert HS.INTRA_LAUNCHES - i0 == walked
    assert HS.DEBLOCK_LAUNCHES - d0 == deblocked
    assert len(frames) == len(digests)
    for f, d in zip(frames, digests):
        for k, plane in enumerate("YUV"):
            assert f[k].device.type == "cuda"
            h = hashlib.sha256(np.ascontiguousarray(f[k].cpu().numpy()))
            assert h.hexdigest() == d[plane]
