"""On an NVIDIA GPU: the H.264 scan kernels (kernels/h264_scan.py:
intra_tiles, csrc/h264_intra.cu; deblock_tiles, csrc/h264_deblock.cu) equal
their plain torch versions (recon_tiles._intra_tile_scan /
_deblock_tile_scan) bit for bit on seeded tiles (every class, mode and
availability pattern; bS 0-4 per sub-edge, QP 0-51, offsets -12..12; a P
picture's mix with inter macroblocks and a walk that skips diagonals;
F = 1 and F = 3; one macroblock row or column; more lane chains than the
card holds warps at once), each scan in one launch; also band by band with
the lane above each band as a halo (the row-sharded route, in one launch
a band or one a diagonal); the same inputs through each kernel 50 times
give the same bits every time (a flag read too early would not); and the
committed small H.264 fixtures decode on the card to their libavcodec
digests with one intra launch per picture that holds an intra macroblock
and one deblock launch per picture. Marked `cuda`; skips without a card.
Imports no jax:

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
    assert HS.INTRA_LAUNCHES - n0 == 1
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
    assert HS.DEBLOCK_LAUNCHES - n0 == 1
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


@pytest.mark.parametrize("per_diagonal", [False, True],
                         ids=["one_launch", "per_diagonal"])
@pytest.mark.parametrize("bands", [2, 3])
def test_kernels_on_row_bands_with_the_lane_above(dev, bands, per_diagonal):
    """The kernels of the row-sharded route, one band of lanes after the
    other on one card: each band's launches, with the lane above it as the
    halo (its first lane k0 > 0), equal the whole scan's band. A band
    reads a tile of the lane above only once the band above is done with
    it, so the bands may run in turn; the deblock's filtered halo rows go
    back to the band above, as h264_scan.deblock_tiles hands them back.
    per_diagonal: a launch a diagonal (a walked one, for the intra scan)
    sharing one scratch, as the route with a group of several ranks
    launches them; else one launch a band."""
    mbh, mbw, nf = 6, 7, 2
    lanes = mbh // bands
    a = _on(dev, synth_intra_scan(mbh, mbw, nf, seed=40 + bands, inter=True))
    walk = a[14]
    want = HS.intra_tiles(*a[:11], tuple(a[11:14]), walk)
    n_steps = a[10].shape[0]

    def launches(fn, walk=None):
        """fn(d0, d1, scratch, ticket) over the whole scan: once, or once
        a (walked) diagonal with a shared scratch."""
        if not per_diagonal:
            return fn(0, n_steps, None, 0)
        scratch = HS._scratch(nf, lanes, n_steps, dev)
        for d in range(n_steps):
            if walk is None or walk[d]:
                fn(d, d + 1, scratch, d)

    for b in range(bands):
        sl = slice(b * lanes, (b + 1) * lanes)
        band = [_bands(x, sl) for x in a[:14]]
        named = dict(zip(HS.INTRA_ARGS + ("inter_y", "inter_u", "inter_v"),
                         band))
        vm = (band[10] == 1)[..., None, None]
        out = tuple(torch.where(vm, t, 0) for t in band[11:14])
        above = tuple(w[:, :, :b * lanes] for w in want)
        halo = HS._lane_tiles(above, slice(None)) if b else None
        launches(lambda d0, d1, sc, tk: HS._launch_intra(
            out, named, True, None if per_diagonal else walk, d0, d1, halo,
            b * lanes, sc, tk), walk)
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
        launches(lambda t0, t1, sc, tk: HS._launch_deblock(
            out, named, t0, t1, halo, hqp, b * lanes, sc, tk))
        if b:
            for t, h, n, r in zip(outs[-1], halo.split((256, 64, 64), -1),
                                  (16, 8, 8), (12, 6, 6)):
                t[:, :, -1, r:] = h.unflatten(-1, (n, n))[..., r:, :]
        outs.append(out)
    torch.cuda.synchronize()
    for k, w in enumerate(want):
        assert torch.equal(torch.cat([o[k] for o in outs], 2), w)


def _both_scans(dev, mbh, mbw, nf, seed, inter):
    """The intra scan (a P picture's with inter) and the deblock scan on
    seeded inputs, each in one launch (the intra scan in none where the
    walk takes no diagonal), against the torch versions."""
    a = _on(dev, synth_intra_scan(mbh, mbw, nf, seed=seed, inter=inter))
    inter_t, walk = (tuple(a[11:14]), a[14]) if inter else (None, None)
    i0, d0 = HS.INTRA_LAUNCHES, HS.DEBLOCK_LAUNCHES
    got = HS.intra_tiles(*a[:11], inter_t, walk)
    d = _on(dev, synth_deblock_scan(mbh, mbw, nf, seed=seed + 1))
    got_d = HS.deblock_tiles(*d)
    walked = walk is None or any(walk)
    assert (HS.INTRA_LAUNCHES - i0, HS.DEBLOCK_LAUNCHES - d0) == (walked, 1)
    want = RT._intra_tile_scan(*a[:11], inter_t, walk)
    want_d = RT._deblock_tile_scan(*d)
    torch.cuda.synchronize()
    for g, w in zip(got + got_d, want + want_d):
        assert torch.equal(g, w)


def test_more_lane_chains_than_the_card_holds_at_once(dev):
    """68 macroblock rows of 2 in 80 frames: 5,440 lane chains, more than
    the one-warp CTAs that fit the card at once (132 SMs x 32 on an H100),
    so CTAs take further lanes by ticket as they finish theirs; the scans
    end and equal the torch versions."""
    _both_scans(dev, 68, 2, 80, seed=60, inter=True)


@pytest.mark.parametrize("mbh,mbw", [(1, 5), (4, 1), (1, 1)])
@pytest.mark.parametrize("inter", [False, True], ids=["intra", "p"])
def test_one_row_or_one_column(dev, mbh, mbw, inter):
    _both_scans(dev, mbh, mbw, 3, seed=70 + 10 * mbh + mbw, inter=inter)


def test_a_walk_without_a_diagonal_launches_nothing(dev):
    a = _on(dev, synth_intra_scan(3, 4, 2, seed=80, inter=True))
    walk = [False] * len(a[14])
    n0 = HS.INTRA_LAUNCHES
    got = HS.intra_tiles(*a[:11], tuple(a[11:14]), walk)
    assert HS.INTRA_LAUNCHES == n0
    want = RT._intra_tile_scan(*a[:11], tuple(a[11:14]), walk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "p"])
def test_the_same_bits_in_50_runs(dev, inter):
    """A 1080p-sized scan (68 x 120 macroblocks, 2 frames) through each
    kernel 50 times: every run equals the first and the first equals the
    torch version. A tile of the lane above read before its flag said it
    was finished, or through a stale cache line, would differ in some
    run."""
    mbh, mbw, nf = 68, 120, 2
    a = _on(dev, synth_intra_scan(mbh, mbw, nf, seed=90, inter=inter))
    inter_t, walk = (tuple(a[11:14]), a[14]) if inter else (None, None)
    d = _on(dev, synth_deblock_scan(mbh, mbw, nf, seed=91))
    first = HS.intra_tiles(*a[:11], inter_t, walk)
    first_d = HS.deblock_tiles(*d)
    for g, w in zip(first + first_d,
                    RT._intra_tile_scan(*a[:11], inter_t, walk)
                    + RT._deblock_tile_scan(*d)):
        assert torch.equal(g, w)
    for run in range(49):
        got = HS.intra_tiles(*a[:11], inter_t, walk) + HS.deblock_tiles(*d)
        for g, w in zip(got, first + first_d):
            assert torch.equal(g, w), f"run {run + 2} differs"


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
    odd = torch.empty(d[0].numel() + 1, dtype=torch.int32,
                      device=dev)[1:].view(d[0].shape)
    odd.copy_(d[0])
    with pytest.raises(ValueError, match="Yt does not start on a 16-byte"):
        HS.deblock_tiles(odd, *d[1:])


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_on_the_card(dev, name):
    stream, digests = session_fixture(name)
    pics = list(parse_h264(stream))
    walked = sum(fs.mv is None or any(RT.intra_steps(fs.mb_class))
                 for fs, _ in pics)
    deblocked = sum(fs.deblock_enabled for fs, _ in pics)
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
