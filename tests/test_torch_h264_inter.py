"""The port's H.264 P-picture decode on the CPU, at tolerance 0:

- quarter-pel luma MC (_halfpel_planes, _mc_luma_batched) and eighth-pel
  chroma MC (_mc_chroma_batched) equal jmcodec_tpu's on seeded inputs:
  every phase, MVs far past MC_PAD, intra blocks (ref_idx -1);
- _bs_planes equals jmcodec_tpu's, also with two list indices naming one
  picture (x264's weightp=2);
- the per-edge-bS deblock scan (_deblock_tile_scan) equals jmcodec_tpu's
  at a tiny geometry with random bS 0..4;
- the intra scan seeded with inter tiles equals jmcodec_tpu's, walking
  every diagonal and skipping those without an intra macroblock;
- decode_frame_inter with explicit weights and duplicate references
  equals jmcodec_tpu's, on symbols carried across with
  symbols_from_reference;
- the port's parser fills the same FrameSymbols, motion included, as
  jmcodec_tpu's;
- decode_h264(stream, "cpu") equals the committed libavcodec digests and
  jmcodec_tpu's numpy H264ReferenceDecoder; B slices, the 8x8 transform,
  MMCO and reordered streams raise NotImplementedError;
- the 1080p P fixture parses in scope and its digests are libavcodec's.

The small streams were made with tests/util_oracle.py (x264 via the
oracle; CAVLC, baseline, no 8x8 transform, bframes 0 unless said), with
moving(W, H, n, seed) the pan of make_frame(2W, 2H, seed) by (2i, 3i) px
(chroma by half) and block(frames, seed) pasting into frame i >= 1 a
16x16 make_frame(16, 16, seed=seed + i, kind="edges") whose 8x8 squares
are flipped (256 - Y) where default_rng(seed + 50 + i).integers(0, 2,
(2, 2)) is 1, at row (11 i) % (H - 15) // 2 * 2 and column
(23 i) % (W - 15) // 2 * 2 (chroma: its U, V at half), so that P
pictures hold intra macroblocks:
  h264_inter_p_64x64         block(moving(64, 64, 5, 0), 0), qp 30
  h264_inter_cabac_wp_64x64  block(moving(64, 64, 5, 1), 10), luma of
                             frame i scaled by 1 - 0.07 i plus 4 i, qp 28,
                             extra "cabac=1:ref=3:weightp=2", profile main
                             (explicit weights, duplicate references)
  h264_inter_veryslow_96x64  block(moving(96, 64, 5, 2), 20), qp 26,
                             preset veryslow, extra "ref=3"
                             (sub-partitions, three references)
  h264_inter_static_64x48    moving(64, 48, 1, 4) four times, qp 30
                             (P_Skip runs)
  h264_inter_slices3_96x64   block(moving(96, 64, 4, 5), 30), qp 28,
                             extra "slices=3"
  h264_inter_idr2_64x64      block(moving(64, 64, 6, 6), 40), qp 30, gop 3
                             (two GOPs: the DPB is reset)
  h264_inter_72x40           block(moving(72, 40, 4, 7), 60), qp 30
                             (cropped to a size not a multiple of 16)
all with gop 20 unless said. Each has a .sha256.json of its libavcodec
decode. The 1080p fixture's recipe is in
jmcodec_tpu_torch/tools/fixtures.h264_inter_fixture_stream.
"""

import functools
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.codec.h264.fastdec import FastH264Parser as JaxParser
from jmcodec_tpu.codec.h264.refdec import H264ReferenceDecoder
from jmcodec_tpu.kernels import recon_tiles as JRT
from jmcodec_tpu_torch.api.h264_inter import DeviceDPB, decode_h264
from jmcodec_tpu_torch.api.h264_intra import _picture_chunks
from jmcodec_tpu_torch.codec.h264.fastdec import FastH264Parser
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon_tiles as PRT
from jmcodec_tpu_torch.tools.fixtures import (H264_INTER_DIGESTS,
                                              fixture_digests,
                                              h264_inter_fixture_stream,
                                              symbols_from_reference)

from util_oracle import have_oracle, make_frame, oracle_decode, oracle_encode

DATA = os.path.join(os.path.dirname(__file__), "data")
# name -> pictures
STREAMS = {"h264_inter_p_64x64": 5, "h264_inter_cabac_wp_64x64": 5,
           "h264_inter_veryslow_96x64": 5, "h264_inter_static_64x48": 4,
           "h264_inter_slices3_96x64": 4, "h264_inter_idr2_64x64": 6,
           "h264_inter_72x40": 4}
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
I32 = lambda a: np.asarray(a).astype(np.int32)


def _stream(name):
    return open(os.path.join(DATA, name + ".h264"), "rb").read()


def _digests(name):
    with open(os.path.join(DATA, name + ".sha256.json")) as f:
        return json.load(f)["frames"]


# ---------------------------------------------------------------------------
# motion compensation and bS against jmcodec_tpu
# ---------------------------------------------------------------------------


def _padded_refs(rng, R, mbh, mbw):
    """R seeded reference pictures padded as jmcodec_tpu pads them."""
    planes = [[rng.integers(0, 256, (mbh * s, mbw * s)).astype(np.uint8)
               for s in (16, 8, 8)] for _ in range(R)]
    for p in planes:                        # one flat region per picture
        p[0][:8, :24] = rng.integers(0, 256)
    return [np.stack([np.asarray(JRT.prep_ref_planes(*p)[k]) for p in planes])
            for k in range(3)]


def _motion(rng, mbh, mbw, R, reach):
    """Per-4x4-block MVs (quarter-pel) over +-reach, every (x, y) eighth
    phase among the blocks, a quarter of the blocks far past MC_PAD in
    either direction; ref_idx over -1..R-1."""
    gh, gw = mbh * 4, mbw * 4
    mv = rng.integers(-reach, reach + 1, (gh, gw, 2)).astype(np.int32)
    k = np.arange(gh * gw).reshape(gh, gw)
    mv[..., 0] = (mv[..., 0] & ~7) | (k & 7)
    mv[..., 1] = (mv[..., 1] & ~7) | ((k >> 3) & 7)
    far = rng.random((gh, gw)) < 0.25
    mv[far] += (rng.choice([-1, 1], (int(far.sum()), 2))
                * (8 * 4 * PRT.MC_PAD)).astype(np.int32)
    ref = rng.integers(-1, R, (gh, gw)).astype(np.int32)
    return mv, ref


@pytest.mark.parametrize("mbh,mbw", [(3, 4), (2, 5)])
def test_mc_matches_jax(mbh, mbw):
    rng = np.random.default_rng(mbh * 10 + mbw)
    R = 3
    ref_y, ref_u, ref_v = _padded_refs(rng, R, mbh, mbw)
    mv, ref = _motion(rng, mbh, mbw, R, 96)
    assert len({(x & 7, y & 7) for x, y in mv.reshape(-1, 2)}) == 64
    assert (np.abs(mv) > 4 * PRT.MC_PAD * 4).any() and (ref == -1).any()

    for g, w in zip(PRT._halfpel_planes(T(ref_y)),
                    JRT._halfpel_planes(jnp.asarray(ref_y))):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(PRT._MC_SEL, JRT._MC_SEL)
    got = PRT._mc_luma_batched(T(ref_y), T(mv), T(ref))
    want = JRT._mc_luma_batched(jnp.asarray(ref_y), jnp.asarray(mv),
                                jnp.asarray(ref), mbh, mbw)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (mbh * 4, mbw * 4, 4, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for refc in (ref_u, ref_v):
        got = PRT._mc_chroma_batched(T(refc), T(mv), T(ref))
        want = JRT._mc_chroma_batched(jnp.asarray(refc), jnp.asarray(mv),
                                      jnp.asarray(ref), mbh, mbw)
        assert got.dtype == torch.int32
        assert tuple(got.shape) == (mbh * 4, mbw * 4, 2, 2)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_pad_ref_device_matches_prep_ref_planes():
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((48, 64), (24, 32), (24, 32))]
    got = PRT.pad_ref_device(*map(T, planes))
    for g, a, b in zip(got, JRT.prep_ref_planes(*planes),
                       JRT.pad_ref_device(*map(jnp.asarray, planes))):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(a))
        assert np.array_equal(g.numpy(), np.asarray(b))


@pytest.mark.parametrize("ids", ["indices", "duplicates"])
def test_bs_planes_match_jax(ids):
    """Random classes, levels, motion and references; with duplicates,
    indices 0 and 2 name one picture, so an edge between them takes bS 0
    where its motion agrees."""
    rng = np.random.default_rng(5)
    mbh, mbw = 4, 5
    mb_class = rng.choice([0, 1, 3, 3, 3], (mbh, mbw)).astype(np.int32)
    nz = (rng.random((mbh * 4, mbw * 4)) < 0.2).astype(np.int32)
    mv = rng.integers(-6, 7, (mbh * 4, mbw * 4, 2)).astype(np.int32)
    mv[rng.random(mv.shape[:2]) < 0.5] = 0
    ref = rng.integers(-1, 4, (mbh * 4, mbw * 4)).astype(np.int32)
    ref_ids = None if ids == "indices" else np.array([7, 3, 7, 2], np.int32)
    got = PRT._bs_planes(T(mb_class), T(nz), T(mv), T(ref),
                         None if ref_ids is None else T(ref_ids))
    want = JRT._bs_planes(jnp.asarray(mb_class), jnp.asarray(nz),
                          jnp.asarray(mv), jnp.asarray(ref),
                          None if ref_ids is None else jnp.asarray(ref_ids))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert set(np.unique(got[0].numpy())) == {0, 1, 2, 3, 4}
    if ref_ids is not None:
        plain = PRT._bs_planes(T(mb_class), T(nz), T(mv), T(ref))
        assert not torch.equal(plain[0], got[0])


# ---------------------------------------------------------------------------
# the two scans and the picture decode against jmcodec_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mbh,mbw", [(3, 4), (2, 6)])
def test_deblock_scan_matches_jax(mbh, mbw):
    """Random bS 0..4 on every 4-sample edge (0 on the picture boundary,
    as _bs_planes gives it), low-contrast tiles so that most edges pass
    the alpha/beta tests, two sets of filter and chroma qp offsets."""
    rng = np.random.default_rng(60 + mbh)
    mys, mxs, valid = PRT._skew_geometry(mbh, mbw)
    n_steps = mys.shape[0]
    vm = valid[..., None, None]
    base = rng.integers(60, 180, (n_steps, mbh, 1, 1))
    Y = I32((base + rng.integers(-6, 7, (n_steps, mbh, 16, 16))) * vm)
    U = I32((base + rng.integers(-4, 5, (n_steps, mbh, 8, 8))) * vm)
    V = I32((base + rng.integers(-9, 10, (n_steps, mbh, 8, 8))) * vm)
    qp = I32(rng.integers(20, 52, (n_steps, mbh)) * valid)
    bsv = rng.integers(0, 5, (mbh, mbw, 4, 4)).astype(np.int32)
    bsh = rng.integers(0, 5, (mbh, mbw, 4, 4)).astype(np.int32)
    bsv[:, 0, 0], bsh[0, :, 0] = 0, 0
    bsv_t, bsh_t = I32(bsv[mys, mxs]), I32(bsh[mys, mxs])
    for offs in ((0, 0, 0, 0), (4, -2, -3, 6)):
        jscan = jax.jit(functools.partial(JRT._deblock_tile_scan, bmax=mbh))
        want = jscan(Y, U, V, qp, jnp.asarray(mxs), jnp.asarray(mys),
                     jnp.asarray(valid), alpha_off=np.int32(offs[0]),
                     beta_off=np.int32(offs[1]),
                     chroma_qp_off=np.int32(offs[2]),
                     second_chroma_qp_off=np.int32(offs[3]),
                     bs_v_t=bsv_t, bs_h_t=bsh_t)
        args = [T(a[None]) for a in (Y, U, V, qp)]
        o = [torch.tensor([v], dtype=torch.int32) for v in offs]
        got = PRT._deblock_tile_scan(*args, T(valid), *o, T(bsv_t[None]),
                                     T(bsh_t[None]))
        changed = 0
        for g, w, a in zip(got, want, (Y, U, V)):
            assert np.array_equal(g[0].numpy(), np.asarray(w))
            changed += int((np.asarray(w) != a).sum())
        assert changed > 500, "the filter hardly touched the tiles"


def _scan_inputs(rng, mbh, mbw, mb_class):
    """Skewed random inputs of the intra scan ([n_steps, lanes, ...]),
    the classes from mb_class, and the inter tiles."""
    mys, mxs, valid = PRT._skew_geometry(mbh, mbw)
    n = lambda *s: rng.integers(*s)
    xs = [n(-40, 41, (mbh, mbw, 16, 16)), n(-40, 41, (mbh, mbw, 8, 8)),
          n(-40, 41, (mbh, mbw, 8, 8)), n(0, 9, (mbh, mbw, 4, 4)),
          mb_class, n(0, 4, (mbh, mbw)), n(0, 4, (mbh, mbw)),
          n(0, 2, (mbh, mbw)), n(0, 2, (mbh, mbw)), n(0, 2, (mbh, mbw))]
    inter = [n(0, 256, (mbh, mbw, 16, 16)), n(0, 256, (mbh, mbw, 8, 8)),
             n(0, 256, (mbh, mbw, 8, 8))]
    sk = lambda a: I32(np.asarray(a)[mys, mxs])
    return [sk(a) for a in xs], [sk(a) for a in inter], valid


def test_inter_seeded_intra_scan_matches_jax():
    """Classes mostly inter with intra macroblocks on a few diagonals: the
    scan walking every diagonal, and the one skipping those without an
    intra macroblock, both equal jmcodec_tpu's."""
    rng = np.random.default_rng(70)
    mbh, mbw = 3, 6
    mb_class = np.full((mbh, mbw), 3, np.int32)
    mb_class[0, 1], mb_class[1, 4], mb_class[2, 0] = 0, 1, 0
    walk = PRT.intra_steps(mb_class)
    assert 0 < sum(walk) < len(walk)
    xs, inter, valid = _scan_inputs(rng, mbh, mbw, mb_class)
    want = jax.jit(JRT._intra_tile_scan, static_argnames="bmax")(
        *xs, jnp.asarray(valid), bmax=mbh, inter_y_t=inter[0],
        inter_u_t=inter[1], inter_v_t=inter[2])
    args = [T(a[None]) for a in xs]
    it = tuple(T(a[None]) for a in inter)
    walked = PRT._intra_tile_scan(*args, T(valid), it)
    skipped = PRT._intra_tile_scan(*args, T(valid), it, walk)
    for a, b, w in zip(walked, skipped, want):
        assert np.array_equal(a[0].numpy(), np.asarray(w))
        assert torch.equal(a, b)


def _carry_refs(stream, n):
    """The port's symbols of the first n pictures, jmcodec_tpu's, and the
    numpy reference decoder's frames (whole macroblocks)."""
    theirs = JaxParser().parse_annexb(stream)[:n]
    dec = H264ReferenceDecoder()
    frames = (dec.decode_annexb(stream) + dec.flush())[:n]
    return theirs, frames


@pytest.mark.parametrize("name,pic", [("h264_inter_cabac_wp_64x64", 2),
                                      ("h264_inter_72x40", 2)])
def test_decode_frame_inter_matches_jax(name, pic):
    """One P picture from jmcodec_tpu's parse and the reference decoder's
    references: with explicit weights and a list-0 that holds one picture
    at two indices (cabac_wp), and with intra macroblocks at a cropped
    size (72x40). The port decodes jmcodec_tpu's symbols, carried across
    with symbols_from_reference, against the references its own DPB
    orders."""
    s = _stream(name)
    theirs, frames = _carry_refs(s, pic + 1)
    jfs = theirs[pic][0]
    fs = symbols_from_reference(jfs)
    assert fs.mv is not jfs.mv and np.array_equal(fs.mv, jfs.mv)
    assert fs.ref_mods_l0 == jfs.ref_mods_l0
    dpb = DeviceDPB()
    for (f, _), fr in zip(theirs[:pic], frames):
        p = symbols_from_reference(f)
        dpb.add(p, *(T(a.astype(np.uint8)) for a in (fr.Y, fr.U, fr.V)))
    refs, ids = dpb.list0(fs)
    if name.endswith("wp_64x64"):
        assert fs.wp is not None and len(set(ids)) < len(ids)
    else:
        assert (fs.mb_class != 3).any()
    jrefs = [tuple(jnp.asarray(a.numpy()) for a in r) for r in refs]
    want = JRT.decode_frame_symbols_inter(jfs, jrefs, ref_ids=ids)
    got = PRT.decode_frame_symbols_inter(fs, refs, ref_ids=ids)
    ref_fn = PRT.decode_frame_symbols_inter(
        fs, refs, ref_ids=ids, residual_fn=ID.dequant_idct_reference)
    for g, r, w, a in zip(got, ref_fn, want, (frames[pic].Y, frames[pic].U,
                                              frames[pic].V)):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, r)
        assert np.array_equal(g.numpy(), a)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

ARRAYS = ("mb_class", "qp", "i4_modes", "i16_mode", "chroma_mode",
          "luma_coeffs", "luma_dc", "chroma_coeffs", "chroma_dc",
          "avail_left", "avail_top", "avail_topright", "mv", "ref", "wp")
SCALARS = ("frame_num", "is_idr", "nal_ref_idc", "max_num_ref_frames",
           "log2_max_frame_num", "deblock_enabled", "alpha_off", "beta_off",
           "chroma_qp_off", "second_chroma_qp_off", "no_reorder",
           "ref_mods_l0", "num_ref_l0", "wp_logwd", "has_pcm")


@pytest.mark.parametrize("name", list(STREAMS))
def test_parser_fills_the_same_symbols(name):
    s = _stream(name)
    ours = FastH264Parser().parse_annexb(s)
    theirs = JaxParser().parse_annexb(s)
    assert len(ours) == len(theirs) == STREAMS[name]
    for (a, _), (b, _) in zip(ours, theirs):
        for f in ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            assert x is None or np.array_equal(x, y), f
        for f in SCALARS:
            assert getattr(a, f) == getattr(b, f), f
    assert sum(fs.mv is not None for fs, _ in ours) >= 3


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_digests_and_reference_decoder(name):
    s = _stream(name)
    frames = decode_h264(s, "cpu")
    digests = _digests(name)
    dec = H264ReferenceDecoder()
    ref = dec.decode_annexb(s) + dec.flush()
    sps = list(dec.sps.values())[0]
    assert len(frames) == len(digests) == len(ref) == STREAMS[name]
    for i, (frame, want, r) in enumerate(zip(frames, digests, ref)):
        for plane, a, b in zip("YUV", frame, r.crop(sps)):
            assert a.dtype == torch.uint8 and a.device.type == "cpu"
            h = hashlib.sha256(np.ascontiguousarray(a.numpy())).hexdigest()
            assert h == want[plane], f"frame {i} {plane}"
            assert np.array_equal(a.numpy(), b), f"frame {i} {plane}"


def test_crop_and_dpb_reset():
    """72x40 comes back at the SPS size; the second GOP of idr2 restarts
    the DPB (its first P picture has one reference)."""
    frames = decode_h264(_stream("h264_inter_72x40"), "cpu")
    assert tuple(frames[0][0].shape) == (40, 72)
    assert tuple(frames[0][1].shape) == (20, 36)
    pics = FastH264Parser().parse_annexb(_stream("h264_inter_idr2_64x64"))
    dpb = DeviceDPB()
    z = torch.zeros((64, 64), dtype=torch.uint8)
    zc = torch.zeros((32, 32), dtype=torch.uint8)
    sizes = []
    for fs, _ in pics:
        if fs.mv is not None:
            sizes.append(len(dpb.list0(fs)[0]))
        dpb.add(fs, z, zc, zc)
    assert [fs.is_idr for fs, _ in pics] == [True, False, False] * 2
    assert sizes == [1, 2, 1, 2]


def test_intra_steps_skip_on_a_p_picture():
    pics = FastH264Parser().parse_annexb(_stream("h264_inter_72x40"))
    fs = pics[2][0]
    walk = PRT.intra_steps(fs.mb_class)
    assert len(walk) == fs.mb_width + 2 * (fs.mb_height - 1)
    assert 0 < sum(walk) < len(walk)
    assert PRT.intra_steps(pics[0][0].mb_class) == [True] * len(walk)


def test_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_h264(_stream("h264_inter_p_64x64"))


def _moving(W, H, n):
    Y, U, V = make_frame(2 * W, 2 * H, seed=1)
    return [(Y[2 * i:2 * i + H, 3 * i:3 * i + W],
             U[i:i + H // 2, 3 * i // 2:3 * i // 2 + W // 2],
             V[i:i + H // 2, 3 * i // 2:3 * i // 2 + W // 2])
            for i in range(n)]


def _chunk_parser(stream):
    """A port parser that has read the stream's parameter sets, and the
    stream's picture chunks."""
    head, chunks = _picture_chunks(stream)
    parser = FastH264Parser()
    parser.parse_annexb(head)
    return parser, chunks


@pytest.mark.parametrize("what", ["b_slices", "t8_cavlc", "t8_cabac",
                                  "mmco"])
def test_out_of_scope_pictures_raise(what):
    """B slices, the 8x8 transform (CAVLC and CABAC) and MMCO raise
    NotImplementedError naming the reason, from the parser and from
    decode_h264."""
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    extra, profile, match = {
        "b_slices": ("bframes=2", "main", "B slices"),
        "t8_cavlc": ("8x8dct=1", "high", "8x8 transform"),
        "t8_cabac": ("8x8dct=1:cabac=1", "high", "8x8 transform"),
        "mmco": ("bframes=3:b-pyramid=strict", "main", "MMCO")}[what]
    s = oracle_encode(_moving(64, 48, 9), 64, 48, qp=26, gop=9, extra=extra,
                      profile=profile)
    with pytest.raises(NotImplementedError):
        decode_h264(s, "cpu")
    parser, chunks = _chunk_parser(s)
    raised = []
    for c in chunks:
        try:
            parser.parse_annexb(c)
        except NotImplementedError as e:
            raised.append(str(e))
    assert any(match in m for m in raised), raised
    assert all(any(r in m for r in ("B slices", "MMCO", "8x8 transform"))
               for m in raised), raised


def test_reordered_stream_raises_at_its_first_picture():
    """x264 writes POC type 0 once B frames are on: decode order is then
    not known to be output order, and decode_h264 refuses the stream at
    its IDR picture, before any B slice."""
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    s = oracle_encode(_moving(64, 48, 4), 64, 48, qp=30, gop=4,
                      extra="bframes=1", profile="main")
    parser, chunks = _chunk_parser(s)
    fs, sps = parser.parse_annexb(chunks[0])[0]
    assert fs.is_idr and sps.pic_order_cnt_type == 0 and not fs.no_reorder
    with pytest.raises(NotImplementedError, match="output order"):
        decode_h264(s, "cpu")


# ---------------------------------------------------------------------------
# the 1080p fixture (the card's input; decoded there by the GPU tests)
# ---------------------------------------------------------------------------


def test_1080p_fixture_parses_in_scope():
    """IDR then four P pictures, CABAC with explicit weights and duplicate
    references, intra macroblocks in every P picture on a minority of the
    diagonals."""
    pics = FastH264Parser().parse_annexb(h264_inter_fixture_stream())
    assert len(pics) == 5 == len(fixture_digests(H264_INTER_DIGESTS))
    assert [fs.mv is None for fs, _ in pics] == [True] + [False] * 4
    assert [fs.num_ref_l0 for fs, _ in pics[1:]] == [1, 3, 4, 4]
    dpb = DeviceDPB()
    z = torch.zeros((1088, 1920), dtype=torch.uint8)
    zc = torch.zeros((544, 960), dtype=torch.uint8)
    for fs, sps in pics:
        assert (sps.width, sps.height) == (1920, 1080)
        assert (fs.mb_width, fs.mb_height) == (120, 68)
        assert fs.no_reorder and not fs.has_pcm and fs.deblock_enabled
        assert np.abs(fs.luma_coeffs).max() < 32768
        if fs.mv is not None:
            assert fs.wp is not None
            walk = PRT.intra_steps(fs.mb_class)
            assert 0 < sum(walk) < len(walk) // 2
            ids = dpb.list0(fs)[1]
            assert len(ids) == fs.num_ref_l0
            if fs.num_ref_l0 > 1:
                assert len(set(ids)) < len(ids)
        dpb.add(fs, z, zc, zc)


def test_1080p_fixture_digests_match_libavcodec():
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    s = h264_inter_fixture_stream()
    assert len(s) < 1024 * 1024
    with open(H264_INTER_DIGESTS) as f:
        meta = json.load(f)
    frames, W, H = oracle_decode(s)
    assert (W, H) == (meta["width"], meta["height"]) == (1920, 1080)
    assert len(frames) == len(meta["frames"]) == 5
    for frame, want in zip(frames, meta["frames"]):
        for plane, a in zip("YUV", frame):
            got = hashlib.sha256(np.ascontiguousarray(a)).hexdigest()
            assert got == want[plane]
