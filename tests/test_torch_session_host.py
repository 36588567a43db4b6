"""The port's numpy H.264 host decoder on the CPU, at tolerance 0:

- the numpy twins in the port's ops/ (the np_* transforms, chroma_qp, the
  intra predictors, the deblocking pass, MC) equal jmcodec_tpu's on seeded
  inputs: every qp, every mode and availability, every MV phase;
- H264ReferenceDecoder equals jmcodec_tpu's, frame by frame, over the
  session fixtures, the small committed H.264 streams and an oracle-made
  High-profile CABAC B stream, and equals the libavcodec digests where a
  stream has them;
- on single bit flips in the second picture of a B stream both decoders
  raise the same exception or give the same frames.

The session fixtures were made with tests/util_oracle.py (x264 via the
oracle, libavcodec for the digests) from moving_frames of
tests/test_inter_decode.py and make_frame:
  h264_session_b_96x64     moving_frames(96, 64, 6, step=(3, 5)), qp 28,
                           gop 6, extra "bframes=2", profile main (POC
                           type 0: the IDR on the device, the rest on the
                           host)
  h264_session_high_96x64  the same frames, qp 28, gop 6, extra
                           "cabac=1:8x8dct=1:bframes=0", profile high
  h264_session_pcm_48x48   make_frame(48, 48, seed=i, kind="noise") for
                           i < 3, qp 0, gop 1 (I_PCM macroblocks)
  h264_session_idr3_96x64  jmcodec_tpu.codec.h264.refenc.encode_stream of
                           make_frame(96, 64, seed=i) for i < 3, qp 30
                           (three IDR pictures, all on the device path)
each with a .sha256.json of its libavcodec decode.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from jmcodec_tpu.codec.h264.refdec import H264ReferenceDecoder as JaxRefDec
from jmcodec_tpu.ops import deblock as JDB
from jmcodec_tpu.ops import intra as JIP
from jmcodec_tpu.ops import mc as JMC
from jmcodec_tpu.ops import transform as JT
from jmcodec_tpu_torch.api.h264_intra import _picture_chunks
from jmcodec_tpu_torch.codec.h264.refdec import H264ReferenceDecoder
from jmcodec_tpu_torch.ops import deblock as DB
from jmcodec_tpu_torch.ops import intra as IP
from jmcodec_tpu_torch.ops import mc as MC
from jmcodec_tpu_torch.ops import transform as T

from test_inter_decode import moving_frames
from util_oracle import have_oracle, oracle_decode, oracle_encode

DATA = os.path.join(os.path.dirname(__file__), "data")
SESSION_STREAMS = ["h264_session_b_96x64", "h264_session_high_96x64",
                   "h264_session_pcm_48x48", "h264_session_idr3_96x64"]
SMALL_STREAMS = ["h264_80x64", "h264_96x64_slices3", "h264_inter_72x40",
                 "h264_inter_cabac_wp_64x64", "h264_inter_idr2_64x64",
                 "h264_inter_p_64x64", "h264_inter_slices3_96x64",
                 "h264_inter_static_64x48", "h264_inter_veryslow_96x64"]


def _stream(name):
    with open(os.path.join(DATA, name + ".h264"), "rb") as f:
        return f.read()


def _digests(name):
    path = os.path.join(DATA, name + ".sha256.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["frames"]


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def _decode(cls, stream):
    dec = cls()
    out = dec.decode_annexb(stream) + dec.flush()
    sps = list(dec.sps.values())[0]
    return [fr.crop(sps) for fr in out]


def _assert_same_frames(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k, a, b in zip("YUV", g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, (i, k)
            assert np.array_equal(a, b), f"frame {i} {k}"


# ---------------------------------------------------------------------------
# the numpy twins of ops/ against jmcodec_tpu's
# ---------------------------------------------------------------------------


def test_transform_twins_match_jax():
    rng = np.random.default_rng(0)
    assert np.array_equal(T.ZIGZAG4x4, JT.ZIGZAG4x4)
    assert np.array_equal(T.INV_ZIGZAG4x4, JT.INV_ZIGZAG4x4)
    assert np.array_equal(T.ZIGZAG8x8, JT.ZIGZAG8x8)
    assert np.array_equal(T.DEQUANT8x8, JT.DEQUANT8x8)
    for off in (-12, -3, 0, 5, 12):
        qps = np.arange(52)
        assert np.array_equal(T.chroma_qp(qps, off), JT.chroma_qp(qps, off))
        assert int(T.chroma_qp(30, off)) == int(JT.chroma_qp(30, off))
    for qp in range(52):
        # levels over a small range and over the int16 range (overflow
        # wraps alike)
        for hi in (40, 1 << 15):
            c4 = rng.integers(-hi, hi, (4, 4)).astype(np.int32)
            c8 = rng.integers(-hi, hi, (8, 8)).astype(np.int32)
            dc2 = rng.integers(-hi, hi, (2, 2)).astype(np.int32)
            pairs = [
                (T.np_dequant_4x4(c4, qp), JT.np_dequant_4x4(c4, qp)),
                (T.np_inverse_transform_4x4(c4),
                 JT.np_inverse_transform_4x4(c4)),
                (T.np_luma_dc_decode(c4, qp), JT.np_luma_dc_decode(c4, qp)),
                (T.np_chroma_dc_decode(dc2, qp),
                 JT.np_chroma_dc_decode(dc2, qp)),
                (T.np_dequant_8x8(c8, qp), JT.np_dequant_8x8(c8, qp)),
                (T.np_inverse_transform_8x8(c8 * 64),
                 JT.np_inverse_transform_8x8(c8 * 64)),
            ]
            for k, (g, w) in enumerate(pairs):
                assert g.dtype == w.dtype, (qp, k, g.dtype, w.dtype)
                assert np.array_equal(g, w), (qp, hi, k)


def test_intra_twins_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(6):
        t16 = rng.integers(0, 256, 16).astype(np.int32)
        l16 = rng.integers(0, 256, 16).astype(np.int32)
        tl = int(rng.integers(0, 256))
        for at in (False, True):
            for al in (False, True):
                for m in range(9):
                    assert np.array_equal(
                        IP.pred4x4(m, t16[:8], l16[:4], tl, at, al),
                        JIP.pred4x4(m, t16[:8], l16[:4], tl, at, al))
                    for atl in (False, True):
                        try:
                            want = JIP.pred8x8(m, t16, l16[:8], tl, at, al,
                                               atl)
                        except ValueError:
                            with pytest.raises(ValueError):
                                IP.pred8x8(m, t16, l16[:8], tl, at, al, atl)
                            continue
                        got = IP.pred8x8(m, t16, l16[:8], tl, at, al, atl)
                        assert got.dtype == want.dtype
                        assert np.array_equal(got, want), (m, at, al, atl)
                for m in range(4):
                    for fn, jfn, n in ((IP.pred16x16, JIP.pred16x16, 16),
                                       (IP.pred_chroma8x8,
                                        JIP.pred_chroma8x8, 8)):
                        try:
                            want = jfn(m, t16[:n], l16[:n], tl, at, al)
                        except ValueError:
                            with pytest.raises(ValueError):
                                fn(m, t16[:n], l16[:n], tl, at, al)
                            continue
                        got = fn(m, t16[:n], l16[:n], tl, at, al)
                        assert got.dtype == want.dtype
                        assert np.array_equal(got, want), (n, m, at, al)


@pytest.mark.parametrize("mbh,mbw", [(2, 3), (3, 2)])
def test_deblock_frame_matches_jax(mbh, mbw):
    """Random planes of low contrast (so that edges filter; V of full
    contrast), random qp per macroblock, bS 0..4, both offsets and both
    chroma qp offsets."""
    rng = np.random.default_rng(mbh * 7 + mbw)
    Y = rng.integers(90, 110, (mbh * 16, mbw * 16)).astype(np.int32)
    U = rng.integers(90, 110, (mbh * 8, mbw * 8)).astype(np.int32)
    V = rng.integers(0, 256, (mbh * 8, mbw * 8)).astype(np.int32)
    qp = rng.integers(20, 52, (mbh, mbw)).astype(np.int32)
    bs_v = rng.integers(0, 5, (mbh * 4, mbw * 4)).astype(np.int32)
    bs_h = rng.integers(0, 5, (mbh * 4, mbw * 4)).astype(np.int32)
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    planes = [(Y.copy(), U.copy(), V.copy()) for _ in range(2)]
    args = (qp, bs_v, bs_h, 2, -2, 3, -4)
    DB.deblock_frame(*planes[0], *args)
    JDB.deblock_frame(*planes[1], *args)
    for g, w in zip(planes[0], planes[1]):
        assert np.array_equal(g, w)
    assert not np.array_equal(planes[0][0], Y)
    for g, w in zip(DB.intra_frame_bs(mbh, mbw), JDB.intra_frame_bs(mbh, mbw)):
        assert np.array_equal(g, w)


def test_mc_twins_match_jax():
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 256, (32, 48)).astype(np.int32)
    refc = rng.integers(0, 256, (16, 24)).astype(np.int32)
    assert np.array_equal(MC.pad_ref(ref), JMC.pad_ref(ref))
    rp, rpc = MC.pad_ref(ref), MC.pad_ref(refc)
    for mvy in range(-9, 9):
        for mvx in range(-9, 9):
            for (x0, y0, w, h) in ((0, 0, 16, 16), (28, 12, 4, 8)):
                assert np.array_equal(
                    MC.mc_luma_block(rp, x0, y0, mvx * 5, mvy * 3, w, h),
                    JMC.mc_luma_block(rp, x0, y0, mvx * 5, mvy * 3, w, h))
                assert np.array_equal(
                    MC.mc_chroma_block(rpc, x0 // 2, y0 // 2, mvx * 7,
                                       mvy * 5, w // 2, h // 2),
                    JMC.mc_chroma_block(rpc, x0 // 2, y0 // 2, mvx * 7,
                                        mvy * 5, w // 2, h // 2))


# ---------------------------------------------------------------------------
# the host decoder against jmcodec_tpu's and libavcodec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SESSION_STREAMS + SMALL_STREAMS)
def test_host_decoder_matches_jax(name):
    stream = _stream(name)
    got = _decode(H264ReferenceDecoder, stream)
    _assert_same_frames(got, _decode(JaxRefDec, stream))
    digests = _digests(name)
    if digests is not None:
        assert len(digests) == len(got)
        for fr, d in zip(got, digests):
            assert [_sha(p) for p in fr] == [d[k] for k in "YUV"]


@pytest.mark.skipif(not have_oracle(), reason="oracle unavailable")
def test_host_decoder_high_cabac_b():
    frames = moving_frames(96, 64, 6, step=(3, 5), kind="noise")
    stream = oracle_encode(frames, 96, 64, qp=30, gop=6,
                           extra="cabac=1:8x8dct=1:bframes=2:ref=2",
                           profile="high")
    want, _, _ = oracle_decode(stream)
    got = _decode(H264ReferenceDecoder, stream)
    _assert_same_frames(got, _decode(JaxRefDec, stream))
    _assert_same_frames(got, want)


@pytest.mark.parametrize("trial", range(6))
def test_host_decoder_bitflips_match_jax(trial):
    """A bit flipped in the second picture (decode order) of the B
    fixture: the same exception, or the same frames."""
    stream = _stream("h264_session_b_96x64")
    head, chunks = _picture_chunks(stream)
    lo = len(head) + len(chunks[0]) + 8
    rng = np.random.default_rng(100 + trial)
    b = bytearray(stream)
    b[int(rng.integers(lo, lo + len(chunks[1]) - 9))] ^= \
        1 << int(rng.integers(0, 8))

    def run(cls):
        try:
            return _decode(cls, bytes(b))
        except Exception as e:               # compared below
            return type(e), str(e)

    got, want = run(H264ReferenceDecoder), run(JaxRefDec)
    if isinstance(want, tuple):
        assert got == want
    else:
        _assert_same_frames(got, want)
