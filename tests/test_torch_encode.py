"""The port's encoders on the CPU against jmcodec_tpu's, at tolerance 0:

- the encoder half of ops/transform.py (forward transform, quantisers,
  Hadamards; torch and numpy twins) and the CAVLC, intra and P/B
  macroblock writers, on seeded inputs;
- the RD threshold's bit length: equal to the reference's
  floor(log2(float32)) + 1 over every level a 4x4 quantisation can give,
  and XLA's CPU log2 one less than exact at 8192 and 32768;
- kernels/encode_tiles.py: me_p_frame, _mc_luma_batched_from_planes and
  every output of encode_p_frame, at search ranges 8 and 16, qp 0-51, on
  moving, static and flat content (every candidate ties on flat luma);
- DeviceH264Encoder(device="cpu"): the bytes and recon_cropped() of each
  frame against jmcodec_tpu's DeviceH264Encoder, and libavcodec's decode
  of the stream equal to that recon, GOPs crossing a second IDR;
- the numpy H264ReferenceEncoder (P and B groups) and HevcEncoder (IDR +
  P) byte for byte against jmcodec_tpu's, with libavcodec's decode equal
  to their recon;
- tools/fixtures.pan_frames() and encode_fixture_frames() equal to
  tests/util_oracle's frames, and the committed 1080p fixture's keys.

Run as a script, the file rebuilds tests/data/h264_enc_1080p.sha256.json
from jmcodec_tpu's EncoderSession on its CPU backend (about 90 s):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_encode.py
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.codec.h264 import cavlc as JCAVLC
from jmcodec_tpu.codec.h264 import devenc as JDEV
from jmcodec_tpu.codec.h264 import inter as JINTER
from jmcodec_tpu.codec.h264 import macroblock as JMB
from jmcodec_tpu.codec.h264 import refenc as JREF
from jmcodec_tpu.codec.hevc import refenc as JHEVC
from jmcodec_tpu.kernels import encode_tiles as JET
from jmcodec_tpu.kernels import recon_tiles as JRT
from jmcodec_tpu.ops import transform as JT
from jmcodec_tpu_torch.codec.h264 import cavlc as CAVLC
from jmcodec_tpu_torch.codec.h264 import devenc as DEV
from jmcodec_tpu_torch.codec.h264 import inter as INTER
from jmcodec_tpu_torch.codec.h264 import macroblock as MB
from jmcodec_tpu_torch.codec.h264 import refenc as REF
from jmcodec_tpu_torch.codec.hevc import refenc as HEVC
from jmcodec_tpu_torch.kernels import encode_tiles as ET
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.ops import transform as T
from jmcodec_tpu_torch.tools.fixtures import (ENCODE_DIGESTS,
                                              encode_fixture,
                                              encode_fixture_frames,
                                              pan_frames)
from jmcodec_tpu_torch.utils.bits import BitWriter

from test_inter_decode import moving_frames
from util_oracle import have_oracle, make_frame, oracle_decode

needs_oracle = pytest.mark.skipif(not have_oracle(),
                                  reason="libavcodec oracle unavailable")
QPS = (0, 20, 28, 36, 51)


def _np(a):
    return np.asarray(a)


def _eq(a, b):
    """Equal values, and the port's int32 where the reference is int32."""
    a, b = _np(a), b.numpy() if isinstance(b, torch.Tensor) else _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# transform, quantisation, writers
# ---------------------------------------------------------------------------

def test_forward_transform_and_hadamards_match_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(-255, 256, (500, 4, 4)).astype(np.int32)
    dc2 = rng.integers(-4080, 4081, (300, 2, 2)).astype(np.int32)
    dc4 = rng.integers(-4080, 4081, (300, 4, 4)).astype(np.int32)
    want = JT.forward_transform_4x4(jnp.asarray(x), jnp)
    assert _eq(want, T.forward_transform_4x4(torch.from_numpy(x)))
    assert _eq(JT.np_forward_transform_4x4(x), T.np_forward_transform_4x4(x))
    assert _eq(JT.hadamard_2x2(jnp.asarray(dc2), jnp),
               T.hadamard_2x2(torch.from_numpy(dc2)))
    assert _eq(JT.hadamard_2x2(dc2, np), T.np_hadamard_2x2(dc2))
    assert _eq(JT.hadamard_4x4(dc4, np), T.np_hadamard_4x4(dc4))
    assert _eq(JT.QUANT_MF4x4, T.QUANT_MF4x4)


@pytest.mark.parametrize("intra", [False, True])
def test_quantisers_match_jax_at_every_qp(intra):
    rng = np.random.default_rng(2)
    # the 4x4 transform of a residual in [-255, 255] stays within 36 * 255;
    # a chroma DC Hadamard within 4 * 16 * 255, a luma one 16 * 16 * 255
    w = rng.integers(-9180, 9181, (200, 4, 4)).astype(np.int32)
    dc2 = rng.integers(-16320, 16321, (200, 2, 2)).astype(np.int32)
    dc4 = rng.integers(-65280, 65281, (50, 4, 4)).astype(np.int32)
    mf_j, mf_t = jnp.asarray(JT.QUANT_MF4x4), torch.from_numpy(T.QUANT_MF4x4)
    for qp in range(52):
        assert _eq(JT.quant_4x4(jnp.asarray(w), jnp.int32(qp), intra, jnp,
                                mf_j),
                   T.quant_4x4(torch.from_numpy(w), qp, intra, mf_t)), qp
        assert _eq(JT.np_quant_4x4(w, qp, intra),
                   T.np_quant_4x4(w, qp, intra)), qp
        for dc in (dc2, dc4):
            assert _eq(JT.quant_dc(jnp.asarray(dc), jnp.int32(qp), jnp,
                                   mf_j),
                       T.quant_dc(torch.from_numpy(dc), qp)), qp
            assert _eq(JT.quant_dc(dc, qp, np, JT.QUANT_MF4x4),
                       T.np_quant_dc(dc, qp)), qp


def _max_luma_level():
    """The largest |level| of a 4x4 luma block at qp 0 (the largest step
    of MF): the transform's gain per position (the row sums of |Cf|, 4 or
    6, multiplied) times 255, quantised with the intra rounding."""
    gain = np.outer([4, 6, 4, 6], [4, 6, 4, 6]) * 255
    return int(((gain * T.QUANT_MF4x4[0] + (1 << 15) // 3) >> 15).max())


def test_bit_length_equals_the_reference_log2_over_the_level_range():
    top = _max_luma_level()
    assert 1 << 10 <= top < 1 << 11
    levels = np.arange(0, top + 1, dtype=np.int32)
    ref = jax.jit(lambda a: jnp.where(a > 0, jnp.floor(jnp.log2(
        jnp.maximum(a, 1).astype(jnp.float32))).astype(jnp.int32) + 1, 0))
    assert _eq(ref(levels), ET._bit_length(torch.from_numpy(levels)))
    # XLA's CPU log2 lands just below the power at these two points, where
    # the exact bit length (the port's) is one more; no 4x4 level reaches
    # them
    far = np.array([8192, 32768], np.int32)
    assert _np(ref(far)).tolist() == [13, 15]
    assert ET._bit_length(torch.from_numpy(far)).tolist() == [14, 16]


def _random_blocks(rng, n, nmax, lo, hi):
    out = []
    for _ in range(n):
        c = rng.integers(lo, hi + 1, nmax) * (rng.random(nmax) < 0.4)
        out.append([int(v) for v in c])
    return out


def test_cavlc_writer_matches_jax():
    rng = np.random.default_rng(3)
    for nc in (-1, 0, 1, 2, 3, 4, 7, 8, 16):
        nmax = 4 if nc < 0 else 16
        for lo, hi in ((-1, 1), (-3, 3), (-40, 40), (-3000, 3000)):
            for blk in _random_blocks(rng, 25, nmax, lo, hi):
                wj, wt = JCAVLC.BitWriter(), BitWriter()
                tj = JCAVLC.encode_residual_block(wj, blk, nc, nmax)
                tt = CAVLC.encode_residual_block(wt, blk, nc, nmax)
                wj.rbsp_trailing_bits(), wt.rbsp_trailing_bits()
                assert tj == tt and wj.bytes() == wt.bytes(), (nc, blk)
    assert _eq(JMB.CBP_INTRA_TO_CODE, MB.CBP_INTRA_TO_CODE)
    assert _eq(JMB.CBP_INTER_TO_CODE, MB.CBP_INTER_TO_CODE)
    for v, m in ((0, 1), (1, 1), (0, 3), (2, 3), (5, 7)):
        wj, wt = JCAVLC.BitWriter(), BitWriter()
        JINTER.write_te(wj, v, m), INTER.write_te(wt, v, m)
        wj.rbsp_trailing_bits(), wt.rbsp_trailing_bits()
        assert wj.bytes() == wt.bytes()


def _i_symbols(mod, rng, my, mx, cls):
    s = mod.MBSymbols()
    s.mb_class = cls
    s.qp = int(rng.integers(20, 40))
    s.chroma_mode = int(rng.integers(0, 4))
    if cls == mod.MB_I4x4:
        s.i4_modes = [int(v) for v in rng.integers(0, 9, 16)]
    else:
        s.i16_mode = int(rng.integers(0, 4))
        s.luma_dc = _random_blocks(rng, 1, 16, -20, 20)[0]
    s.cbp_luma = int(rng.integers(0, 16)) if cls == mod.MB_I4x4 else \
        int(rng.choice([0, 15]))
    s.cbp_chroma = int(rng.integers(0, 3))
    n_ac = 16 if cls == mod.MB_I4x4 else 15
    s.luma_ac = _random_blocks(rng, 16, n_ac, -9, 9)
    s.chroma_dc = _random_blocks(rng, 2, 4, -9, 9)
    s.chroma_ac = [_random_blocks(rng, 4, 15, -9, 9) for _ in range(2)]
    return s


def test_macroblock_writers_match_jax():
    """Intra macroblocks in an I slice, then P_16x16 / 16x8 / 8x16 and
    intra macroblocks in a P slice, on seeded symbols."""
    rng_seed = 4
    outs = []
    for mb_mod, inter_mod, bw in ((JMB, JINTER, JCAVLC.BitWriter),
                                  (MB, INTER, BitWriter)):
        rng = np.random.default_rng(rng_seed)
        w = bw()
        g = mb_mod.MBGrids(3, 2)
        for my in range(2):
            for mx in range(3):
                cls = mb_mod.MB_I4x4 if (my + mx) % 2 else mb_mod.MB_I16x16
                mb_mod.write_i_macroblock(w, g, my, mx, 0, 28,
                                          _i_symbols(mb_mod, rng, my, mx,
                                                     cls))
        g = mb_mod.MBGrids(3, 2)
        m = inter_mod.MotionGrids(3, 2)
        for my in range(2):
            for mx in range(3):
                k = (my * 3 + mx) % 4
                if k == 3:
                    s = _i_symbols(mb_mod, rng, my, mx, mb_mod.MB_I4x4)
                else:
                    s = inter_mod.PMBSymbols()
                    s.mb_class = inter_mod.MB_P
                    s.p_type = (inter_mod.P_16x16, inter_mod.P_16x8,
                                inter_mod.P_8x16)[k]
                    s.qp = 28
                    mvs = rng.integers(-40, 41, (2, 2)).astype(np.int32)
                    if k == 0:
                        s.partitions = [inter_mod.InterPartition(
                            my * 4, mx * 4, 4, 4, 0, mvs[0])]
                    elif k == 1:
                        s.partitions = [inter_mod.InterPartition(
                            my * 4 + 2 * i, mx * 4, 4, 2, 0, mvs[i])
                            for i in range(2)]
                    else:
                        s.partitions = [inter_mod.InterPartition(
                            my * 4, mx * 4 + 2 * i, 2, 4, 0, mvs[i])
                            for i in range(2)]
                    s.cbp_luma = int(rng.integers(0, 16))
                    s.cbp_chroma = int(rng.integers(0, 3))
                    s.luma_ac = _random_blocks(rng, 16, 16, -9, 9)
                    s.chroma_dc = _random_blocks(rng, 2, 4, -9, 9)
                    s.chroma_ac = [_random_blocks(rng, 4, 15, -9, 9)
                                   for _ in range(2)]
                inter_mod.write_p_macroblock(w, g, m, my, mx, 0, 28, s, 1)
        w.rbsp_trailing_bits()
        outs.append(w.bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 100


# ---------------------------------------------------------------------------
# encode_tiles
# ---------------------------------------------------------------------------

def _content(kind, W=96, H=64):
    """(current, reference) frames: moving (a pan), static (the same
    frame twice) or flat (flat luma: every full-pel candidate ties)."""
    if kind == "moving":
        ref, cur = moving_frames(W, H, 2)
    elif kind == "static":
        ref = cur = make_frame(W, H, seed=6)
    else:
        ref, cur = moving_frames(W, H, 2, kind="flat")
    return cur, ref


def _refs(ref):
    jref = JRT.pad_ref_device(*(jnp.asarray(p) for p in ref))
    tref = RT.pad_ref_device(*(torch.from_numpy(p) for p in ref))
    return jref, tref


def test_tables_match_jax():
    for rng in (8, 16):
        assert _eq(JET._fullpel_bias(rng), ET._fullpel_bias(rng))
        assert _eq(JET._qpel_bits_table(rng)[0], ET._qpel_bits_table(rng)[0])
        assert JET._qpel_bits_table(rng)[1] == ET._qpel_bits_table(rng)[1]
    assert _eq(JET._LAMBDA2_T, ET._LAMBDA2_T)
    assert JET.SEARCH_RANGE == ET.SEARCH_RANGE < RT.MC_PAD


@pytest.mark.parametrize("kind", ["moving", "static", "flat"])
@pytest.mark.parametrize("rng", [8, 16])
def test_me_p_frame_matches_jax(rng, kind):
    cur, ref = _content(kind)
    jref, tref = _refs(ref)
    for lam in (1, 4):
        mv_j, sad_j = JET.me_p_frame(4, 6, rng, jnp.asarray(cur[0],
                                                            jnp.int32),
                                     jref[0], jnp.int32(lam))
        mv_t, sad_t = ET.me_p_frame(rng, torch.from_numpy(
            cur[0].astype(np.int32)), tref[0], lam)
        assert _eq(mv_j, mv_t) and _eq(sad_j, sad_t), lam
    with pytest.raises(ValueError, match="search range"):
        ET.me_p_frame(ET.SEARCH_RANGE + 1, torch.from_numpy(
            cur[0].astype(np.int32)), tref[0], 1)


def test_mc_luma_batched_from_planes_matches_jax():
    _, ref = _content("moving")
    jref, tref = _refs(ref)
    rng = np.random.default_rng(7)
    gh, gw = 16, 24
    mv = rng.integers(-160, 161, (gh, gw, 2)).astype(np.int32)
    mv[0, :3] = [[-4000, -4000], [4000, 4000], [3, -7]]   # clamped
    ref_idx = np.zeros((gh, gw), np.int32)
    want = JET._mc_luma_batched_from_planes(
        JRT._halfpel_planes(jref[0][None]), jnp.asarray(mv),
        jnp.asarray(ref_idx))
    planes = RT._halfpel_planes(tref[0][None])
    got = RT._mc_luma_batched_from_planes(planes, torch.from_numpy(mv),
                                          torch.from_numpy(ref_idx))
    assert _eq(want, got)
    assert ET._mc_luma_batched_from_planes is RT._mc_luma_batched_from_planes
    # leading axes: one prediction per candidate, as one at a time
    both = RT._mc_luma_batched_from_planes(
        planes, torch.from_numpy(np.stack([mv, -mv])),
        torch.zeros((2, gh, gw), dtype=torch.int32))
    assert torch.equal(both[0], got)
    assert _eq(JET._mc_luma_batched_from_planes(
        JRT._halfpel_planes(jref[0][None]), jnp.asarray(-mv),
        jnp.asarray(ref_idx)), both[1])


@pytest.mark.parametrize("kind", ["moving", "static", "flat"])
@pytest.mark.parametrize("rng", [8, 16])
def test_encode_p_frame_matches_jax(rng, kind):
    cur, ref = _content(kind)
    jref, tref = _refs(ref)
    for qp in QPS:
        qpc = int(T.chroma_qp(qp, 0))
        lam = max(1, 1 << max(0, (qp - 12) // 6))
        want = JET.encode_p_frame(
            4, 6, rng, *(jnp.asarray(p, jnp.int32) for p in cur), *jref,
            jnp.int32(qp), jnp.int32(qpc), jnp.int32(qpc), jnp.int32(lam))
        got = ET.encode_p_frame(
            rng, *(torch.from_numpy(p.astype(np.int32)) for p in cur),
            *tref, qp, qpc, qpc, lam)
        for name, a, b in zip(("mv", "luma_z", "chroma_ac", "chroma_dc",
                               "sad"), want, got):
            assert _eq(a, b), (qp, name)


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------

DEVICE_CASES = {  # (W, H, qp, gop, frames, pan step): the 64x64 GOP of
    "64x64_qp28_gop3": (64, 64, 28, 3, 4, (3, 2)),  # 3 and the 96x64 GOP
    "96x64_qp20_gop2": (96, 64, 20, 2, 4, (3, 2)),  # of 2 cross an IDR
    "96x64_qp36_gop8": (96, 64, 36, 8, 3, (3, 2)),
    "64x64_static_qp28": (64, 64, 28, 8, 3, (0, 0)),   # P_Skip
}


def _run(enc, frames, crop=True):
    out, recons = [enc.headers_annexb()], []
    for f in frames:
        out.append(enc.encode_frame(*(np.asarray(p, np.int32) for p in f)))
        recons.append(tuple(_np(p) for p in enc.recon_cropped()))
    if hasattr(enc, "flush"):
        out.append(enc.flush())
    return b"".join(out), recons


def _check_oracle(stream, recons, suffix=".h264"):
    want, _, _ = oracle_decode(stream, suffix=suffix)
    assert len(want) == len(recons)
    for i, (w, r) in enumerate(zip(want, recons)):
        for k, (a, b) in enumerate(zip(w, r)):
            assert np.array_equal(a, b), f"frame {i} plane {'YUV'[k]}"


@needs_oracle
@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_encoder_matches_jax_and_libavcodec(case):
    W, H, qp, gop, n, step = DEVICE_CASES[case]
    frames = moving_frames(W, H, n, step=step)
    cfg = dict(width=W, height=H, qp=qp, gop_len=gop)
    want, want_rec = _run(JDEV.DeviceH264Encoder(JREF.EncoderConfig(**cfg)),
                          frames)
    enc = DEV.DeviceH264Encoder(REF.EncoderConfig(**cfg), device="cpu")
    got, got_rec = _run(enc, frames)
    assert got == want
    for i, (a, b) in enumerate(zip(want_rec, got_rec)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), i
    _check_oracle(got, got_rec)
    if step == (0, 0):      # every P macroblock skipped: a few bytes
        assert len(got) - len(_run(JREF.H264ReferenceEncoder(
            JREF.EncoderConfig(**cfg)), frames[:1])[0]) < 20 * (n - 1)
    # the chain of references stays on the device after a P frame
    if (n - 1) % gop:
        assert all(isinstance(p, torch.Tensor) for p in enc._dev_ref)


def test_device_encoder_needs_a_card_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEV.DeviceH264Encoder(REF.EncoderConfig(64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEV.encode_stream_device([make_frame(64, 64)], 64, 64)


def test_encode_stream_device_matches_jax():
    frames = moving_frames(64, 64, 3)
    assert DEV.encode_stream_device(frames, 64, 64, qp=30, gop_len=3,
                                    device="cpu") == \
        JDEV.encode_stream_device(frames, 64, 64, qp=30, gop_len=3)


@needs_oracle
@pytest.mark.parametrize("qp,gop,bframes", [(28, 3, 0), (22, 8, 0),
                                           (30, 8, 2), (26, 4, 1)])
def test_host_encoder_matches_jax(qp, gop, bframes):
    """P (16x16, 16x8/8x16 splits, skip, intra fallback) and B groups
    (flushed at the IDR and at the end)."""
    W, H = 64, 48
    frames = moving_frames(W, H, 5, step=(2, 3))
    cfg = dict(width=W, height=H, qp=qp, gop_len=gop, num_bframe=bframes)
    want, _ = _run(JREF.H264ReferenceEncoder(JREF.EncoderConfig(**cfg)),
                   frames)
    enc = REF.H264ReferenceEncoder(REF.EncoderConfig(**cfg))
    got, rec = _run(enc, frames)
    assert got == want
    if not bframes:
        _check_oracle(got, rec)
    else:
        assert len(oracle_decode(got)[0]) == len(frames)
    (got, rec), (want, want_rec) = (
        mod.encode_stream(frames[:2], W, H, qp=qp) for mod in (REF, JREF))
    assert got == want
    assert all(np.array_equal(a, b) for x, y in zip(rec, want_rec)
               for a, b in zip(x, y))


@needs_oracle
@pytest.mark.parametrize("W,H,qp,gop", [(64, 64, 30, 8), (72, 40, 24, 2)])
def test_hevc_encoder_matches_jax(W, H, qp, gop):
    frames = moving_frames(W, H, 3)
    runs = []
    for mod in (JHEVC, HEVC):
        enc = mod.HevcEncoder(W, H, qp=qp, gop_len=gop)
        out, recs = enc.headers_annexb(), []
        for f in frames:
            out += enc.encode_frame(*f)
            recs.append(tuple(_np(p) for p in enc.last_recon))
        runs.append((out, recs))
    assert runs[0][0] == runs[1][0]
    _check_oracle(runs[1][0], runs[1][1], ".h265")
    assert HEVC.encode_stream_hevc(frames[:1], W, H, qp=qp) == \
        JHEVC.encode_stream_hevc(frames[:1], W, H, qp=qp)


# ---------------------------------------------------------------------------
# the 1080p fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,H,n,step", [(1920, 1080, 3, (3, 2)),
                                        (96, 64, 4, (0, 0)),
                                        (64, 64, 5, (2, 3))])
def test_encode_fixture_frames_equal_util_oracles(W, H, n, step):
    got = pan_frames(W, H, n, step)
    if (W, H) == (1920, 1080):
        assert all(np.array_equal(a, b) for x, y in zip(
            got, encode_fixture_frames()) for a, b in zip(x, y))
    want = moving_frames(W, H, n, step=step)
    assert len(got) == len(want) == n
    for f, (a, b) in enumerate(zip(got, want)):
        for k in range(3):
            assert a[k].dtype == b[k].dtype == np.uint8
            assert np.array_equal(a[k], b[k]), (f, "YUV"[k])


def test_encode_fixture_record():
    fx = encode_fixture()
    assert sorted(fx) == ["frames", "keyframes", "stream"]
    assert fx["keyframes"] == [True, False, False]
    assert len(fx["frames"]) == 3 and fx["stream"]["length"] > 0


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def build_encode_fixture():
    """The fixture's record from jmcodec_tpu's EncoderSession(EncoderParams())
    with the device engine on its CPU backend: the stream's SHA-256 and
    length, the keyframe flags, libavcodec's digests of every plane."""
    from jmcodec_tpu.api.session import (EncoderParams, EncoderSession,
                                         PixFmt)
    sess = EncoderSession(EncoderParams(engine="device"))
    packets = []
    for Y, U, V in encode_fixture_frames():
        sess.encode_frame(Y.tobytes() + U.tobytes() + V.tobytes(),
                          PixFmt.I420)
        while (p := sess.output_bitstream()) is not None:
            packets.append(p)
    sess.set_eof()
    while (p := sess.output_bitstream()) is not None:
        packets.append(p)
    stream = b"".join(b for b, _ in packets)
    want, _, _ = oracle_decode(stream)
    rec = {"stream": {"sha256": hashlib.sha256(stream).hexdigest(),
                      "length": len(stream)},
           "keyframes": [k for _, k in packets],
           "frames": [{k: _sha(p) for k, p in zip("YUV", fr)}
                      for fr in want]}
    with open(ENCODE_DIGESTS, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(build_encode_fixture()["stream"]))
