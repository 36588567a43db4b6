"""The port's H.264 all-intra slice end to end on the CPU: committed x264
streams -> parse_h264_intra_symbols -> stack_symbols ->
decode_frames_batch(..., "cpu") equal jmcodec_tpu's tile decode (CPU
backend) and, where the oracle is built, libavcodec, bit for bit. The
port's own parser fills the same FrameSymbols as jmcodec_tpu's.

The streams were made with tests/util_oracle.py (x264 via the oracle,
CAVLC, no 8x8 transform, gop 1):
  h264_80x64.h264          make_frame(80, 64, seed=11) and
                           make_frame(80, 64, seed=12, kind="edges"), qp 30
  h264_96x64_slices3.h264  make_frame(96, 64, seed=12), qp 28,
                           extra="slices=3"
  h264_1080p_intra.h264    make_frame(1920, 1080, seed=i) for i in 0, 1,
                           qp 30 (the GPU smoke's input, as
                           bench.make_test_stream makes it)
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.codec.h264.fastdec import FastH264Parser as JaxParser
from jmcodec_tpu.codec.h264.refenc import encode_stream
from jmcodec_tpu.kernels import recon as JR
from jmcodec_tpu.kernels import recon_tiles as JRT
from jmcodec_tpu_torch.api.h264_intra import (decode_h264_intra,
                                              parse_h264_intra_symbols)
from jmcodec_tpu_torch.codec.h264.symbols import FrameSymbols
from jmcodec_tpu_torch.kernels import recon as PR
from jmcodec_tpu_torch.kernels import recon_tiles as PRT
from jmcodec_tpu_torch.tools.fixtures import symbols_from_reference

from util_oracle import have_oracle, make_frame, oracle_decode

DATA = os.path.join(os.path.dirname(__file__), "data")
STREAMS = {"80x64": ("h264_80x64.h264", 2, 1),
           "96x64_slices3": ("h264_96x64_slices3.h264", 1, 3)}
ARRAYS = ("mb_class", "qp", "i4_modes", "i16_mode", "chroma_mode",
          "luma_coeffs", "luma_dc", "chroma_coeffs", "chroma_dc",
          "avail_left", "avail_top", "avail_topright", "avail_topleft")
SCALARS = ("mb_width", "mb_height", "has_pcm", "frame_num", "is_idr",
           "nal_ref_idc", "deblock_enabled", "alpha_off", "beta_off",
           "chroma_qp_off", "second_chroma_qp_off")


def _stream(name):
    return open(os.path.join(DATA, STREAMS[name][0]), "rb").read()


@pytest.fixture(scope="module")
def parsed():
    """name -> (stream, the port's [(fs, sps)], jmcodec_tpu's)."""
    return {name: (_stream(name), parse_h264_intra_symbols(_stream(name)),
                   JaxParser().parse_annexb(_stream(name)))
            for name in STREAMS}


def _jax_decode(fs, deblock):
    return JRT.decode_frame_symbols(fs, deblock=deblock)


@pytest.mark.parametrize("name", list(STREAMS))
def test_parser_fills_the_same_symbols(parsed, name):
    _, ours, theirs = parsed[name]
    n_frames, n_slices = STREAMS[name][1:]
    assert len(ours) == len(theirs) == n_frames
    for (a, sa), (b, sb) in zip(ours, theirs):
        assert isinstance(a, FrameSymbols)
        assert (sa.width, sa.height) == (sb.width, sb.height)
        for f in ARRAYS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        for f in SCALARS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.mv is None and a.pcm_y is None
    if n_slices > 1:
        # slice boundaries cut the top availability inside the picture
        assert (ours[0][0].avail_top[1:] == 0).any()


@pytest.mark.parametrize("deblock", [True, False], ids=["deblock", "raw"])
def test_slice_matches_jax_tile_decode(parsed, deblock):
    """The smallest stream against recon_tiles.decode_frame on the CPU
    backend, with and without the deblock scan."""
    _, ours, theirs = parsed["80x64"]
    fss = [fs for fs, _ in ours]
    got = PRT.decode_frames_batch(fss[0].mb_height, fss[0].mb_width,
                                  *PR.stack_symbols(fss, "cpu"),
                                  deblock=deblock)
    for i, (fs, _) in enumerate(theirs):
        want = _jax_decode(fs, deblock)
        for k, plane in enumerate("YUV"):
            assert got[k].dtype == torch.uint8
            assert np.array_equal(got[k][i].numpy(), want[k]), \
                f"frame {i} {plane}"


def test_multislice_matches_jax_tile_decode(parsed):
    _, ours, theirs = parsed["96x64_slices3"]
    fs = ours[0][0]
    got = PRT.decode_frame_symbols(fs, device="cpu")
    want = _jax_decode(theirs[0][0], True)
    one = PRT.decode_frame(fs.mb_height, fs.mb_width,
                           *(a[0] for a in PR.stack_symbols([fs], "cpu")))
    for k in range(3):
        assert np.array_equal(got[k], want[k])
        assert np.array_equal(one[k].numpy(), want[k])


@pytest.mark.parametrize("name", list(STREAMS))
def test_slice_matches_libavcodec(name):
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    s = _stream(name)
    got = decode_h264_intra(s, "cpu", workers=2)
    want, W, H = oracle_decode(s)
    assert tuple(got[0].shape) == (len(want), H, W)
    for i, frame in enumerate(want):
        for k, plane in enumerate("YUV"):
            assert np.array_equal(got[k][i].numpy(), frame[k]), \
                f"frame {i} {plane}"


def test_crop_and_deblock_flag_follow_the_stream():
    """A 72x40 picture (not a multiple of 16) coded with the deblocking
    filter off, by jmcodec_tpu's own encoder: the port crops to the SPS
    size and skips the deblock scan, as jmcodec_tpu's tile decode does."""
    frames = [make_frame(72, 40, seed=8, kind="edges")]
    stream, _ = encode_stream(frames, 72, 40, qp=30, disable_deblock=True)
    (fs, sps), = parse_h264_intra_symbols(stream)
    assert not fs.deblock_enabled and (fs.mb_height, fs.mb_width) == (3, 5)
    Y, U, V = decode_h264_intra(stream, "cpu")
    assert tuple(Y.shape) == (1, 40, 72) and tuple(U.shape) == (1, 20, 36)
    jfs, _ = JaxParser().parse_annexb(stream)[0]
    want = JRT.decode_frame_symbols(jfs)
    for g, w in zip((Y, U, V), want):
        h, wd = g.shape[1:]
        assert np.array_equal(g[0].numpy(), w[:h, :wd])
    filtered = PRT.decode_frame_symbols(fs, deblock=True, device="cpu")
    assert not np.array_equal(filtered[0][:40, :72], Y[0].numpy())


def test_stack_symbols_takes_either_packages_symbols(parsed):
    """One set of numpy arrays feeds both: the port's stack_symbols on
    jmcodec_tpu's FrameSymbols (copied by symbols_from_reference) gives the
    tensors jmcodec_tpu's stack_symbols gives."""
    _, _, theirs = parsed["80x64"]
    fss = [fs for fs, _ in theirs]
    copies = [symbols_from_reference(fs) for fs in fss]
    assert all(isinstance(c, FrameSymbols) for c in copies)
    assert copies[0].luma_coeffs is not fss[0].luma_coeffs
    ours = PR.stack_symbols(copies, "cpu")
    want = JR.stack_symbols(fss)
    assert len(ours) == len(want) == 16
    for a, b in zip(ours, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


def test_entry_points_need_the_card_unless_told(parsed):
    _, ours, _ = parsed["80x64"]
    fss = [fs for fs, _ in ours]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PR.stack_symbols(fss)
    with pytest.raises(RuntimeError, match="CUDA"):
        PRT.decode_frame_symbols(fss[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_h264_intra(_stream("80x64"))


def test_unsupported_streams_raise():
    """P pictures are outside the intra path: the parser's
    NotImplementedError reaches the caller."""
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    from util_oracle import oracle_encode
    frames = [make_frame(64, 48, seed=i) for i in range(2)]
    stream = oracle_encode(frames, 64, 48, qp=30, gop=2)
    with pytest.raises(NotImplementedError):
        parse_h264_intra_symbols(stream)


def test_threaded_parse_matches_serial():
    s = _stream("80x64")
    for (a, _), (b, _) in zip(parse_h264_intra_symbols(s),
                              parse_h264_intra_symbols(s, workers=2)):
        for f in ARRAYS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_fixture_digests_match_libavcodec():
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    s = open(os.path.join(DATA, "h264_1080p_intra.h264"), "rb").read()
    assert len(s) < 2 * 1024 * 1024
    meta = json.load(open(os.path.join(DATA, "h264_1080p_intra.sha256.json")))
    frames, W, H = oracle_decode(s)
    assert (W, H) == (meta["width"], meta["height"]) == (1920, 1080)
    assert len(frames) == len(meta["frames"]) == 2
    for frame, want in zip(frames, meta["frames"]):
        for plane, a in zip("YUV", frame):
            got = hashlib.sha256(np.ascontiguousarray(a)).hexdigest()
            assert got == want[plane]


def test_fixture_parses_at_full_width():
    """The 1080p fixture through the port's parser: 120 x 68 macroblocks,
    every picture an IDR, levels within int16."""
    s = open(os.path.join(DATA, "h264_1080p_intra.h264"), "rb").read()
    pics = parse_h264_intra_symbols(s, workers=2)
    assert len(pics) == 2
    for fs, sps in pics:
        assert (fs.mb_width, fs.mb_height) == (120, 68)
        assert (sps.width, sps.height) == (1920, 1080)
        assert fs.is_idr and not fs.has_pcm and fs.deblock_enabled
        assert np.abs(fs.luma_coeffs).max() < 32768
        assert set(np.unique(fs.mb_class)) <= {0, 1}
