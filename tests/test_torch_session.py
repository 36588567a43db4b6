"""The port's DecoderSession on the CPU (device="cpu"), at tolerance 0:

- against jmcodec_tpu's DecoderSession on the CPU backend, stream by
  stream, fed in chunks: the same frames in the same order, the same
  repack bytes in all three PixFmt, the same deltas of the frames_device,
  corrupt_chunks and unsupported_pictures counters (each package counts
  its own). The streams: the session fixtures (B, High CABAC + 8x8, PCM,
  three IDR), committed and oracle-made I + P streams at 96x64 (one
  geometry, so that the JAX side compiles its two programs once), and the
  fault templates of tests/test_robustness.py on the three-IDR fixture:
  the bit-flip corpus, truncation, a dropped picture, a garbage prefix;
- the port alone: the fixtures' libavcodec digests with the device and
  host picture counts, the stream info, is_exit and the EOF drain,
  backpressure at INPUT_BUF_SIZE, the output formats and the callback,
  get_frame_device, an error of the device decode propagating (not routed
  to the host), a long stream of either codec holding no more pictures
  than its DPB, the HEVC session against libavcodec, HEVC pictures
  outside the device path against jmcodec_tpu's session, and the
  constructor raising without a card or with a failed native-parser
  build.

The fixtures' recipes are in tests/test_torch_session_host.py.
"""

import hashlib
import json
import logging
import os

import numpy as np
import pytest
import torch

from jmcodec_tpu.api.session import DecoderSession as JaxSession
from jmcodec_tpu.pipeline.gop import split_gops
from jmcodec_tpu.utils.metrics import counters as jax_counters
from jmcodec_tpu.utils.metrics import logger as jax_logger
from jmcodec_tpu_torch import native
from jmcodec_tpu_torch.api.session import (INPUT_BUF_SIZE,
                                           NEED_MORE_THRESHOLD, Codec,
                                           DecoderSession, PixFmt, repack)
from jmcodec_tpu_torch.tools.fixtures import (CORPUS_FIXTURE,
                                              P_CORPUS_FIXTURES,
                                              SESSION_FIXTURES,
                                              session_corpus, session_fixture)
from jmcodec_tpu_torch.utils.metrics import counters, logger

from test_inter_decode import moving_frames
from util_oracle import (have_oracle, make_frame, oracle_decode,
                         oracle_encode)

DATA = os.path.join(os.path.dirname(__file__), "data")
KEYS = ("frames_device", "corrupt_chunks", "unsupported_pictures")
W, H = 96, 64
IDR3 = CORPUS_FIXTURE
FIXTURES = SESSION_FIXTURES
# oracle-made streams at 96x64: the templates of
# tests/test_session_fast_inter.py, and a High-profile CABAC B stream
ORACLE_STREAMS = {
    "ippp": dict(qp=26, gop=6),
    "multi_gop": dict(qp=28, gop=3),
    "static": dict(qp=30, gop=5),
    "high_cabac_b": dict(qp=28, gop=6, profile="high",
                         extra="cabac=1:8x8dct=1:bframes=2"),
}


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    """The dropped pictures of the fault cases log a warning each."""
    levels = logger.level, jax_logger.level
    logger.setLevel(logging.ERROR)
    jax_logger.setLevel(logging.ERROR)
    yield
    logger.setLevel(levels[0])
    jax_logger.setLevel(levels[1])


def _stream(name):
    with open(os.path.join(DATA, name + ".h264"), "rb") as f:
        return f.read()


def _digests(name):
    with open(os.path.join(DATA, name + ".sha256.json")) as f:
        return json.load(f)["frames"]


def _oracle_stream(kind):
    kw = dict(ORACLE_STREAMS[kind])
    if kind == "static":
        frames = moving_frames(W, H, 1)[:1] * 5
    else:
        frames = moving_frames(W, H, 6, step=(3, 5))
    return oracle_encode(frames, W, H, **kw)


def _port():
    return DecoderSession(device="cpu")


def _drive(session, cnt, stream, step=999):
    """Feed stream in chunks of step bytes with backpressure, as the
    reference's read loop does; EOF; pop every frame. Returns (frames,
    counter deltas)."""
    c0 = cnt.snapshot()
    got, pos = [], 0
    while not session.is_exit():
        if session.need_more_data() and pos < len(stream):
            pos += session.input_data(stream[pos:pos + step])
        if pos >= len(stream) and not session._eof:
            session.set_eof()
        fr = session.get_frame()
        if fr is not None:
            got.append(fr)
    c1 = cnt.snapshot()
    return got, {k: c1.get(k, 0) - c0.get(k, 0) for k in KEYS}


def _feed_all(session, cnt, data):
    c0 = cnt.snapshot()
    session.input_data(data)
    session.set_eof()
    got = []
    while (fr := session.get_frame()) is not None:
        got.append(fr)
    c1 = cnt.snapshot()
    return got, {k: c1.get(k, 0) - c0.get(k, 0) for k in KEYS}


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k, a, b in zip("YUV", g, w):
            b = np.asarray(b)
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (i, k)
            assert np.array_equal(a, b), f"frame {i} {k}"
        for fmt in PixFmt:
            assert repack(*g, fmt) == repack(*map(np.asarray, w), fmt)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def _assert_digests(frames, digests):
    assert len(frames) == len(digests)
    for i, (fr, d) in enumerate(zip(frames, digests)):
        assert [_sha(p) for p in fr] == [d[k] for k in "YUV"], f"frame {i}"


# ---------------------------------------------------------------------------
# against jmcodec_tpu's session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FIXTURES) + [
    "h264_inter_veryslow_96x64", "h264_inter_slices3_96x64",
    "h264_96x64_slices3"])
def test_session_matches_jax(name):
    stream = _stream(name)
    step = 777 if name == IDR3 else 999
    got, n = _drive(_port(), counters, stream, step)
    want, jn = _drive(JaxSession(), jax_counters, stream, step)
    _assert_same(got, want)
    assert n == jn


@pytest.mark.skipif(not have_oracle(), reason="oracle unavailable")
@pytest.mark.parametrize("kind", list(ORACLE_STREAMS))
def test_session_matches_jax_oracle_streams(kind):
    stream = _oracle_stream(kind)
    got, n = _drive(_port(), counters, stream, 101)
    want, jn = _drive(JaxSession(), jax_counters, stream, 101)
    _assert_same(got, want)
    assert n == jn
    _assert_same(got, oracle_decode(stream)[0])
    if kind == "high_cabac_b":
        assert n["frames_device"] < len(got)
    else:
        assert n["frames_device"] == len(got)


CORPUS = session_corpus(session_fixture(IDR3)[0])


def test_corpus_is_the_robustness_corpus():
    """session_corpus draws tests/test_robustness.py's flips: its rng,
    inside split_gops's range of picture 2, away from the slice header."""
    s = _stream(IDR3)
    gops = split_gops(s)
    rng = np.random.default_rng(1)
    for got in CORPUS:
        b = bytearray(s)
        pos = int(rng.integers(gops[1][0] + 24, gops[1][1] - 1))
        b[pos] ^= 1 << int(rng.integers(0, 8))
        assert got == bytes(b)


@pytest.mark.parametrize("trial", range(len(CORPUS)))
def test_bitflip_corpus_matches_jax(trial):
    got, n = _feed_all(_port(), counters, CORPUS[trial])
    want, jn = _feed_all(JaxSession(), jax_counters, CORPUS[trial])
    _assert_same(got, want)
    assert n == jn
    # picture 1 always, picture 3 after the resync, both bit-exact
    d = _digests(IDR3)
    assert len(got) in (2, 3)
    _assert_digests([got[0], got[-1]], [d[0], d[2]])


P_CORPUS = [(name, trial, data) for name in P_CORPUS_FIXTURES
            for trial, data in enumerate(session_corpus(_stream(name)))]


@pytest.mark.parametrize("name,trial,data", P_CORPUS,
                         ids=[f"{n}-{t}" for n, t, _ in P_CORPUS])
def test_p_bitflip_corpus_matches_jax(name, trial, data):
    """A flipped P picture either fails its parse and is dropped, or is
    decoded on the device path with the flipped symbols; the pictures
    after it follow the DPB that is left."""
    got, n = _feed_all(_port(), counters, data)
    want, jn = _feed_all(JaxSession(), jax_counters, data)
    _assert_same(got, want)
    assert n == jn
    _assert_digests(got[:1], _digests(name)[:1])
    on_device = trial in P_CORPUS_FIXTURES[name]
    assert n["unsupported_pictures"] == 0
    assert n["corrupt_chunks"] == (0 if on_device else 1)
    assert n["frames_device"] == len(got) == len(_digests(name)) - \
        n["corrupt_chunks"]


def test_truncation_and_resync_match_jax():
    s = _stream(IDR3)
    gops = split_gops(s)
    d = _digests(IDR3)
    # (input, the pictures that come out)
    cases = [(s[:gops[1][0] + 24], [0]), (s[:gops[2][0] + 24], [0, 1]),
             (s[:30], []),
             (s[:gops[1][0]] + s[gops[1][1]:], [0, 2]),      # dropped pic 2
             (b"\x00\x01\x02garbage-without-startcode" + s, [0, 1, 2])]
    for data, good in cases:
        got, n = _feed_all(_port(), counters, data)
        want, jn = _feed_all(JaxSession(), jax_counters, data)
        _assert_same(got, want)
        assert n == jn
        _assert_digests(got, [d[i] for i in good])


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_digests_and_paths(name):
    got, n = _drive(_port(), counters, _stream(name))
    _assert_digests(got, _digests(name))
    n_dev, n_host = FIXTURES[name]
    assert n == {"frames_device": n_dev, "corrupt_chunks": 0,
                 "unsupported_pictures": 0}
    assert len(got) == n_dev + n_host


def test_host_only_session():
    name = "h264_session_b_96x64"
    for kw in (dict(use_device=False), dict(use_native_parser=False)):
        got, n = _drive(DecoderSession(device="cpu", **kw), counters,
                        _stream(name))
        _assert_digests(got, _digests(name))
        assert n["frames_device"] == 0


def test_stream_info_is_exit_and_eof_drain():
    """The B stream: without EOF the last picture stays buffered and the
    host's reorder buffer holds pictures back; set_eof drains both."""
    s = DecoderSession(device="cpu")
    assert s.get_stream_info() is None and not s.is_exit()
    s.input_data(_stream("h264_session_b_96x64"))
    early = []
    while (fr := s.get_frame()) is not None:
        early.append(fr)
    assert 1 <= len(early) < 6 and not s.is_exit()
    assert s.get_stream_info() == (W, H)
    s.set_eof()
    assert not s.is_exit()
    assert s.input_data(b"\x00\x00\x01") == 0 and not s.need_more_data()
    late = []
    while (fr := s.get_frame()) is not None:
        late.append(fr)
    assert s.is_exit()
    _assert_digests(early + late, _digests("h264_session_b_96x64"))
    assert "frames=6" in s.info() and "fps=" in s.info()


def test_backpressure_matches_jax():
    for cls in (_port, JaxSession):
        s = cls()
        assert s.need_more_data() and s.free_buf_len() == INPUT_BUF_SIZE
        assert s.input_data(b"\x00" * (INPUT_BUF_SIZE - NEED_MORE_THRESHOLD)
                            ) == INPUT_BUF_SIZE - NEED_MORE_THRESHOLD
        assert not s.need_more_data()
        assert s.input_data(b"\x00" * (INPUT_BUF_SIZE + 100)) == \
            NEED_MORE_THRESHOLD
        assert s.free_buf_len() == 0 and s.input_data(b"\x00") == 0


def test_output_formats_callback_and_decode_frame():
    stream = _stream(IDR3)
    want, _ = _feed_all(_port(), counters, stream)
    for fmt in PixFmt:
        s = DecoderSession(out_fmt=fmt, device="cpu")
        seen = []
        s.set_yuv_callback(lambda Y, U, V: seen.append(
            (type(Y), Y.shape, U.shape, V.shape)))
        fr, ok = s.decode_frame(stream)
        assert ok
        assert repack(*fr, fmt) == repack(*want[0], fmt)
        fr, ok = s.decode_frame(None)
        assert ok and all(np.array_equal(a, b) for a, b in zip(fr, want[1]))
        raw = s.output_frame()
        assert raw == repack(*want[2], fmt) and len(raw) == W * H * 3 // 2
        assert s.output_frame() is None and s.is_exit()
        assert seen == [(np.ndarray, (H, W), (H // 2, W // 2),
                         (H // 2, W // 2))] * 3


def test_get_frame_device():
    """Device-decoded pictures come back as tensors on the session's
    device, host-decoded ones as numpy arrays."""
    s = DecoderSession(device="cpu")
    s.input_data(_stream("h264_session_b_96x64"))
    s.set_eof()
    frames = []
    while (fr := s.get_frame_device()) is not None:
        frames.append(fr)
    assert [type(fr[0]) for fr in frames] == \
        [torch.Tensor] + [np.ndarray] * 5
    assert frames[0][0].dtype == torch.uint8
    host = [tuple(p.numpy() if isinstance(p, torch.Tensor) else p
                  for p in fr) for fr in frames]
    _assert_digests(host, _digests("h264_session_b_96x64"))


def test_device_decode_error_is_not_routed_to_the_host(monkeypatch):
    """Only the scope tests send a picture to the host decoder: an error
    raised by the device decode itself propagates."""
    from jmcodec_tpu_torch.api import session as S

    def broken(*a, **k):
        raise NotImplementedError("device decode broke")

    monkeypatch.setattr(S.RT, "decode_frame_symbols_inter", broken)
    before = counters.snapshot()
    s = _port()
    with pytest.raises(NotImplementedError, match="device decode broke"):
        s.input_data(_stream("h264_inter_veryslow_96x64"))
        s.set_eof()
    assert s._refdec is None
    after = counters.snapshot()
    assert after.get("frames_device", 0) - before.get("frames_device", 0) \
        == 1
    for k in ("corrupt_chunks", "unsupported_pictures"):
        assert after.get(k, 0) == before.get(k, 0), k


def test_long_h264_stream_holds_its_dpb_only():
    """A P stream repeated: the session keeps no more device pictures than
    the DPB's sliding window, however long the stream (no host picture
    comes to copy them down)."""
    name, reps = "h264_inter_veryslow_96x64", 3
    stream, digests = _stream(name), _digests(name)
    s = DecoderSession(device="cpu")
    got = []
    for _ in range(reps):
        s.input_data(stream)
        while (fr := s.get_frame()) is not None:
            got.append(fr)
        assert 1 <= len(s._pending_mirror) <= 3
        assert 1 <= len(s._dev_dpb.pics) <= 3
    s.set_eof()
    while (fr := s.get_frame()) is not None:
        got.append(fr)
    assert s._refdec is None
    _assert_digests(got, digests * reps)


def test_host_picture_after_a_long_device_run(monkeypatch):
    """The last picture of a repeated P stream sent to the host decoder: it
    reads the device pictures that the trimmed mirror copied down."""
    name, reps = "h264_inter_veryslow_96x64", 2
    digests = _digests(name)
    last = len(digests) * reps
    seen = []
    device_pictures = DecoderSession._device_pictures

    def all_but_last(self, pic):
        seen.append(pic)
        return None if len(seen) == last else device_pictures(self, pic)

    monkeypatch.setattr(DecoderSession, "_device_pictures", all_but_last)
    got, n = _feed_all(_port(), counters, _stream(name) * reps)
    assert n == {"frames_device": last - 1, "corrupt_chunks": 0,
                 "unsupported_pictures": 0}
    _assert_digests(got, digests * reps)


def test_long_hevc_stream_holds_its_dpb_only():
    """An HEVC stream repeated: the decoder hands each frame out once and
    keeps only its DPB."""
    name, reps = "hevc_inter_ref3_64x64", 2
    with open(os.path.join(DATA, name + ".h265"), "rb") as f:
        stream = f.read()
    s = DecoderSession(Codec.HEVC, device="cpu")
    got = []
    for _ in range(reps):
        s.input_data(stream)
        while (fr := s.get_frame()) is not None:
            got.append(fr)
        assert s._refdec._out == [] and len(s._refdec.dpb) <= 5
    s.set_eof()
    while (fr := s.get_frame()) is not None:
        got.append(fr)
    _assert_digests(got, _digests(name) * reps)


@pytest.mark.skipif(not have_oracle(), reason="oracle unavailable")
def test_hevc_session_matches_libavcodec():
    w, h = 128, 64
    frames = [make_frame(w, h, seed=i) for i in range(3)]
    stream = oracle_encode(frames, w, h, qp=30, codec="libx265", gop=1)
    want, _, _ = oracle_decode(stream, suffix=".h265")
    got, n = _drive(DecoderSession(Codec.HEVC, device="cpu"), counters,
                    stream)
    _assert_same(got, want)
    assert n == {"frames_device": 3, "corrupt_chunks": 0,
                 "unsupported_pictures": 0}
    assert len(got) == 3


@pytest.mark.skipif(not have_oracle(), reason="oracle unavailable")
def test_hevc_picture_outside_the_device_path_raises():
    """HEVC pictures outside the device path (the test keeps its name from
    before the host path was ported: nothing raises now) give the frames
    and counts of jmcodec_tpu's session, which compiles no program for
    them: x265's two-slice 128x128 pictures at CTU 64, which break the
    slice syntax (test_x265_two_slice_ctu64_stream_breaks_the_slice_syntax;
    both sessions drop them as corrupt), and transform-skip I pictures
    (both decode them on the host, as libavcodec does). The host-only
    session takes HEVC."""
    w, h = 128, 128
    frames = [make_frame(w, h, seed=i) for i in range(2)]
    slices2 = oracle_encode(frames, w, h, qp=30, codec="libx265", gop=1,
                            extra="slices=2")
    rng = np.random.default_rng(1)
    frames = [((rng.integers(0, 2, (96, 128)) * 255).astype(np.uint8),
               np.full((48, 64), 128, np.uint8),
               np.full((48, 64), 128, np.uint8)) for _ in range(2)]
    tskip = oracle_encode(frames, 128, 96, qp=32, codec="libx265", gop=1,
                          extra="tskip=1:ctu=16")
    for stream, n_want, corrupt in ((slices2, 0, 2), (tskip, 2, 0)):
        got, n = _drive(DecoderSession(Codec.HEVC, device="cpu"), counters,
                        stream)
        want, wn = _drive(JaxSession(Codec.HEVC), jax_counters, stream)
        _assert_same(got, want)
        assert n == wn == {"frames_device": 0, "corrupt_chunks": corrupt,
                           "unsupported_pictures": 0}
        assert len(got) == n_want
    _assert_same(got, oracle_decode(tskip, suffix=".h265")[0])
    got, n = _drive(DecoderSession(Codec.HEVC, use_device=False), counters,
                    tskip)
    _assert_same(got, want)


@pytest.mark.skipif(not have_oracle(), reason="oracle unavailable")
def test_x265_two_slice_ctu64_stream_breaks_the_slice_syntax(monkeypatch):
    """Why the two-slice 128x128 CTU-64 stream above is dropped: x265 puts
    the data of the whole picture into the first slice segment (its
    second one starts at CTB 2 and holds no slice data), and no
    end_of_slice_segment_flag of the first is 1, neither after CTB 1,
    before the second segment's address, nor after the picture's last
    CTB. The port stops with the slice overrunning the picture.
    libavcodec's frames for it are no decode of the source: it stops at
    the picture's end without the flag, and its bottom CTB row is noise
    against the source, where the top row is within the encoder's loss."""
    from jmcodec_tpu_torch.codec.hevc import refdec as RD
    from jmcodec_tpu_torch.codec.hevc.cabac import HevcCabac

    w, h = 128, 128
    src = [make_frame(w, h, seed=i) for i in range(2)]
    stream = oracle_encode(src, w, h, qp=30, codec="libx265", gop=1,
                           extra="slices=2")
    events = []
    terminate = HevcCabac.terminate
    decode_ctu = RD._Picture.decode_ctu
    decode_slice = RD.HevcRefDecoder._decode_slice

    def end_flag(self):
        events.append(("end", terminate(self)))
        return events[-1][1]

    def ctu(self, c, xc, yc):
        events.append(("ctb", yc * self.ctb_w + xc))
        return decode_ctu(self, c, xc, yc)

    def slice_(self, pic, hdr, rbsp, emu):
        """the segment's address and bytes of slice data; an overrun
        ends the segment, so that the next one is read too"""
        events.append(("segment", hdr.segment_address,
                       len(rbsp) - hdr.data_bitpos // 8))
        try:
            decode_slice(self, pic, hdr, rbsp, emu)
        except ValueError as e:
            events.append(("error", str(e)))
            pic.cur_slice += 1

    monkeypatch.setattr(HevcCabac, "terminate", end_flag)
    monkeypatch.setattr(RD._Picture, "decode_ctu", ctu)
    with pytest.raises(ValueError, match="overruns"):
        RD.HevcRefDecoder().decode(stream)
    assert events == [("ctb", 0), ("end", 0), ("ctb", 1), ("end", 0),
                      ("ctb", 2), ("end", 0), ("ctb", 3), ("end", 0)]
    events.clear()
    monkeypatch.setattr(RD.HevcRefDecoder, "_decode_slice", slice_)
    RD.HevcRefDecoder().decode(stream)
    assert [(e[1], e[2] > 0) for e in events if e[0] == "segment"] == \
        [(0, True), (2, False)] * 2

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b) ** 2)
        return 10 * np.log10(255 ** 2 / mse)

    want, _, _ = oracle_decode(stream, suffix=".h265")
    assert len(want) == 2
    for (y, _, _), (sy, _, _) in zip(want, src):
        assert psnr(y[:64], sy[:64]) > 30
        assert psnr(y[64:], sy[64:]) < 15


def test_session_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert not DecoderSession.is_hw_support()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderSession(Codec.HEVC)


def test_failed_native_build_raises(monkeypatch):
    def broken():
        raise RuntimeError("native parser build failed")

    monkeypatch.setattr(native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        DecoderSession(device="cpu")
