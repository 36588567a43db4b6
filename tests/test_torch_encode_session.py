"""The port's EncoderSession on the CPU against jmcodec_tpu's, at tolerance
0: the same frames in give the same packets, keyframe flags and SPS/PPS,
in CQP, CBR and VBR, from I420, YV12, NV12 bytes and plane tuples, with B
groups flushed at the end, and for HEVC. The H.264 device engine runs
with device="cpu" on the port's side and engine="device" on jmcodec_tpu's
CPU backend on the other. The rate controller's QP decisions equal
jmcodec_tpu's over a seeded run. The port alone: libavcodec's decode of a
device-engine stream equals the encoder's recon; EncoderSession() raises
without a card (no fallback to the host engine); the host engine and HEVC
touch no CUDA state; backpressure at MAX_QUEUED.
"""

import numpy as np
import pytest
import torch

from jmcodec_tpu.api.session import Codec as JCodec
from jmcodec_tpu.api.session import EncoderParams as JParams
from jmcodec_tpu.api.session import EncoderSession as JSession
from jmcodec_tpu.api.session import PixFmt as JPixFmt
from jmcodec_tpu.pipeline import ratecontrol as JRC
from jmcodec_tpu_torch.api.session import (Codec, EncoderParams,
                                           EncoderSession, PixFmt, repack)
from jmcodec_tpu_torch.codec.h264 import devenc as DEV
from jmcodec_tpu_torch.codec.h264.refenc import H264ReferenceEncoder
from jmcodec_tpu_torch.pipeline import ratecontrol as RC

from test_inter_decode import moving_frames
from util_oracle import have_oracle, make_frame, oracle_decode

W, H = 96, 64
# name -> (EncoderParams keywords, input format (None: plane tuples),
# frames): every H.264 case at 96x64, so jmcodec_tpu compiles its device
# encoder once
CASES = {
    "cqp_i420_device": (dict(qp=28, gop_len=3, engine="device"), "I420", 4),
    "vbr_yv12_device": (dict(bitrate_kb=300, gop_len=3, engine="device"),
                        "YV12", 5),
    "cbr_nv12_device": (dict(bitrate_kb=200, gop_len=8, rc_mode="cbr",
                             engine="device"), "NV12", 4),
    "vbr_tuple_auto": (dict(bitrate_kb=400, gop_len=30), None, 3),
    "cbr_host": (dict(bitrate_kb=250, gop_len=4, rc_mode="cbr",
                      engine="host"), "I420", 5),
    "bframes_flush": (dict(qp=30, gop_len=8, num_bframe=2,
                           engine="device"), "I420", 5),
    "hevc_vbr": (dict(bitrate_kb=300, gop_len=3, codec="HEVC"), "I420", 4),
    "hevc_cqp_nv12": (dict(qp=32, gop_len=8, codec="HEVC"), "NV12", 3),
}


def _params(mod_params, mod_codec, kw):
    kw = dict(kw)
    if "codec" in kw:
        kw["codec"] = getattr(mod_codec, kw["codec"])
    if mod_params is JParams and kw.get("engine", "auto") == "auto":
        # jmcodec_tpu's "auto" is its host engine on the CPU backend; the
        # port's is the device engine
        kw["engine"] = "device"
    return mod_params(width=W, height=H, fps=30, **kw)


def _drain(sess, out):
    while (p := sess.output_bitstream()) is not None:
        out.append(p)


def _encode(sess, frames, fmt, pixfmt):
    packets = []
    for Y, U, V in frames:
        if fmt is None:
            sess.encode_frame((Y, U, V))
        else:
            f = getattr(pixfmt, fmt)
            sess.encode_frame(repack(Y, U, V, PixFmt[fmt]), f)
        _drain(sess, packets)
    assert not sess.is_exit()
    sess.set_eof()
    _drain(sess, packets)
    assert sess.is_exit() and not sess.more_data()
    return packets


@pytest.mark.parametrize("case", list(CASES))
def test_session_matches_jax(case):
    kw, fmt, n = CASES[case]
    frames = moving_frames(W, H, n)
    js = JSession(_params(JParams, JCodec, kw))
    ps = EncoderSession(_params(EncoderParams, Codec, kw), device="cpu")
    want = _encode(js, frames, fmt, JPixFmt)
    got = _encode(ps, frames, fmt, PixFmt)
    assert [k for _, k in got] == [k for _, k in want]
    assert [len(b) for b, _ in got] == [len(b) for b, _ in want]
    assert got == want
    assert ps.get_spspps() == js.get_spspps()
    assert ps.params.effective_qp() == js.params.effective_qp()
    h264 = kw.get("codec") is None
    on_device = h264 and not kw.get("num_bframe") \
        and kw.get("engine", "auto") != "host"
    assert isinstance(ps._enc, DEV.DeviceH264Encoder) == on_device
    if h264:
        assert isinstance(ps._enc, H264ReferenceEncoder)


@pytest.mark.skipif(not have_oracle(), reason="libavcodec oracle unavailable")
def test_device_engine_stream_decodes_to_its_recon():
    """CBR over a GOP of 3 (an IDR in mid-stream): libavcodec's decode of
    the session's packets equals the encoder's reconstruction."""
    sess = EncoderSession(EncoderParams(width=W, height=H, bitrate_kb=300,
                                        gop_len=3, rc_mode="cbr"),
                          device="cpu")
    stream, recons = b"", []
    for fr in moving_frames(W, H, 5):
        sess.encode_frame(fr)
        recons.append(sess._enc.recon_cropped())
        while (p := sess.output_bitstream()) is not None:
            stream += p[0]
    want, w, h = oracle_decode(stream)
    assert (w, h) == (W, H) and len(want) == len(recons)
    for i, (a, b) in enumerate(zip(want, recons)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), i


def test_session_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncoderSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncoderSession(EncoderParams(width=64, height=64, engine="device"))


def test_host_engine_and_hevc_touch_no_cuda_state(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("CUDA state touched")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(DEV, "require_cuda", no_cuda)
    frames = moving_frames(32, 32, 3)
    for kw in (dict(engine="host"), dict(codec=Codec.HEVC),
               dict(num_bframe=1)):
        sess = EncoderSession(EncoderParams(width=32, height=32, qp=30,
                                            gop_len=2, **kw))
        packets = _encode(sess, frames, "I420", PixFmt)
        assert packets and packets[0][1]


def test_backpressure_at_max_queued():
    sess = EncoderSession(EncoderParams(width=16, height=16, qp=30,
                                        gop_len=1, engine="host"))
    frame = make_frame(16, 16)
    for i in range(EncoderSession.MAX_QUEUED):
        assert sess.more_data(), i
        sess.encode_frame(frame)
    assert not sess.more_data()
    assert sess.output_bitstream()[1]
    assert sess.more_data()


@pytest.mark.parametrize("mode", ["cbr", "vbr"])
def test_rate_controller_matches_jax(mode):
    rng = np.random.default_rng(8)
    cfgs = [mod.RateControlConfig(bitrate_kbps=800, fps=25.0, mode=mode,
                                  gop_len=10, init_qp=32)
            for mod in (JRC, RC)]
    rcs = [JRC.RateController(cfgs[0]), RC.RateController(cfgs[1])]
    for i in range(120):
        kind = "I" if i % 10 == 0 else "P"
        qps = [rc.frame_qp(kind) for rc in rcs]
        assert qps[0] == qps[1], i
        bits = int(rng.integers(5_000, 120_000) * (3 if kind == "I" else 1))
        for rc in rcs:
            rc.update(kind, qps[0], bits)
    assert rcs[0].achieved_kbps() == rcs[1].achieved_kbps()
    for q in (10.0, 23.5, 51.0):
        assert RC.qscale_of(q) == JRC.qscale_of(q)
        assert RC.qp_of(RC.qscale_of(q)) == JRC.qp_of(JRC.qscale_of(q))
