"""On an NVIDIA GPU: the port's H.264 device encoder on the card gives the
bytes and the reconstruction of the same encoder on the CPU (held to
jmcodec_tpu's by tests/test_torch_encode.py), frame by frame, with the
CUDA dequant_idct kernel launched twice per P frame (luma, both chroma
planes) and the reference chain on the card; encode_p_frame's outputs on
the card equal the CPU's on moving, static and flat content; and the
EncoderSession with no device argument (the card) gives the packets and
keyframe flags of the CPU session, with rate control over a GOP that
crosses an IDR. Marked `cuda`; skips without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_encode_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api.session import EncoderParams, EncoderSession
from jmcodec_tpu_torch.codec.h264.devenc import DeviceH264Encoder
from jmcodec_tpu_torch.codec.h264.refenc import EncoderConfig
from jmcodec_tpu_torch.kernels import encode_tiles as ET
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.ops import transform as T
from jmcodec_tpu_torch.tools.fixtures import ENCODE_SESSIONS, pan_frames

pytestmark = pytest.mark.cuda

# (W, H, qp, gop, frames, pan step), as tests/test_torch_encode.py's
CASES = {"64x64_qp28_gop3": (64, 64, 28, 3, 4, (3, 2)),
         "96x64_qp20_gop2": (96, 64, 20, 2, 4, (3, 2)),
         "96x64_qp36_gop8": (96, 64, 36, 8, 3, (3, 2)),
         "64x64_static_qp28": (64, 64, 28, 8, 3, (0, 0))}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def encode(frames, W, H, qp, gop, device):
    """(stream, per-frame cropped recon, dequant_idct launches per
    frame, the encoder)."""
    enc = DeviceH264Encoder(EncoderConfig(W, H, qp=qp, gop_len=gop),
                            device)
    out, recons, launches = [enc.headers_annexb()], [], []
    for f in frames:
        n0 = ID.LAUNCHES
        out.append(enc.encode_frame(*f))
        launches.append(ID.LAUNCHES - n0)
        recons.append(tuple(np.array(p) for p in enc.recon_cropped()))
    return b"".join(out), recons, launches, enc


def session_packets(kw, n, device=None):
    sess = EncoderSession(EncoderParams(**kw), device=device)
    packets = []
    for f in pan_frames(kw["width"], kw["height"], n):
        sess.encode_frame(f)
        while (p := sess.output_bitstream()) is not None:
            packets.append(p)
    sess.set_eof()
    while (p := sess.output_bitstream()) is not None:
        packets.append(p)
    return packets, sess


@pytest.mark.parametrize("case", list(CASES))
def test_device_encoder_on_the_card_equals_the_cpu(dev, case):
    W, H, qp, gop, n, step = CASES[case]
    frames = pan_frames(W, H, n, step)
    want, want_rec, cpu_launches, _ = encode(frames, W, H, qp, gop, "cpu")
    assert not any(cpu_launches)
    got, rec, launches, enc = encode(frames, W, H, qp, gop, None)
    assert got == want
    for i, (a, b) in enumerate(zip(want_rec, rec)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), i
    assert launches == [0 if i % gop == 0 else 2 for i in range(n)]
    assert all(p.device.type == "cuda" for p in enc._dev_ref)


@pytest.mark.parametrize("kind", ["moving", "static", "flat"])
def test_encode_p_frame_on_the_card_equals_the_cpu(dev, kind):
    W, H = 96, 64
    if kind == "moving":
        ref, cur = pan_frames(W, H, 2)
    elif kind == "static":
        ref = cur = pan_frames(W, H, 1)[0]
    else:   # flat luma: every full-pel candidate ties
        ref, cur = [(np.full_like(Y, 128), U, V)
                    for Y, U, V in pan_frames(W, H, 2)]
    for rng in (8, 16):
        for qp in (0, 28, 51):
            qpc = int(T.chroma_qp(qp, 0))
            lam = max(1, 1 << max(0, (qp - 12) // 6))
            outs = []
            for d in ("cpu", dev):
                refs = RT.pad_ref_device(*(torch.from_numpy(p).to(d)
                                           for p in ref))
                outs.append(ET.encode_p_frame(
                    rng, *(torch.from_numpy(p.astype(np.int32)).to(d)
                           for p in cur), *refs, qp, qpc, qpc, lam))
            for a, b in zip(*outs):
                assert b.device.type == "cuda" and b.dtype == a.dtype
                assert torch.equal(a, b.cpu()), (rng, qp)


@pytest.mark.parametrize("name", list(ENCODE_SESSIONS))
def test_session_on_the_card_equals_the_cpu(dev, name):
    kw, n = ENCODE_SESSIONS[name]
    want, _ = session_packets(kw, n, "cpu")
    n0 = ID.LAUNCHES
    got, sess = session_packets(kw, n)
    assert isinstance(sess._enc, DeviceH264Encoder)
    assert sess._enc.device.type == "cuda"
    assert got == want
    keys = [k for _, k in got]
    assert keys == [i % kw["gop_len"] == 0 for i in range(n)]
    assert ID.LAUNCHES - n0 == 2 * (n - sum(keys))
