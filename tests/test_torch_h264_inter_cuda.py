"""On an NVIDIA GPU: the port's H.264 P-picture decode (decode_h264 on the
card, the CUDA dequant_idct kernel under it, twice a picture) equals the
libavcodec digests of the committed small P streams and of the 1080p P
fixture, and a P picture decoded with the kernel equals the same picture
decoded with dequant_idct_reference. Marked `cuda`; skips without a card.
Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_h264_inter_cuda.py -m cuda
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api.h264_inter import (DeviceDPB, decode_h264,
                                              decode_symbols, parse_h264)
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.tools.fixtures import (H264_INTER_DIGESTS,
                                              fixture_digests,
                                              h264_inter_fixture_stream)

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")
STREAMS = ["h264_inter_p_64x64", "h264_inter_cabac_wp_64x64",
           "h264_inter_veryslow_96x64", "h264_inter_static_64x48",
           "h264_inter_slices3_96x64", "h264_inter_idr2_64x64",
           "h264_inter_72x40"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _assert_digests(frames, digests, dev):
    assert len(frames) == len(digests)
    for i, (frame, want) in enumerate(zip(frames, digests)):
        for plane, a in zip("YUV", frame):
            assert a.device == dev and a.dtype == torch.uint8
            h = hashlib.sha256(np.ascontiguousarray(a.cpu().numpy()))
            assert h.hexdigest() == want[plane], f"frame {i} {plane}"


@pytest.mark.parametrize("name", STREAMS)
def test_stream_on_card_matches_digests(dev, name):
    s = open(os.path.join(DATA, name + ".h264"), "rb").read()
    meta = json.load(open(os.path.join(DATA, name + ".sha256.json")))
    before = ID.LAUNCHES
    frames = decode_h264(s, dev)
    torch.cuda.synchronize()
    assert ID.LAUNCHES - before == 2 * len(frames)
    _assert_digests(frames, meta["frames"], dev)


def test_p_picture_kernel_matches_reference_decode(dev):
    """A P picture with explicit weights and duplicate references: the
    decode through the kernel equals the decode through
    dequant_idct_reference."""
    pics = list(parse_h264(open(os.path.join(
        DATA, "h264_inter_cabac_wp_64x64.h264"), "rb").read()))
    dpb = DeviceDPB()
    decode_symbols(pics[:2], dev, dpb=dpb)
    fs = pics[2][0]
    refs, ids = dpb.list0(fs)
    assert fs.wp is not None and len(set(ids)) < len(ids)
    got = RT.decode_frame_symbols_inter(fs, refs, ref_ids=ids)
    want = RT.decode_frame_symbols_inter(
        fs, refs, ref_ids=ids, residual_fn=ID.dequant_idct_reference)
    for g, w in zip(got, want):
        assert g.device == dev and torch.equal(g, w)


def test_1080p_fixture_on_card_matches_digests(dev):
    before = ID.LAUNCHES
    frames = decode_h264(h264_inter_fixture_stream())
    torch.cuda.synchronize()
    assert ID.LAUNCHES - before == 10
    _assert_digests(frames, fixture_digests(H264_INTER_DIGESTS), dev)
