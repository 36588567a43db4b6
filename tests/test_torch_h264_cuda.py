"""On an NVIDIA GPU: the dequant_idct CUDA kernel equals
dequant_idct_reference bit for bit, and the port's H.264 decode on the card
equals its CPU decode. Marked `cuda`; skips without a card. Imports no jax,
so it runs where jax is absent:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_h264_cuda.py -m cuda
"""

import os

import pytest
import torch

from jmcodec_tpu_torch.api.h264_intra import decode_h264_intra
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.tools.fixtures import synth_idct_blocks

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("N", [1, 127, 700, 100_003])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("splice", ["none", "masked", "every"])
def test_kernel_matches_reference(dev, N, dtype, splice):
    c, qp, dc, mask = (torch.from_numpy(a).to(dev)
                       for a in synth_idct_blocks(N, seed=N))
    extra = {"none": (), "masked": (dc, mask), "every": (dc,)}[splice]
    before = ID.LAUNCHES
    got = ID.dequant_idct_blocks(c.to(dtype), qp, *extra)
    assert ID.LAUNCHES == before + 1
    want = ID.dequant_idct_reference(c.to(dtype), qp, *extra)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_kernel_takes_a_uint8_mask_and_rejects_misuse(dev):
    c, qp, dc, mask = (torch.from_numpy(a).to(dev)
                       for a in synth_idct_blocks(64, seed=3))
    a = ID.dequant_idct_blocks(c, qp, dc, mask)
    b = ID.dequant_idct_blocks(c, qp, dc, mask.to(torch.uint8))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ID.dequant_idct_blocks(c, qp.cpu())
    with pytest.raises(ValueError, match="shape"):
        ID.dequant_idct_blocks(c, qp, dc[:60].contiguous())
    off8 = c.reshape(-1)[4:4 + 63 * 16].reshape(63, 4, 4)   # 8 bytes in
    with pytest.raises(ValueError, match="aligned"):
        ID.dequant_idct_blocks(off8, qp[:63].contiguous())


@pytest.mark.parametrize("name", ["h264_80x64.h264",
                                  "h264_96x64_slices3.h264"])
def test_decode_on_card_matches_cpu(dev, name):
    s = open(os.path.join(DATA, name), "rb").read()
    want = decode_h264_intra(s, "cpu")
    before = ID.LAUNCHES
    got = decode_h264_intra(s)          # no device named: the card
    torch.cuda.synchronize()
    assert ID.LAUNCHES == before + 2
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
