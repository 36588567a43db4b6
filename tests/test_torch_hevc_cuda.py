"""On an NVIDIA GPU: the hevc_walk CUDA kernel equals walk_reference bit
for bit at the 1080p slice's shapes, on the usual and the hard synthetic
states, for one lane and for odd lane counts, and the port's decode on the
card (through the scan kernel, whose CTBs the walk's device code walks)
equals the CPU decode. Marked `cuda`; skips without a card. Imports no jax,
so it runs where jax is absent:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_hevc_cuda.py -m cuda
"""

import os

import pytest
import torch

from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import synth_state, synth_state_hard

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# (C, max_tu, is_chroma, strong, lanes, skew): CTU 64 and CTU 32 decodes,
# one lane, odd lane counts, and the smallest geometries
@pytest.mark.parametrize("gen", [synth_state, synth_state_hard],
                         ids=["usual", "hard"])
@pytest.mark.parametrize("C,max_tu,chroma,strong,B,skew",
                         [(64, 32, False, True, 272, 2),
                          (32, 16, True, False, 544, 2),
                          (32, 32, False, True, 9, 3),
                          (16, 16, True, False, 18, 3),
                          (64, 32, False, True, 1, 2),
                          (64, 32, False, True, 275, 2),
                          (32, 16, True, False, 7, 2),
                          (8, 8, True, False, 5, 3),
                          (8, 4, False, False, 6, 3)],
                         ids=["luma64", "chroma32", "luma32", "chroma16",
                              "luma64_one_lane", "luma64_odd", "chroma32_odd",
                              "chroma8", "luma8_tu4"])
def test_kernel_matches_reference(dev, gen, C, max_tu, chroma, strong, B,
                                  skew):
    st = gen(C, max_tu, B, seed=11, skew=skew)
    args = [torch.from_numpy(a).to(dev) for a in st]
    kw = dict(C=C, max_tu=max_tu, is_chroma=chroma, strong=strong)
    before = HW.LAUNCHES
    got = HW.walk(*args, **kw)
    assert HW.LAUNCHES == before + 1
    want = HW.walk_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["hevc_128x96_ctu32.h265",
                                  "hevc_168x80.h265"])
def test_decode_on_card_matches_cpu(dev, name):
    plans = parse_hevc_intra_plans(open(os.path.join(DATA, name),
                                        "rb").read())
    want = PT.decode_plans_batch(plans, "cpu")
    before = (HSC.LAUNCHES, HW.LAUNCHES)
    got = PT.decode_plans_batch(plans, dev)
    torch.cuda.synchronize()
    # the walk runs inside the scan kernel: one launch a scan
    assert (HSC.LAUNCHES, HW.LAUNCHES) == (before[0] + 2, before[1])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
