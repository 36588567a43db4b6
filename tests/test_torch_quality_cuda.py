"""On an NVIDIA GPU: `jmx_quality --engine device` on the card against the
same tool with --device cpu. The streams of its QP sweep at the default
size, GOP and QPs (4 frames) equal the committed SHA-256 of the CPU's
(tests/data/quality_320x240.sha256.json, held to the CPU by
tests/test_torch_quality.py), with the CUDA dequant_idct kernel launched
twice a P frame; where the libavcodec oracle is built, the whole tool's
JSON line on the card equals the CPU's but for "device". Marked `cuda`;
skips without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_quality_cuda.py -m cuda
"""

import hashlib

import pytest
import torch

from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.tools import jmx_quality as Q
from jmcodec_tpu_torch.tools import oracle
from jmcodec_tpu_torch.tools.fixtures import quality_fixture, quality_streams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_streams_on_the_card_equal_the_cpus(dev):
    fx = quality_fixture()
    n0 = ID.LAUNCHES
    streams = quality_streams(fx, dev)
    n_p = sum(1 for i in range(fx["frames"]) if i % fx["gop"])
    assert ID.LAUNCHES - n0 == 2 * n_p * len(fx["qps"])
    for qp, s in streams.items():
        assert {"sha256": hashlib.sha256(s).hexdigest(),
                "length": len(s)} == fx["streams"][str(qp)], qp


def test_tool_on_the_card_equals_the_tool_on_the_cpu(dev):
    if not oracle.have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    fx = quality_fixture()
    argv = ["--size", fx["size"], "--frames", str(fx["frames"]), "--gop",
            str(fx["gop"]), "--engine", "device"]
    card = Q.main(argv)
    cpu = Q.main(argv + ["--device", "cpu"])
    assert card.pop("device") == torch.cuda.get_device_name(dev)
    assert cpu.pop("device") == "cpu"
    assert card == cpu
