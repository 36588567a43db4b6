"""The port's quality tool (jmcodec_tpu_torch/tools/jmx_quality.py) on the
CPU against the JAX package's tools/jmx_quality.py, exactly: PSNR, YUV
PSNR and BD-rate on seeded inputs; the QP sweep's rows and BD-rate with
the host engine (the whole tool, its JSON line); the port's device engine
(device="cpu") against the JAX tool's engine="device" (the JAX tool's
"auto" is its host engine on a CPU backend); the bitrate-matched mode.
The streams of `jmx_quality --engine device --frames 4` at the default
size, GOP and QPs equal the committed digests (tests/data/
quality_320x240.sha256.json); without the oracle the tool raises, and
without a card so does its device engine unless --device cpu is given.
The tests that encode with x264 or decode skip where the oracle is
absent.

Run as a script, this file rebuilds tests/data/quality_320x240.sha256.json
from the port's device engine on the CPU (~20 s):

    PYTHONPATH=. python tests/test_torch_quality.py
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from jmcodec_tpu_torch.tools import jmx_quality as Q  # noqa: E402
from jmcodec_tpu_torch.tools import oracle  # noqa: E402
from jmcodec_tpu_torch.tools.fixtures import (QUALITY_DIGESTS,  # noqa: E402
                                              quality_fixture,
                                              quality_streams)

needs_oracle = pytest.mark.skipif(not oracle.have_oracle(),
                                  reason="libavcodec oracle unavailable")
# the small QP sweep of the tests: 64x48, 3 frames, GOP 3
W, H, N, GOP = 64, 48, 3, 3
# jmx_quality's default --qps
QPS = [22, 27, 32, 37]


@pytest.fixture(scope="module")
def jq():
    """tools/jmx_quality.py, the JAX package's tool, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_jmx_quality", os.path.join(ROOT, "tools", "jmx_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_frame_equals_util_oracles():
    from util_oracle import make_frame
    for W_, H_, seed in ((64, 48, 0), (384, 304, 3), (34, 18, 11)):
        want = make_frame(W_, H_, seed=seed)
        got = oracle.make_frame(W_, H_, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.uint8
            assert np.array_equal(a, b)


def test_psnr_and_bd_rate_equal_the_jax_tools(jq):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, a.shape), 0, 255)
    assert Q.psnr(a, b) == jq.psnr(a, b)
    assert Q.psnr(a, a) == jq.psnr(a, a) == float("inf")
    frames = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                    for s in ((48, 64), (24, 32), (24, 32))) for _ in range(3)]
    dec = [tuple(np.clip(p.astype(np.int32) + rng.integers(-5, 6, p.shape),
                         0, 255) for p in f) for f in frames]
    assert Q.yuv_psnr(dec, frames) == jq.yuv_psnr(dec, frames)
    for _ in range(4):
        r1 = np.sort(rng.uniform(1e4, 1e6, 4))
        r2 = np.sort(rng.uniform(1e4, 1e6, 4))
        p1 = np.sort(rng.uniform(28, 44, 4))
        p2 = np.sort(rng.uniform(28, 44, 4))
        assert Q.bd_rate(r1, p1, r2, p2) == jq.bd_rate(r1, p1, r2, p2)
    # curves that do not overlap in PSNR
    assert np.isnan(Q.bd_rate(r1, [1, 2, 3, 4], r2, [5, 6, 7, 8]))


def _run_main(main, argv, out):
    saved = sys.argv
    sys.argv = ["jmx_quality"] + argv + ["--out", str(out)]
    try:
        main()
    finally:
        sys.argv = saved
    with open(out) as f:
        return json.load(f)


@needs_oracle
def test_qp_sweep_host_engine_equals_the_jax_tool(jq, tmp_path):
    argv = ["--size", f"{W}x{H}", "--frames", str(N), "--gop", str(GOP)]
    want = _run_main(jq.main, argv, tmp_path / "jax.json")
    got = _run_main(Q.main, argv, tmp_path / "port.json")
    assert got.pop("device") is None
    assert got == want
    assert len(got["points"]) == 4 and got["bd_rate_vs_x264_pct"] is not None


@needs_oracle
def test_device_engine_on_the_cpu_equals_the_jax_device_engine(jq):
    frames = Q.moving(W, H, N)
    want = jq.run_point(frames, W, H, 27, GOP, "device")
    assert Q.run_point(frames, W, H, 27, GOP, "device", "cpu") == want


@needs_oracle
def test_bitrate_matched_equals_the_jax_tool(jq):
    frames = Q.moving(W, H, N)
    want = jq.run_bitrate_matched(frames, W, H, 200, 30, GOP, "host")
    got = Q.run_bitrate_matched(frames, W, H, 200, 30, GOP, "host")
    assert got == want


@pytest.mark.parametrize("qp", QPS)
def test_device_engine_streams_equal_the_committed_digests(qp):
    fx = quality_fixture()
    stream = quality_streams(dict(fx, qps=[qp]), "cpu")[qp]
    assert {"sha256": hashlib.sha256(stream).hexdigest(),
            "length": len(stream)} == fx["streams"][str(qp)]


def test_without_the_oracle_the_tool_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(oracle, "ORACLE_DIR", str(tmp_path))
    monkeypatch.setattr(oracle, "ORACLE_BIN", str(tmp_path / "oracle"))
    with pytest.raises(RuntimeError, match="oracle"):
        Q.run_point(Q.moving(W, H, 1), W, H, 30, 1, "host")
    with pytest.raises(RuntimeError, match="oracle"):
        Q.main(["--size", f"{W}x{H}", "--frames", "1"])


def test_device_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("device", "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Q.main(["--engine", engine])
        with pytest.raises(RuntimeError, match="CUDA"):
            Q.our_stream(Q.moving(W, H, 1), W, H, 30, 1, engine)


def _rebuild():
    fx = {"tool": "python -m jmcodec_tpu_torch.tools.jmx_quality "
                  "--engine device --frames 4 --device cpu",
          "size": "320x240", "frames": 4, "gop": 8, "qps": QPS,
          "recipe": "PYTHONPATH=. python tests/test_torch_quality.py"}
    fx["streams"] = {str(qp): {"sha256": hashlib.sha256(s).hexdigest(),
                               "length": len(s)}
                     for qp, s in quality_streams(fx, "cpu").items()}
    with open(QUALITY_DIGESTS, "w") as f:
        json.dump(fx, f, indent=1)
        f.write("\n")
    print(json.dumps(fx["streams"]))


if __name__ == "__main__":
    _rebuild()
