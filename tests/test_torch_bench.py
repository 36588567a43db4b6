"""The port's bench (jmcodec_tpu_torch/tools/bench.py) on the CPU: each of
its six figure functions on a small committed fixture with device="cpu"
gives a rate above 0 and planes equal to the fixture's libavcodec digests
(the encode: its stream decoded by the port equals the encoder's
reconstruction); the JSON line has exactly the reference's keys that
keep their meaning, plus "card" and "kernel_launches", and no TPU
constant; a plane that differs from its digest raises; without a card the
bench raises. No device figure comes from here: on the CPU the counts of
CUDA kernel launches stay 0.
"""

import json

import pytest
import torch

from jmcodec_tpu_torch.tools import bench as B
from jmcodec_tpu_torch.tools.fixtures import (fixture_batch_stream,
                                              pan_frames, session_fixture)

# figure -> (function, fixture, extension, frames it decodes or encodes)
FIGURES = {
    "hevc": (B.bench_hevc, "hevc_ctu16_64x64", ".h265", 4),
    "h264": (B.bench_h264, "h264_session_idr3_96x64", ".h264", 3),
    "h264_inter": (B.bench_h264_inter, "h264_inter_cabac_wp_64x64", ".h264",
                   5),
    "cabac": (B.bench_h264_cabac_session, "h264_inter_cabac_wp_64x64",
              ".h264", 5),
    "hevc_inter": (B.bench_hevc_inter_session, "hevc_inter_p_64x64", ".h265",
                   6),
}
# the reference's keys that the port's line keeps, and the port's two
KEYS = {"metric", "value", "unit", "vs_baseline", "device_compute_fps",
        "bit_exact", "h264_1080p_intra_fps", "h264_device_compute_fps",
        "h264_1080p_inter_fps", "h264_1080p_cabac_session_fps",
        "h264_cabac_on_device_path", "hevc_1080p_inter_session_fps",
        "session_stage_ms", "h264_1080p_encode_fps", "device_mpix_per_s",
        "platform", "card", "kernel_launches"}


@pytest.fixture(scope="module")
def figures():
    out = {}
    for name, (fn, fixture, ext, _) in FIGURES.items():
        stream, digests = session_fixture(fixture, ext)
        out[name] = fn(stream, digests, "cpu", reps=1)
    # IDR and first P as the warm-up, two P frames timed
    out["encode"] = B.bench_encode(pan_frames(64, 48, 4), "cpu", reps=1)
    return out


@pytest.mark.parametrize("name", list(FIGURES) + ["encode"])
def test_figure_on_the_cpu(figures, name):
    fig = figures[name]
    assert fig["fps"] > 0 and fig["bit_exact"] is True
    assert fig["launches"] == {"hevc_walk": 0, "hevc_scan": 0,
                               "hevc_resid": 0, "dequant_idct": 0,
                               "h264_intra": 0,
                               "h264_deblock": 0}
    if name == "encode":
        # the two warm-up frames, then the two timed ones once
        assert fig["frames"] == 4 and fig["pixels"] == 64 * 48
    else:
        assert fig["frames"] == FIGURES[name][3]
    if name in ("hevc", "h264"):
        assert fig["device_fps"] > 0
    if name in ("cabac", "hevc_inter"):
        assert fig["on_device"] is True
        assert "device_recon" in fig["stages"]


def test_bench_line_keys(figures):
    line = B.bench_line(figures["hevc"], figures["h264"],
                        figures["h264_inter"], figures["cabac"],
                        figures["hevc_inter"], figures["encode"], None, "cpu")
    assert set(line) == KEYS
    assert line["bit_exact"] is True and line["platform"] == "cpu"
    assert line["value"] == figures["hevc"]["fps"]
    assert line["vs_baseline"] == figures["hevc"]["fps"] / 60.0
    assert line["h264_1080p_encode_fps"] == figures["encode"]["fps"]
    assert set(line["kernel_launches"]) == {
        "hevc_1080p_intra", "h264_1080p_intra", "h264_1080p_inter",
        "h264_1080p_cabac_session", "hevc_1080p_inter_session",
        "h264_1080p_encode"}
    # nothing of the reference's TPU roofline and note (819e9 B/s HBM,
    # "tunneled TPU", "2 cores"): the keys above leave them out, and no
    # text of the line names a TPU
    text = json.dumps(line).lower()
    for tpu in ("roofline", "note", "tpu", "tunnel", "cores"):
        assert tpu not in text


def test_a_plane_off_its_digest_raises():
    stream, digests = session_fixture("hevc_ctu16_64x64", ".h265")
    bad = [dict(d) for d in digests]
    bad[2]["U"] = "0" * 64
    with pytest.raises(RuntimeError, match="frame 2 U"):
        B.bench_hevc(stream, bad, "cpu", reps=1)
    with pytest.raises(RuntimeError, match="frames for"):
        B.check_frames([], digests, "empty")


def test_without_a_card_the_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        B.main([])
    with pytest.raises(ValueError, match="multiple"):
        fixture_batch_stream(3)
