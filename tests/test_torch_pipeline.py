"""The port's pipeline/gop.py against jmcodec_tpu's, exactly: split_gops on
the committed multi-IDR streams (and streams of one GOP), the manifest a
stream makes, its JSON, and a job started by one package's manifest and
resumed by the other's, both ways. Claims under threads never claim a GOP
twice."""

import json
import os
import threading

import pytest

from jmcodec_tpu.pipeline import gop as JG
from jmcodec_tpu_torch.pipeline import gop as G

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# multi-IDR streams (several GOPs) and single-GOP ones
STREAMS = ["h264_1080p_intra.h264", "h264_80x64.h264",
           "h264_inter_idr2_64x64.h264", "h264_session_idr3_96x64.h264",
           "h264_session_pcm_48x48.h264", "h264_inter_p_64x64.h264",
           "h264_96x64_slices3.h264", "h264_inter_slices3_96x64.h264"]


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", STREAMS)
def test_split_gops_matches_jax(name):
    data = _read(name)
    got = G.split_gops(data)
    assert got == JG.split_gops(data)
    assert got[0][0] == 0 and got[-1][1] == len(data)
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_split_gops_without_an_idr_is_one_range():
    data = b"\x00\x00\x01\x41\x9a" * 3       # non-IDR slices only
    assert G.split_gops(data) == JG.split_gops(data) == [(0, len(data))]


@pytest.mark.parametrize("name", STREAMS[:5])
def test_manifest_json_matches_jax(name, tmp_path):
    path = os.path.join(DATA, name)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    G.TranscodeManifest.create(path, str(ours)).save()
    JG.TranscodeManifest.create(path, str(theirs)).save()
    assert json.loads((ours / "manifest.json").read_text()) == \
        json.loads((theirs / "manifest.json").read_text())


@pytest.mark.parametrize("first,second", [(JG, G), (G, JG)],
                         ids=["jax_then_port", "port_then_jax"])
def test_a_job_resumes_under_the_other_package(first, second, tmp_path):
    path = os.path.join(DATA, "h264_session_idr3_96x64.h264")
    out = str(tmp_path)
    m = first.TranscodeManifest.create(path, out)
    m.save()
    job = m.claim("a")
    assert job.index == 0
    m.complete(job.index, "seg00000.h264")
    stale = m.claim("crashed")              # never completed
    assert stale.index == 1

    r = second.TranscodeManifest.load(out)
    assert (r.done(), r.pending()) == (1, 2)
    assert [j.status for j in r.jobs] == ["done", "running", "pending"]
    nxt = r.claim("b")
    assert nxt.index == 2                   # the running job is not stale
    r.complete(nxt.index, "seg00002.h264")
    r.jobs[1].updated -= 601                # ... until it is
    r.save()
    again = r.claim("b")
    assert again.index == 1 and again.worker == "b"
    r.complete(again.index, "seg00001.h264")

    back = first.TranscodeManifest.load(out)
    assert back.pending() == 0 and back.done() == 3
    assert [j.output for j in back.jobs] == \
        ["seg00000.h264", "seg00001.h264", "seg00002.h264"]
    assert back.claim("a") is None


def test_failed_job_counts_as_pending_in_both(tmp_path):
    path = os.path.join(DATA, "h264_80x64.h264")
    m = G.TranscodeManifest.create(path, str(tmp_path))
    m.save()
    m.fail(m.claim("w").index)
    j = JG.TranscodeManifest.load(str(tmp_path))
    assert (j.pending(), j.done()) == (m.pending(), m.done()) == (2, 0)


def test_threads_never_claim_a_gop_twice(tmp_path):
    """16 workers (more than the cores) claim from one manifest until it
    is empty: every GOP is claimed exactly once (the manifest's flock
    transaction)."""
    path = os.path.join(DATA, "h264_1080p_intra.h264")
    m = G.TranscodeManifest.create(path, str(tmp_path))
    m.jobs = [G.GopJob(i, 0, 1) for i in range(48)]
    m.save()
    claimed, lock = [], threading.Lock()

    def work(name):
        own = G.TranscodeManifest.load(str(tmp_path))
        while (job := own.claim(name)) is not None:
            own.complete(job.index, f"{name}/{job.index}")
            with lock:
                claimed.append(job.index)

    threads = [threading.Thread(target=work, args=(f"w{i}",))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(claimed) == list(range(48))
    assert G.TranscodeManifest.load(str(tmp_path)).done() == 48
