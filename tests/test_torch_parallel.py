"""The port's parallel layer (jmcodec_tpu_torch/parallel) on the CPU
against jmcodec_tpu/parallel, at tolerance 0. Where the JAX package shards
over 1, 2 or 4 of its 8 virtual CPU devices, the port runs the same number
of gloo ranks, each a spawned process (parallel/distributed.launch): one
launch of 4 ranks (dp 2 x sp 2) and one of 2 (dp 1 x sp 2) for the whole
module, world 1 in this process. Checked: ShardingConfig.auto, pad_batch,
the toy transcode step and its demo, decode_symbols_sharded and
make_transcode_real_step on _synthetic_symbols and on a real small stream
(the JAX parser's symbols carried across with symbols_from_reference),
dryrun_multichip(4, "cpu"), assign_gops, init_from_env alone and in two
spawned ranks (through tools/jmx_multiproc.py), the backend check, and
decode_plans_pipelined on
the CPU against decode_frames_hevc_batch, JAX's decode_plans_pipelined and
libavcodec on a CTU-16 all-intra stream."""

import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from jmcodec_tpu.codec.h264.fastdec import FastH264Parser as JParser
from jmcodec_tpu.kernels.recon import stack_symbols as jstack
from jmcodec_tpu.parallel import decode_sharded as JDS
from jmcodec_tpu.parallel import distributed as JD
from jmcodec_tpu.parallel import framepp as JFP
from jmcodec_tpu.parallel import transcode as JTC
from jmcodec_tpu.parallel.mesh import ShardingConfig as JCfg
from jmcodec_tpu.parallel.mesh import build_mesh as jmesh
from jmcodec_tpu.parallel.mesh import shard_batch as jshard_batch
from jmcodec_tpu.parallel.mesh import shard_frames as jshard_frames
from jmcodec_tpu_torch import entry as E
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.kernels.recon import stack_symbols
from jmcodec_tpu_torch.parallel import decode_sharded as DS
from jmcodec_tpu_torch.parallel import distributed as D
from jmcodec_tpu_torch.parallel import framepp as FP
from jmcodec_tpu_torch.parallel import mesh as M
from jmcodec_tpu_torch.parallel import transcode as TC
from jmcodec_tpu_torch.tools import jmx_multiproc
from jmcodec_tpu_torch.tools.fixtures import (fixture_digests,
                                              symbols_from_reference)

from test_framepp import _plans as jax_plans

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CFG = {1: (1, 1), 2: (1, 2), 4: (2, 2)}       # world -> (dp, sp)
QP = 30


def _frames():
    return np.random.default_rng(7).integers(0, 256, (4, 64, 64), np.uint8)


def _stream_symbols():
    with open(os.path.join(DATA, "h264_80x64.h264"), "rb") as f:
        return [fs for fs, _ in JParser().parse_annexb(f.read())]


def _jax_mesh(n):
    cfg = JCfg(*CFG[n])
    return cfg, jmesh(cfg, devices=jax.devices()[:n])


def _jax_decode(fss, n):
    cfg, mesh = _jax_mesh(n)
    return JDS.decode_symbols_sharded(fss, cfg=cfg, mesh=mesh)


def _jax_real_step(fss, n):
    cfg, mesh = _jax_mesh(n)
    args, _ = JDS.pad_batch(jstack(fss), cfg.n_devices)
    step = JDS.make_transcode_real_step(mesh, cfg, fss[0].mb_height,
                                        fss[0].mb_width, QP)
    z, bits, ssd = step(*[jshard_batch(mesh, cfg, a) for a in args])
    return np.asarray(z), int(bits), int(ssd)


def _jax_step(Y, n):
    cfg, mesh = _jax_mesh(n)
    z, bits, ssd = JTC.make_transcode_step(mesh, cfg, qp=QP)(
        jshard_frames(mesh, cfg, Y))
    return np.asarray(z), int(bits), int(ssd)


def _calls(n):
    """The rank calls of a launch of n ranks."""
    cfg = M.ShardingConfig(*CFG[n])
    calls = [(TC.run_transcode_step, (_frames(), cfg, QP, "cpu")),
             (TC.run_transcode_demo, (n, 2, 64, 64, QP, "cpu"))]
    if n == 4:
        synth = DS._synthetic_symbols(4, 4, 8)
        real = [symbols_from_reference(fs) for fs in _stream_symbols()]
        calls += [(DS.decode_symbols_sharded, (synth, cfg, None, True, "cpu")),
                  (DS.run_transcode_real_step, (synth, cfg, QP, "cpu")),
                  (DS.decode_symbols_sharded, (real, cfg, None, True, "cpu")),
                  (DS.run_transcode_real_step, (real, cfg, QP, "cpu"))]
    return calls


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The world-1 calls in this process make a one-rank gloo group; it
    is destroyed with the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """{world: [rank results of _calls(world)]}: 4 and 2 gloo ranks, and
    world 1 in this process."""
    out = {n: D.launch(D.run_calls, n, _calls(n)) for n in (4, 2)}
    out[1] = [D.run_calls(_calls(1))]
    return out


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_sharding_config_auto_matches_jax(n):
    for sp in (2, 4):
        ours, theirs = M.ShardingConfig.auto(n, sp=sp), JCfg.auto(n, sp=sp)
        assert (ours.dp, ours.sp) == (theirs.dp, theirs.sp)


def test_sharding_config_auto_takes_the_world_size():
    assert M.ShardingConfig.auto().n_devices == M.world_size()


@pytest.mark.parametrize("n,ways", [(5, 4), (8, 4), (1, 3), (3, 8)])
def test_pad_batch_matches_jax(n, ways):
    a = np.arange(n * 6, dtype=np.int32).reshape(n, 2, 3)
    b = np.arange(n, dtype=np.int32)
    ours, n1 = DS.pad_batch([torch.from_numpy(a), torch.from_numpy(b)], ways)
    theirs, n2 = JDS.pad_batch([jax.numpy.asarray(a), jax.numpy.asarray(b)],
                               ways)
    assert n1 == n2 == n
    for x, y in zip(ours, theirs):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_transcode_step_matches_jax(ranks, n):
    want = _jax_step(_frames(), n)
    for res in ranks[n]:
        z, bits, ssd = res[0]
        assert np.array_equal(z, want[0])
        assert (bits, ssd) == want[1:]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_transcode_demo_matches_jax(ranks, n):
    z, bits, ssd, cfg = JTC.run_transcode_demo(n)
    for res in ranks[n]:
        oz, obits, ossd, ocfg = res[1]
        assert (ocfg.dp, ocfg.sp) == (cfg.dp, cfg.sp)
        assert np.array_equal(oz, z) and (obits, ossd) == (bits, ssd)


@pytest.mark.parametrize("kind", ["synthetic", "stream"])
def test_decode_symbols_sharded_matches_jax(ranks, kind):
    fss = DS._synthetic_symbols(4, 4, 8) if kind == "synthetic" \
        else _stream_symbols()
    want = _jax_decode(JDS._synthetic_symbols(4, 4, 8) if kind == "synthetic"
                       else fss, 4)
    k = 2 if kind == "synthetic" else 4
    for res in ranks[4]:                   # every rank: the whole batch
        for a, b in zip(res[k], want):
            assert np.array_equal(a, np.asarray(b))
    # and the one-device decode of the port
    ours = fss if kind == "synthetic" else \
        [symbols_from_reference(fs) for fs in fss]
    one = RT.decode_frames_batch(ours[0].mb_height, ours[0].mb_width,
                                 *stack_symbols(ours, "cpu"))
    for a, b in zip(ranks[4][0][k], one):
        assert np.array_equal(a, b.numpy())


@pytest.fixture(scope="module")
def jax_real_step():
    """JAX's make_transcode_real_step (dp 2 x sp 2) on the synthetic
    symbols and on the stream's, each compiled and run once for the
    module (the dryrun's first check is the synthetic one)."""
    return {"synthetic": _jax_real_step(JDS._synthetic_symbols(4, 4, 8), 4),
            "stream": _jax_real_step(_stream_symbols(), 4)}


@pytest.mark.parametrize("kind", ["synthetic", "stream"])
def test_transcode_real_step_matches_jax(ranks, jax_real_step, kind):
    want = jax_real_step[kind]
    k = 3 if kind == "synthetic" else 5
    for res in ranks[4]:
        z, bits, ssd = res[k]
        assert np.array_equal(z, want[0])
        assert (bits, ssd) == want[1:]


def test_real_step_at_world_1_matches_world_4(ranks):
    z, bits, ssd = DS.run_transcode_real_step(DS._synthetic_symbols(4, 4, 8),
                                              M.ShardingConfig(1, 1), QP,
                                              "cpu")
    assert np.array_equal(z, ranks[4][0][3][0])
    assert (bits, ssd) == ranks[4][0][3][1:]


def test_dryrun_multichip_on_4_cpu_ranks(jax_real_step):
    """entry.dryrun_multichip(4, "cpu"): its three checks pass on 4 gloo
    ranks, and its sharded step is JAX's run_decode_sharded_dryrun(4)
    (make_transcode_real_step on _synthetic_symbols(4, 4, 8), dp 2 x sp
    2)."""
    res = E.dryrun_multichip(4, device="cpu")
    z, bits, ssd = jax_real_step["synthetic"]
    assert (res["dp"], res["sp"]) == (2, 2)
    assert (res["bits"], res["ssd"]) == (bits, ssd)
    assert np.array_equal(res["levels"], z)


@pytest.mark.parametrize("n_gops,n_workers", [(10, 3), (8, 4), (3, 5),
                                              (1, 1)])
def test_assign_gops_matches_jax(n_gops, n_workers):
    got = [D.assign_gops(n_gops, n_workers, w) for w in range(n_workers)]
    assert got == [JD.assign_gops(n_gops, n_workers, w)
                   for w in range(n_workers)]
    assert sorted(g for part in got for g in part) == list(range(n_gops))


def test_init_from_env_alone(monkeypatch):
    for k in ("JMX_COORD", "JMX_NPROC", "JMX_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    ours, theirs = D.init_from_env("cpu"), JD.init_from_env()
    assert ours.keys() == theirs.keys()
    assert (ours["processes"], ours["process_id"]) == \
        (theirs["processes"], theirs["process_id"]) == (1, 0)


def test_init_from_env_in_two_spawned_ranks():
    """Two ranks join through JMX_COORD / JMX_NPROC / JMX_PROC_ID, claim
    GOPs from one manifest and sum the frame counts with all_reduce."""
    rep = jmx_multiproc.run(nproc=2, gops=4, frames_per_gop=1, size="64x32",
                            device="cpu")
    assert rep["ok"], rep
    assert sorted(r["process_id"] for r in rep["per_process"]) == [0, 1]
    assert all(r["frames_global_allreduce"] == 4 and r["processes"] == 2
               for r in rep["per_process"])


def test_a_group_of_another_backend_raises():
    M.build_mesh(M.ShardingConfig(1, 1), "cpu")        # a gloo group
    with pytest.raises(RuntimeError, match="backend"):
        M.ensure_process_group(torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# the two-stage HEVC pipeline
# ---------------------------------------------------------------------------

CTU16 = os.path.join(DATA, "hevc_ctu16_64x64.h265")


@pytest.fixture(scope="module")
def hevc_ctu16():
    """The CTU-16 stream (4 pictures of make_frame(64, 64, i), libx265 via
    the oracle: gop=1, qp=30, extra="ctu=16"), its libavcodec digests, the
    port's plans and JAX's pipelined decode of it."""
    with open(CTU16, "rb") as f:
        s = f.read()
    devs = jax.devices()
    theirs = JFP.decode_plans_pipelined(jax_plans(s), d_scan=devs[0],
                                        d_filter=devs[1], batch=2)
    return (parse_hevc_intra_plans(s),
            fixture_digests(CTU16.replace(".h265", ".sha256.json")),
            [tuple(np.asarray(p) for p in out) for out in theirs])


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_decode_plans_pipelined_on_the_cpu(hevc_ctu16, batch):
    plans, digests, theirs = hevc_ctu16
    outs = FP.decode_plans_pipelined(plans, "cpu", "cpu", batch=batch)
    assert len(outs) == -(-len(plans) // batch)
    got = [np.concatenate([o[k].numpy() for o in outs]) for k in range(3)]
    want = HTT.decode_plans_batch(plans, "cpu")
    jax_cat = [np.concatenate([t[k] for t in theirs]) for k in range(3)]
    for k, plane in enumerate("YUV"):
        assert np.array_equal(got[k], want[k].numpy())
        assert np.array_equal(got[k], jax_cat[k])
        for f in range(len(plans)):
            h = hashlib.sha256(np.ascontiguousarray(got[k][f])).hexdigest()
            assert h == digests[f][plane]


def test_scan_then_filters_is_the_batch_decode(hevc_ctu16):
    plans = hevc_ctu16[0]
    args = HTT.stack_plans(plans, "cpu")
    Y, U, V = HTT.decode_frames_hevc_scan(*args[:4], *args[9:21])
    assert Y.dtype == torch.int32 and tuple(Y.shape[1:]) == (64, 64)
    out = HTT.decode_frames_hevc_filters(*args[2:3], *args[4:9], Y, U, V,
                                         args[13], *args[19:])
    for a, b in zip(out, HTT.decode_frames_hevc_batch(*args)):
        assert torch.equal(a, b)


def test_pipeline_defaults_need_a_card(hevc_ctu16):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FP.decode_plans_pipelined(hevc_ctu16[0])
