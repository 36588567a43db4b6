"""The port's row-sharded H.264 decode (parallel/spatial.py) on the CPU, at
tolerance 0: an IDR and a P picture with their macroblock rows banded over
sp = 2 and 4 gloo ranks (one launch of each for the module) equal the
port's one-device decode on every rank and, at sp = 2, jmcodec_tpu's
row-sharded decode on 2 of its virtual CPU devices. The scans make one
boundary-lane exchange per roll per step, counted. Motion at the edge of
the halo budget (|mvy| = 4 * (MC_PAD - 8) quarter samples, and one short of
it at odd phases) decodes the same sharded and whole; clip_y moves the
vertical clamp as jmcodec_tpu's does. The three raises of the reference:
mb_height not divisible by sp, a band shorter than MC_PAD, a vertical MV
past the budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.codec.h264.fastdec import FastH264Parser as JParser
from jmcodec_tpu.kernels import recon_tiles as JRT
from jmcodec_tpu.parallel import spatial as JSP
from jmcodec_tpu.parallel.mesh import ShardingConfig as JCfg
from jmcodec_tpu.parallel.mesh import build_mesh as jmesh
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.parallel import distributed as D
from jmcodec_tpu_torch.parallel import spatial as SP
from jmcodec_tpu_torch.parallel.mesh import ShardingConfig
from jmcodec_tpu_torch.tools.fixtures import (row_sharded_stream,
                                              symbols_from_reference)

W, H = 64, 128          # 8 MB rows: bands of 4 (sp 2) and 2 (sp 4)
BUDGET = 4 * (RT.MC_PAD - 8)


def _edge_mvs(fs):
    """fs's P picture with vertical MVs at the halo budget's edge on some
    blocks of every band: +-BUDGET and +-(BUDGET - 1) (odd phases)."""
    mv = np.array(fs.mv)
    rows = mv.shape[0]
    for k, v in enumerate((BUDGET, -BUDGET, BUDGET - 1, -(BUDGET - 1))):
        mv[k::4, (k * 3) % mv.shape[1], 1] = v
        mv[(rows // 2 + k) % rows, :, 1] = v
    fs.mv = mv
    return fs


@pytest.fixture(scope="module")
def pictures():
    """(JAX symbols of the IDR, of the P picture, of the P picture with
    edge MVs) of tools.fixtures.row_sharded_stream (its P picture holds
    intra macroblocks across the bands); the port's are copies."""
    pics = JParser().parse_annexb(row_sharded_stream(W, H))
    (fi, _), (fp, _) = pics[:2]
    fe = _edge_mvs(JParser().parse_annexb(row_sharded_stream(W, H))[1][0])
    assert int(np.abs(fe.mv[..., 1]).max()) == BUDGET
    return fi, fp, fe


def _ref(planes):
    return [RT.pad_ref_device(*(torch.from_numpy(np.asarray(p))
                                for p in planes))]


@pytest.fixture(scope="module")
def whole(pictures):
    """The port's one-device decodes: IDR, P, edge-MV P, and the IDR's
    padded reference."""
    fi, fp, fe = (symbols_from_reference(f) for f in pictures)
    idr = RT.decode_frame_symbols(fi, device="cpu")
    refs = _ref(idr)
    p = [tuple(t.numpy() for t in RT.decode_frame_symbols_inter(f, refs, [0]))
         for f in (fp, fe)]
    return idr, p[0], p[1], refs


@pytest.fixture(scope="module")
def sharded(pictures, whole):
    """{sp: per-rank [(out, counts) of the IDR, of P, of edge-MV P]}."""
    fi, fp, fe = (symbols_from_reference(f) for f in pictures)
    refs = whole[3]
    out = {}
    for sp in (2, 4):
        cfg = ShardingConfig(1, sp)
        calls = [(D.with_counts, (SP.decode_frame_rows_sharded, fi, None,
                                  cfg, None, "cpu"))]
        calls += [(D.with_counts, (SP.decode_frame_rows_sharded_inter, f,
                                   refs, None, cfg)) for f in (fp, fe)]
        out[sp] = D.launch(D.run_calls, sp, calls)
    return out


@pytest.fixture(scope="module")
def jax_sp2(pictures):
    """jmcodec_tpu's row-sharded decodes at sp = 2 (2 virtual devices)."""
    fi, fp, fe = pictures
    cfg = JCfg(1, 2)
    mesh = jmesh(cfg, devices=jax.devices()[:2])
    idr = JSP.decode_frame_rows_sharded(fi, mesh=mesh, cfg=cfg)
    refs = [JRT.pad_ref_device(*(jnp.asarray(p) for p in idr))]
    return [idr] + [JSP.decode_frame_rows_sharded_inter(f, refs, mesh=mesh,
                                                        cfg=cfg)
                    for f in (fp, fe)]


def _n_steps():
    return W // 16 + 2 * (H // 16 - 1)


CASES = {"idr": 0, "p": 1, "p_halo_edge": 2}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_row_sharded_equals_the_one_device_decode(sharded, whole, sp, case):
    k = CASES[case]
    for rank in sharded[sp]:
        got, _ = rank[k]
        for a, b in zip(got, whole[k]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_row_sharded_matches_jax_at_sp2(sharded, jax_sp2, case):
    k = CASES[case]
    got, _ = sharded[2][0][k]
    for a, b in zip(got, jax_sp2[k]):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("sp", [2, 4])
def test_one_boundary_lane_exchange_per_roll_per_step(sharded, pictures,
                                                      sp):
    """The intra scan rolls 7 carries a walked diagonal (luma top, top-right
    and top-left; each chroma plane's top and top-left), the deblock scan 8
    a step of n_steps + 2 (the QP, the tile above and back, each chroma
    plane's above and back, the valid lanes) in an IDR picture and 7 in a P
    picture (bS comes per edge); each roll exchanges one lane."""
    n = _n_steps()
    walked = sum(RT.intra_steps(pictures[1].mb_class))
    assert 0 < walked < n
    for rank in sharded[sp]:
        idr, p, pe = (r[1] for r in rank)
        assert idr["lane_exchanges"] == 7 * n + 8 * (n + 2)
        assert p["lane_exchanges"] == pe["lane_exchanges"] \
            == 7 * walked + 7 * (n + 2)
        # each rank decodes the residuals of the whole picture
        assert idr["dequant_idct"] == p["dequant_idct"] == 0  # CPU: plain


def test_clip_y_moves_the_clamp_as_jax_does(whole):
    """A band's MC with clip_y equals jmcodec_tpu's with the same window
    (a band of 64 rows with its 32-row halos) and clip, at vertical MVs up
    to the budget and horizontal ones past the plane's clamp."""
    rng = np.random.default_rng(3)
    refs = whole[3]
    band = refs[0][0][None, 32:32 + 64 + 64].to(torch.int32)   # one window
    mv = np.stack([rng.integers(-300, 300, (16, 16)),
                   rng.integers(-BUDGET, BUDGET + 1, (16, 16))],
                  -1).astype(np.int32)
    ri = np.zeros((16, 16), np.int32)
    clip, clip_c = (3 - 64, 64 + 64 - 8), (-32, 32 + 32 - 4)
    ours = RT._mc_luma_batched(band, torch.from_numpy(mv),
                               torch.from_numpy(ri), clip_y=clip)
    theirs = JRT._mc_luma_batched(jnp.asarray(band.numpy()), jnp.asarray(mv),
                                  jnp.asarray(ri), 4, 4, clip_y=clip)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    cband = refs[0][1][None, 16:16 + 32 + 32].to(torch.int32)
    ours = RT._mc_chroma_batched(cband, torch.from_numpy(mv),
                                 torch.from_numpy(ri), clip_y=clip_c)
    theirs = JRT._mc_chroma_batched(jnp.asarray(cband.numpy()),
                                    jnp.asarray(mv), jnp.asarray(ri), 4, 4,
                                    clip_y=clip_c)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


def test_clip_y_default_is_the_plane_clamp(whole):
    refs = whole[3]
    mv = torch.from_numpy(np.random.default_rng(4).integers(
        -400, 400, (32, 16, 2)).astype(np.int32))
    ri = torch.zeros((32, 16), dtype=torch.int32)
    ref = refs[0][0][None].to(torch.int32)
    Hp = ref.shape[1]
    assert torch.equal(RT._mc_luma_batched(ref, mv, ri),
                       RT._mc_luma_batched(ref, mv, ri, clip_y=(3, Hp - 8)))


def test_mb_height_not_divisible_by_sp_raises(pictures):
    fi = symbols_from_reference(pictures[0])
    with pytest.raises(ValueError, match="not divisible"):
        SP.decode_frame_rows_sharded(fi, cfg=ShardingConfig(1, 3),
                                     device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        JSP.decode_frame_rows_sharded(
            pictures[0], mesh=jmesh(JCfg(1, 3), devices=jax.devices()[:3]),
            cfg=JCfg(1, 3))


def test_band_shorter_than_the_halo_raises(pictures, whole):
    fp = symbols_from_reference(pictures[1])
    with pytest.raises(NotImplementedError, match="MC_PAD"):
        SP.decode_frame_rows_sharded_inter(fp, whole[3],
                                           cfg=ShardingConfig(1, 8))
    jcfg = JCfg(1, 8)
    with pytest.raises(NotImplementedError, match="MC_PAD"):
        JSP.decode_frame_rows_sharded_inter(pictures[1], [], mesh=jmesh(jcfg),
                                            cfg=jcfg)


def test_vertical_mv_past_the_budget_raises(pictures, whole):
    fe = symbols_from_reference(pictures[2])
    fe.mv = np.array(fe.mv)
    fe.mv[0, 0, 1] = BUDGET + 1
    with pytest.raises(NotImplementedError, match="halo budget"):
        SP.decode_frame_rows_sharded_inter(fe, whole[3],
                                           cfg=ShardingConfig(1, 2))
    jcfg = JCfg(1, 2)
    with pytest.raises(NotImplementedError, match="halo budget"):
        JSP.decode_frame_rows_sharded_inter(
            fe, [], mesh=jmesh(jcfg, devices=jax.devices()[:2]), cfg=jcfg)
