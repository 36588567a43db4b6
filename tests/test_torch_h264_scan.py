"""The H.264 scan kernels' CPU side (jmcodec_tpu_torch.kernels.h264_scan
and recon_tiles' routing), at tolerance 0 on seeded inputs:

- the all-intra bS as tensors (recon_tiles.intra_bs_tiles) through the
  per-edge-bS deblock scan equals the all-intra deblock scan and
  jmcodec_tpu's _deblock_tile_scan_intra on the CPU backend, whether the
  pattern is one frame's, broadcast over the batch, or every frame's;
- on the seeds and shapes that tests/test_torch_h264_scan_cuda.py holds the
  kernels on, the plain versions (_intra_tile_scan, all-intra and P with
  its walk; _deblock_tile_scan) equal jmcodec_tpu's scans, so that kernel
  == plain version == JAX on one set of inputs;
- _reconstruct routes the scans: CPU tensors take the torch scans; a CUDA
  device takes the kernel wrappers, with or without a process group (the
  predicate is checked without a card; the wrappers' call is checked on
  the CPU with the wrappers replaced by their plain versions);
- the row-sharded route of the wrappers (the lane above each band as a
  halo, exchanged per diagonal, the deblock's rows handed back) on sp = 2
  and 4 gloo ranks, each launch replaced by a plain version of that one
  diagonal built from the torch scans, equals the one-device decode and,
  at sp = 2, jmcodec_tpu's row-sharded decode;
- intra_tiles / deblock_tiles raise on CPU tensors and on a wrong dtype,
  shape or layout, before anything is launched;
- the intra kernel's Intra_4x4 wavefront table (h264_scan.I4_WAVE, set in
  its constant memory) holds each sub-block once, at most two a step,
  after every neighbour it reads, and leaves unavailable the top-rights
  that decode order makes so.

The kernels themselves run only on the card: tests/test_torch_h264_scan_
cuda.py holds them against their plain versions."""

import functools
import hashlib

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
from jmcodec_tpu_torch.api.h264_inter import decode_h264, parse_h264
from jmcodec_tpu_torch.codec.h264 import macroblock as MB
from jmcodec_tpu_torch.kernels import h264_scan as HS
from jmcodec_tpu_torch.kernels import recon as RC
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.parallel import distributed as D
from jmcodec_tpu_torch.parallel import spatial as SP
from jmcodec_tpu_torch.parallel.mesh import ShardingConfig
from jmcodec_tpu_torch.tools.fixtures import (row_sharded_stream,
                                              session_fixture,
                                              symbols_from_reference,
                                              synth_deblock_scan,
                                              synth_intra_scan)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
OFFSETS = ("alpha_off", "beta_off", "chroma_qp_off", "second_chroma_qp_off")


@pytest.mark.parametrize("mbh,mbw", [(2, 5), (4, 3)])
def test_intra_bs_tiles_deblock_equals_the_intra_scan_and_jax(mbh, mbw):
    """Three frames, each with its own qp plane and nonzero offsets; at
    (4, 3) lanes are invalid at both ends of the scan."""
    Y, U, V, qp, valid = synth_deblock_scan(mbh, mbw, 3, seed=mbh)[:5]
    offs = [np.array(o, np.int32) for o in ((4, -6, 12), (-2, 8, -12),
                                            (-3, 0, 7), (6, -5, 0))]
    mys, mxs, valid_g = RT._skew_geometry(mbh, mbw)
    assert np.array_equal(valid, valid_g)
    if mbh > 2:
        assert not valid[0, -1] and not valid[-1, 0]
    args = [T(a) for a in (Y, U, V, qp)]
    geo = [T(a) for a in (mxs, mys, valid)]
    off = [T(o) for o in offs]
    want = RT._deblock_tile_scan_intra(*args, *geo, *off)
    for nf in (1, 3):
        bs_v, bs_h = RT.intra_bs_tiles(*geo, nf)
        assert tuple(bs_v.shape) == (nf, *valid.shape, 4, 4)
        assert bs_v.dtype == torch.int32 and bs_v.is_contiguous()
        got = RT._deblock_tile_scan(*args, geo[2], *off, bs_v, bs_h)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    jscan = jax.jit(functools.partial(JRT._deblock_tile_scan_intra,
                                      bmax=mbh))
    changed = 0
    for f in range(3):
        jw = jscan(*(a[f] for a in (Y, U, V, qp)), jnp.asarray(mxs),
                   jnp.asarray(mys), jnp.asarray(valid),
                   **{k: np.int32(o[f]) for k, o in zip(
                       ("alpha_off", "beta_off", "chroma_qp_off",
                        "second_chroma_qp_off"), offs)})
        for k in range(3):
            assert np.array_equal(want[k][f].numpy(), np.asarray(jw[k]))
            changed += int((want[k][f] != args[k][f]).sum())
    assert changed > 200, "the filter hardly touched the tiles"


def test_intra_bs_tiles_pattern():
    mbh, mbw = 3, 4
    mys, mxs, valid = (T(a) for a in RT._skew_geometry(mbh, mbw))
    bs_v, bs_h = RT.intra_bs_tiles(mxs, mys, valid)
    v = valid == 1
    for bs, mb in ((bs_v, mxs > 0), (bs_h, mys > 0)):
        assert torch.equal(bs[0, :, :, 0, :],
                           ((v & mb).int() * 4)[..., None].expand(-1, -1, 4))
        assert torch.equal(bs[0, :, :, 1:, :],
                           (v.int() * 3)[..., None, None].expand(-1, -1, 3,
                                                                  4))
    assert set(bs_v.unique().tolist()) == {0, 3, 4}


# the shapes and seeds of tests/test_torch_h264_scan_cuda.py
CUDA_CASES = [(mbh, mbw, nf) for mbh, mbw in ((3, 5), (7, 10))
              for nf in (1, 3)]


@functools.lru_cache(maxsize=None)
def _jax_intra_scan(bmax, inter):
    kw = ("inter_y_t", "inter_u_t", "inter_v_t")
    if not inter:
        return jax.jit(functools.partial(JRT._intra_tile_scan, bmax=bmax))
    return jax.jit(lambda *a: JRT._intra_tile_scan(
        *a[:11], bmax=bmax, **dict(zip(kw, a[11:]))))


@pytest.mark.parametrize("mbh,mbw,nf", CUDA_CASES)
@pytest.mark.parametrize("inter", [False, True], ids=["intra", "p"])
def test_intra_scan_matches_jax_on_the_cuda_tests_inputs(mbh, mbw, nf,
                                                        inter):
    """In a P picture jmcodec_tpu walks every diagonal: a diagonal that the
    walk skips is its inter tiles there when its macroblocks are inter
    (class 3), so the reference runs on the classes with those diagonals
    set to 3, and the plain version walks every diagonal too."""
    a = synth_intra_scan(mbh, mbw, nf, seed=10 * mbh + nf, inter=inter)
    args = [T(x) for x in a[:11]]
    inter_t = tuple(T(x) for x in a[11:14]) if inter else None
    walk = a[14] if inter else None
    got = RT._intra_tile_scan(*args, inter_t, walk)
    every = RT._intra_tile_scan(*args, inter_t) if inter else got
    cls_skip = np.array(a[4])
    if inter:
        cls_skip[:, ~np.array(walk)] = 3
    jscan = _jax_intra_scan(mbh, inter)
    for f in range(nf):
        for cls, out in ((a[4], every), (cls_skip, got)):
            xs = [x[f] for x in a[:4]] + [cls[f]] + [x[f] for x in a[5:10]]
            want = jscan(*xs, a[10], *([x[f] for x in a[11:14]] if inter
                                       else []))
            for g, w in zip(out, want):
                assert np.array_equal(g[f].numpy(), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _jax_deblock_scan(bmax):
    return jax.jit(functools.partial(JRT._deblock_tile_scan, bmax=bmax))


@pytest.mark.parametrize("mbh,mbw,nf", CUDA_CASES)
def test_deblock_scan_matches_jax_on_the_cuda_tests_inputs(mbh, mbw, nf):
    a = synth_deblock_scan(mbh, mbw, nf, seed=10 * mbh + nf)
    got = RT._deblock_tile_scan(*(T(x) for x in a))
    mys, mxs, _ = RT._skew_geometry(mbh, mbw)
    jscan = _jax_deblock_scan(mbh)
    changed = 0
    for f in range(nf):
        want = jscan(*(x[f] for x in a[:4]), mxs, mys, a[4],
                     **{k: o[f] for k, o in zip(OFFSETS, a[5:9])},
                     bs_v_t=a[9][f], bs_h_t=a[10][f])
        for k in range(3):
            assert np.array_equal(got[k][f].numpy(), np.asarray(want[k]))
            changed += int((got[k][f].numpy() != a[k][f]).sum())
    assert changed > 100 * nf, "the filter hardly touched the tiles"


def test_scan_route_predicate():
    assert RT.scan_kernels(torch.device("cuda", 0))
    assert RT.scan_kernels(torch.device("cuda", 1))
    assert not RT.scan_kernels(torch.device("cpu"))


def _recording(monkeypatch, calls):
    """Every scan entry point of recon_tiles wrapped to record its calls
    (the wrappers run their plain versions, as no card is here)."""
    def rec(name, fn):
        def run(*a, group=None):
            calls.append((name, a))
            return fn(*a)
        monkeypatch.setattr(RT, name, run)
    intra, deblock = RT._intra_tile_scan, RT._deblock_tile_scan
    rec("_intra_tile_scan", intra)
    rec("_deblock_tile_scan", deblock)
    rec("_deblock_tile_scan_intra", RT._deblock_tile_scan_intra)
    rec("intra_tiles", intra)
    rec("deblock_tiles", deblock)


@pytest.mark.parametrize("name", ["h264_inter_p_64x64",
                                  "h264_inter_slices3_96x64"])
def test_reconstruct_routes_the_scans(monkeypatch, name):
    """An I + P stream decoded on the CPU takes the torch scans; routed as
    on a card (scan_kernels true) the same decode calls the kernel
    wrappers once a picture, with the all-intra bS as one [1, ...]
    pattern for the IDR and the walk of each P picture, and gives the same
    frames, equal to the libavcodec digests."""
    stream, digests = session_fixture(name)
    pics = list(parse_h264(stream))
    calls = []
    _recording(monkeypatch, calls)
    cpu = decode_h264(stream, "cpu")
    assert [c[0] for c in calls] == [
        s for fs, _ in pics for s in (
            ("_intra_tile_scan", "_deblock_tile_scan_intra") if fs.mv is None
            else ("_intra_tile_scan", "_deblock_tile_scan"))]
    calls.clear()
    monkeypatch.setattr(RT, "scan_kernels", lambda dev: True)
    routed = decode_h264(stream, "cpu")
    assert [c[0] for c in calls] == ["intra_tiles", "deblock_tiles"] * len(
        pics)
    for (fs, _), (_, ia), (_, da) in zip(pics, calls[0::2], calls[1::2]):
        n_steps = fs.mb_width + 2 * (fs.mb_height - 1)
        if fs.mv is None:
            assert ia[11] is None and ia[12] is None
            assert tuple(da[9].shape) == (1, n_steps, fs.mb_height, 4, 4)
        else:
            assert ia[12] == RT.intra_steps(fs.mb_class)
            assert ia[11][0].shape[:3] == (1, n_steps, fs.mb_height)
        assert all(a.is_contiguous() for a in (*ia[:11], *da[:11]))
    assert len(routed) == len(cpu) == len(digests)
    for r, c in zip(routed, cpu):
        for a, b in zip(r, c):
            assert torch.equal(a, b)
    for f, d in zip(cpu, digests):
        for k, plane in enumerate("YUV"):
            h = hashlib.sha256(np.ascontiguousarray(f[k].numpy()))
            assert h.hexdigest() == d[plane]


def _intra_args(inter):
    a = [T(x) if isinstance(x, np.ndarray) else x
         for x in synth_intra_scan(2, 3, 2, seed=3, inter=inter)]
    return a[:11], (tuple(a[11:14]) if inter else None), \
        (a[14] if inter else None)


def test_wrappers_raise_on_cpu_tensors_and_bad_arguments():
    args, inter, walk = _intra_args(True)
    n0 = (HS.INTRA_LAUNCHES, HS.DEBLOCK_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        HS.intra_tiles(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        HS.intra_tiles(*args, inter, walk)
    bad = list(args)
    bad[4] = bad[4].long()
    with pytest.raises(TypeError, match="cls_t must be int32"):
        HS.intra_tiles(*bad)
    bad = list(args)
    bad[0] = bad[0][..., :15, :15].contiguous()
    with pytest.raises(ValueError, match="resid_y_t shape"):
        HS.intra_tiles(*bad)
    bad = list(args)
    bad[3] = bad[3].transpose(-1, -2)
    with pytest.raises(ValueError, match="modes_t must be contiguous"):
        HS.intra_tiles(*bad)
    with pytest.raises(ValueError, match="walk without inter_t"):
        HS.intra_tiles(*args, None, walk)
    with pytest.raises(ValueError, match="walk has"):
        HS.intra_tiles(*args, inter, walk[:-1])
    with pytest.raises(ValueError, match="inter_u shape"):
        HS.intra_tiles(*args, (inter[0], inter[0], inter[2]), walk)

    db = [T(x) for x in synth_deblock_scan(2, 3, 3, seed=4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        HS.deblock_tiles(*db)
    with pytest.raises(ValueError, match="CUDA tensors"):
        HS.deblock_tiles(*db[:9], db[9][:1].contiguous(),
                         db[10][:1].contiguous())
    bad = list(db)
    bad[0] = bad[0].to(torch.int16)
    with pytest.raises(TypeError, match="Yt must be int32"):
        HS.deblock_tiles(*bad)
    bad = list(db)
    bad[9] = bad[9][:2].contiguous()
    with pytest.raises(ValueError, match="bs_v_t shape"):
        HS.deblock_tiles(*bad)
    bad = list(db)
    bad[5] = bad[5][:2].contiguous()
    with pytest.raises(ValueError, match="alpha_off shape"):
        HS.deblock_tiles(*bad)
    assert (HS.INTRA_LAUNCHES, HS.DEBLOCK_LAUNCHES) == n0


def test_synthetic_inputs_hold_every_case():
    """The seeded inputs the CUDA tests hold the kernels on reach every
    class, mode, availability pattern and bS, skip diagonals, and keep
    lane 0 and mx == 0 as a picture has them."""
    for inter in (False, True):
        a = synth_intra_scan(4, 6, 3, seed=1, inter=inter)
        valid = a[10] == 1
        cls, i16, cmode, al, at, atr = (x[:, valid] for x in a[4:10])
        assert set(np.unique(cls)) == set(range(4 if inter else 3))
        assert set(np.unique(a[3])) == set(range(9))
        assert set(np.unique(i16)) == set(np.unique(cmode)) == set(range(4))
        pat = set(zip(*(x.reshape(-1).tolist() for x in (al, at, atr))))
        assert len(pat) == 8
        assert not a[8][:, :, 0].any() and not a[9][:, :, 0].any()
        if inter:
            walk = a[14]
            assert 0 < sum(walk) < len(walk)
    db = synth_deblock_scan(4, 6, 3, seed=1)
    n_steps, lanes = db[4].shape
    mx = np.arange(n_steps)[:, None] - 2 * np.arange(lanes)[None, :]
    for bs in db[9:11]:
        assert set(np.unique(bs)) == set(range(5))
    assert not db[9][:, mx == 0][..., 0, :].any()
    assert not db[10][:, :, 0, 0, :].any()
    assert set(np.unique(db[3][:, db[4] == 1])) <= set(range(52))
    assert len(np.unique(db[3])) > 30


# ---------------------------------------------------------------------------
# the row-sharded route of the wrappers, on gloo ranks
# ---------------------------------------------------------------------------


def _with_lane_above(tiles, d, halo, k0, p):
    """Plane p's tiles [F, n_steps, lanes, n, n] of diagonal d (zero
    before the first) with the lane above the band as lane 0: [F, lanes +
    1, n, n]. That lane is unpacked from the wrappers' halo ([F, n_steps,
    HALO]: Y, U, V), or zero where the kernels read nothing (the first
    band, a diagonal before the first)."""
    nf, _, _, n, _ = tiles.shape
    if d < 0:
        return tiles.new_zeros((nf, tiles.shape[2] + 1, n, n))
    if k0 == 0:
        above = tiles.new_zeros((nf, 1, n, n))
    else:
        at = (0, 256, 320)[p]
        above = halo[:, d, at:at + n * n].reshape(nf, 1, n, n)
    return torch.cat([above, tiles[:, d]], 1)


def _plain_launch_intra(out, named, has_inter, walk, d0, d1, halo=None,
                        k0=0, scratch=None, ticket=0):
    """h264_scan._launch_intra's plain version, diagonal by diagonal: the
    torch scan's step on this band with the halo as an extra lane 0 (a
    lane that takes part in nothing: invalid, all zero)."""
    for d in range(d0, d1):
        if walk is not None and not walk[d]:
            continue
        carry = []
        for p in range(3):
            for dd in (d - 1, d - 2, d - 3):
                carry.append(_with_lane_above(out[p], dd, halo, k0, p))
        ext = lambda x: torch.cat([torch.zeros_like(x[:, :1]), x], 1)
        xs = [ext(named[k][:, d]) for k in HS.INTRA_ARGS[:10]]
        xs.append(torch.cat([named["valid_t"].new_zeros(1),
                             named["valid_t"][d]]))
        inter = tuple(ext(named[k][:, d]) for k in (
            "inter_y", "inter_u", "inter_v")) if has_inter else None
        _, ys = RT._intra_step(tuple(carry), tuple(xs), inter)
        for p in range(3):
            out[p][:, d] = ys[p][:, 1:]


def _plain_launch_deblock(out, named, t0, t1, halo=None, hqp=None, k0=0,
                          scratch=None, ticket=0):
    """h264_scan._launch_deblock's plain version, diagonal by diagonal:
    the torch scan over the diagonals t-2, t-1 and t with the halo as an
    extra lane 0 and bS only on diagonal t, so that it filters diagonal t
    against its left and top tiles and nothing else; the halo's tile t-2
    takes its filtered rows."""
    for t in range(t0, t1):
        win = range(t - 2, t + 1)
        tiles = [torch.stack([_with_lane_above(out[p], dd, halo, k0, p)
                              for dd in win], 1) for p in range(3)]
        qp = named["qp_t"]
        hq = (lambda dd: hqp[:, dd, None] if k0 > 0 and dd >= 0
              else qp.new_zeros((qp.shape[0], 1)))
        qps = torch.stack([torch.cat([hq(dd), qp[:, max(dd, 0)] * (dd >= 0)],
                                     1) for dd in win], 1)
        valid = named["valid_t"]
        vs = torch.stack([torch.cat([valid.new_zeros(1),
                                     valid[max(dd, 0)] * (dd >= 0)])
                          for dd in win])
        bss = []
        for name in ("bs_v_t", "bs_h_t"):
            b = named[name][:, t]
            b = torch.cat([torch.zeros_like(b[:, :1]), b], 1)
            z = torch.zeros_like(b)
            bss.append(torch.stack([z, z, b], 1))
        res = RT._deblock_tile_scan(*tiles, qps, vs,
                                    *(named[k] for k in OFFSETS), *bss)
        for i, dd in enumerate(win):
            if dd < 0:
                continue
            for p in range(3):
                out[p][:, dd] = res[p][:, i, 1:]
        if k0 > 0 and t >= 2:
            halo[:, t - 2] = torch.cat([r[:, 0, 0].flatten(-2)
                                        for r in res], -1)


def _rank_on_the_kernel_route(calls):
    """Rank function for distributed.launch: the decodes of `calls` routed
    as on the card, each kernel launch run by its plain version."""
    RT.scan_kernels = lambda dev: True
    HS._check = lambda named, device, shapes: None
    HS._launch_intra = _plain_launch_intra
    HS._launch_deblock = _plain_launch_deblock
    return D.run_calls(calls)


SW, SH = 64, 128        # 8 macroblock rows: bands of 4 (sp 2) and 2 (sp 4)


@pytest.fixture(scope="module")
def row_pictures():
    """jmcodec_tpu's symbols of tools.fixtures.row_sharded_stream's IDR and
    first P picture (intra macroblocks across the bands); the port's
    decodes of both on one device and the IDR's padded reference."""
    (fi, _), (fp, _) = JParser().parse_annexb(row_sharded_stream(SW, SH))[:2]
    pi, pp = symbols_from_reference(fi), symbols_from_reference(fp)
    idr = RT.decode_frame_symbols(pi, device="cpu")
    refs = [RT.pad_ref_device(*(torch.from_numpy(p) for p in idr))]
    p = tuple(t.numpy() for t in RT.decode_frame_symbols_inter(pp, refs, [0]))
    return (fi, fp), (pi, pp), (idr, p), refs


@pytest.mark.parametrize("sp", [2, 4])
def test_row_sharded_kernel_route_matches_the_decode_and_jax(row_pictures,
                                                             sp):
    (fi, fp), (pi, pp), whole, refs = row_pictures
    cfg = ShardingConfig(1, sp)
    calls = [(D.with_counts, (SP.decode_frame_rows_sharded, pi, None, cfg,
                              None, "cpu")),
             (D.with_counts, (SP.decode_frame_rows_sharded_inter, pp, refs,
                              None, cfg))]
    ranks = D.launch(_rank_on_the_kernel_route, sp, calls)
    want = list(whole)
    if sp == 2:
        mesh = jmesh(JCfg(1, 2), devices=jax.devices()[:2])
        jidr = JSP.decode_frame_rows_sharded(fi, mesh=mesh, cfg=JCfg(1, 2))
        jrefs = [JRT.pad_ref_device(*(jnp.asarray(p) for p in jidr))]
        jp = JSP.decode_frame_rows_sharded_inter(fp, jrefs, mesh=mesh,
                                                 cfg=JCfg(1, 2))
        for got, w in zip((jidr, jp), whole):
            for a, b in zip(got, w):
                assert np.array_equal(np.asarray(a), b)
    for rank in ranks:
        for (got, counts), w in zip(rank, want):
            # no lane roll of the torch scans: the wrappers' route
            assert counts["lane_exchanges"] == 0
            for a, b in zip(got, w):
                assert np.array_equal(a, b)


def _wave_steps():
    """{sub-block: its step in h264_scan.I4_WAVE}, checking that every
    step holds at most two and every sub-block occurs once."""
    wave = HS.I4_WAVE
    assert wave.shape == (10, 2) and wave.dtype == np.int32
    steps = {}
    for step, row in enumerate(wave):
        assert (row >= 0).sum() >= 1
        for blk in row[row >= 0].tolist():
            assert blk not in steps
            steps[blk] = step
    assert sorted(steps) == list(range(16))
    return steps


def _block_at(bx, by):
    """The decode-order index of the sub-block at sample (bx, by) of the
    macroblock, or None outside it."""
    for i in range(16):
        if (int(MB.BLK_X[i]), int(MB.BLK_Y[i])) == (bx, by):
            return i
    return None


def test_i4_wave_holds_each_sub_block_once_two_a_step():
    steps = _wave_steps()
    for blk, step in steps.items():
        assert step == int(MB.BLK_X[blk]) // 4 + 2 * (int(MB.BLK_Y[blk]) // 4)
    # decode order inside a step: the kernel's slots are the wave's columns
    assert all(r[0] < r[1] for r in HS.I4_WAVE if r[1] >= 0)


def test_i4_wave_reads_only_earlier_steps():
    """Every neighbour a sub-block reads inside its macroblock (left, top,
    top-left, and the top-right where _TR_SRC calls it available) lies on
    an earlier step of the wavefront."""
    steps = _wave_steps()
    for blk in range(16):
        bx, by = int(MB.BLK_X[blk]), int(MB.BLK_Y[blk])
        reads = [(bx - 4, by), (bx, by - 4), (bx - 4, by - 4)]
        if RC._TR_SRC[blk] == 0:
            reads.append((bx + 4, by - 4))
        for x, y in reads:
            nb = _block_at(x, y)
            if nb is not None:
                assert steps[nb] < steps[blk], (blk, nb)


def test_an_unavailable_top_right_stays_unavailable():
    """_TR_SRC (the kernel's c_tr_src) follows decode order (8.3.1.2,
    6.4.11.4), not the wavefront: a top-right inside the macroblock that
    decodes later is unavailable (3) even where the wavefront computes it
    first (blocks 4 and 12 come before 3 and 11); one in the macroblock to
    the right is unavailable; the top and top-right macroblocks' are read
    under a_t (1) and a_tr (2)."""
    steps = _wave_steps()
    assert steps[4] < steps[3] and steps[12] < steps[11]
    for blk in range(16):
        bx, by = int(MB.BLK_X[blk]), int(MB.BLK_Y[blk])
        tr = _block_at(bx + 4, by - 4)
        if by == 0:
            want = 1 if bx < 12 else 2
        elif tr is None or tr > blk:
            want = 3
        else:
            want = 0
        assert RC._TR_SRC[blk] == want, blk
    assert RC._TR_SRC[3] == RC._TR_SRC[11] == 3
    assert HS._TR_SRC is RC._TR_SRC
