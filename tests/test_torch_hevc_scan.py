"""The HEVC intra scan in plane layout on the CPU (kernels/hevc_scan.py):
its plain torch version, scan_reference, equals jmcodec_tpu's scan
(hevc_tiles._intra_scan with its Pallas walk, in interpret mode on the
CPU as the package's tests run it, the skew of the planes before it and
_unskew_to_plane after it) bit for bit, on seeded planes of
tools/fixtures.synth_scan_planes (every CTB kind of synth_state_hard laid
over whole planes, a partial right CTB column) at CTU 16 and CTU 32, for
luma and for Cb + Cr of two frames on one map a frame, with and without an
inter base; decode_frames_hevc_scan routes the CPU to the torch scan and
gives what it gave before the kernel's route existed; scan_planes (the
CUDA kernel's wrapper) refuses CPU tensors and wrong arguments. The
kernel itself runs on the card (tests/test_torch_hevc_scan_cuda.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.kernels import hevc_tiles as JT
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_scan as HS
from jmcodec_tpu_torch.kernels import hevc_tables as HT
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import synth_scan_planes

DATA = os.path.join(os.path.dirname(__file__), "data")

# name: (luma CTB size, plane C, max_tu, is_chroma, strong, planes, maps,
# ctb_h, ctb_w); the skew is the luma CTB's, as the decode takes it
CASES = {"luma_ctu16": (16, 16, 32, False, True, 1, 1, 3, 3),
         "chroma_ctu16_2f": (16, 8, 16, True, False, 4, 2, 2, 3),
         "luma_ctu32": (32, 32, 32, False, True, 1, 1, 2, 3),
         "chroma_ctu32_2f": (32, 16, 16, True, False, 4, 2, 2, 2)}


def _inputs(name, inter):
    ctu, C, max_tu, chroma, strong, P, G, ctb_h, ctb_w = CASES[name]
    arrays = synth_scan_planes(C, max_tu, P, G, ctb_h, ctb_w, seed=11,
                               inter=inter, partial=True)
    kw = dict(C=C, skew=HT.skew_for(ctu), max_tu=max_tu, is_chroma=chroma,
              strong=strong)
    return arrays, kw


_JAX_SCANS = {}


def _jax_scan(resid, zidx, tu, mode, base, *, C, skew, max_tu, is_chroma,
              strong):
    """jmcodec_tpu's scan of the planes, jitted once a geometry: each
    plane's CTB tiles skewed (_skew), stacked on the lanes as its batched
    decode stacks frames, _intra_scan with the Pallas walk (interpret mode
    here; it compiles in a few seconds where the unrolled XLA walk of a
    32x32 luma CTB takes ~40), each plane unskewed (_unskew_to_plane)."""
    P, H, W = resid.shape
    G = zidx.shape[0]
    ctb_h, ctb_w = H // C, W // C
    key = (P, G, H, W, C, skew, max_tu, is_chroma, strong, base is None)
    if key not in _JAX_SCANS:
        cys, cxs, valid, has_left = JT._skew_geometry(ctb_h, ctb_w, skew)

        def lanes(planes, n):
            return jnp.concatenate([JT._skew(JT._plane_to_ctb_tiles(
                planes[p], ctb_h, ctb_w, n), cys, cxs)
                for p in range(planes.shape[0])], axis=1)

        def scan(resid, zidx, tu, mode, base):
            maps = lambda a: lanes(a[np.arange(P) % G], C // 4)
            rep = lambda a: jnp.concatenate([jnp.asarray(a)] * P, axis=1)
            t = JT._intra_scan(
                lanes(resid, C), maps(zidx), maps(tu), maps(mode), rep(valid),
                rep(has_left), C, skew, max_tu, is_chroma=is_chroma,
                strong=strong, groups=P,
                base_t=None if base is None else lanes(base, C),
                walk="pallas")
            return jnp.stack([JT._unskew_to_plane(
                t[:, p * ctb_h:(p + 1) * ctb_h], cys, cxs, valid, ctb_h,
                ctb_w, C) for p in range(P)])

        _JAX_SCANS[key] = jax.jit(scan)
    i32 = lambda a: None if a is None else jnp.asarray(a.astype(np.int32))
    return np.asarray(_JAX_SCANS[key](i32(resid), i32(zidx), i32(tu),
                                      i32(mode), i32(base)))


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
@pytest.mark.parametrize("name", list(CASES))
def test_scan_reference_matches_jax(name, inter):
    (resid, zidx, tu, mode, base), kw = _inputs(name, inter)
    got = HS.scan_reference(*(torch.from_numpy(a) for a in (resid, zidx, tu,
                                                           mode)),
                            base=None if base is None
                            else torch.from_numpy(base), **kw)
    want = _jax_scan(resid, zidx, tu, mode, base, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == resid.shape
    assert np.array_equal(got.numpy(), want)
    if inter:
        # the base passes through where no TU writes: a CTB without one is
        # its base, whatever its neighbours hold
        C, C4, G = kw["C"], kw["C"] // 4, tu.shape[0]
        ctb = lambda a, p, cy, cx, n: a[p, cy * n:(cy + 1) * n,
                                        cx * n:(cx + 1) * n]
        none = [(p, cy, cx) for p in range(resid.shape[0])
                for cy in range(resid.shape[1] // C)
                for cx in range(resid.shape[2] // C)
                if not ctb(tu, p % G, cy, cx, C4).any()]
        assert none
        for p, cy, cx in none:
            assert np.array_equal(ctb(got.numpy(), p, cy, cx, C),
                                  ctb(base, p, cy, cx, C))


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
def test_synthetic_planes_hold_their_cases(inter):
    """Every CTB kind, a TU of every size, all 35 modes, residuals at both
    int16 extremes, a partial column outside the picture."""
    (resid, zidx, tu, mode, base), kw = _inputs("luma_ctu32", inter)
    if not inter:
        assert set(np.unique(tu)) == {0, 2, 3, 4, 5}
    assert set(np.unique(mode[tu > 0])) <= set(range(35))
    assert resid.min() == -32768 and resid.max() == 32767
    assert (zidx == PT.ZIDX_NONE).any() and (zidx < 0).any()
    C4 = kw["C"] // 4
    assert not tu[:, :, -C4 // 2:].any()
    if inter:
        assert base.min() == -32768 and base.max() == 32767


@pytest.fixture(scope="module")
def small_intra():
    """The committed CTU-32 all-intra stream's plans on CPU tensors."""
    s = open(os.path.join(DATA, "hevc_128x96_ctu32.h265"), "rb").read()
    return PT.stack_plans(parse_hevc_intra_plans(s), torch.device("cpu"))


def test_decode_scan_on_the_cpu_is_the_torch_scan(small_intra):
    """On CPU tensors decode_frames_hevc_scan takes the torch scan, and it
    gives what the skewed scan gave before the kernel's route: the
    scan_reference of the planes, luma and Cb + Cr."""
    args = small_intra
    Hp, Wp, log2_ctb, strong = args[:4]
    Y, U, V = PT.decode_frames_hevc_scan(*args[:4], *args[9:21])
    ref = PT.decode_frames_hevc_scan(*args[:4], *args[9:21],
                                     walk_fn=HW.walk_reference)
    for a, b in zip((Y, U, V), ref):
        assert torch.equal(a, b)
    nf, C = Y.shape[0], 1 << log2_ctb
    i32 = lambda a: a.to(torch.int32)
    coeff_y, tu_y, mode_y, zidx_y, qp_y = map(i32, args[9:14])
    resid = HR.residual_reference(coeff_y, qp_y, tu_y, True, (2, 3, 4, 5))
    want = HS.scan_reference(
        resid.clamp(-32768, 32767).to(torch.int16), zidx_y, tu_y, mode_y,
        C=C, skew=HT.skew_for(C), max_tu=32, is_chroma=False, strong=strong)
    assert torch.equal(Y, want) and Y.shape == (nf, Hp, Wp)
    assert U.shape == V.shape == (nf, Hp // 2, Wp // 2)
    assert not torch.equal(U, V)


def test_route_predicate():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert PT.scan_kernel(cuda) is True
    assert PT.scan_kernel(cpu) is False
    assert PT.scan_kernel(cuda, walk_fn=HW.walk_reference) is False
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        PT.scan_kernel(torch.device("meta"))


def _cpu_args(inter=False):
    (resid, zidx, tu, mode, base), kw = _inputs("luma_ctu16", inter)
    t = lambda a: None if a is None else torch.from_numpy(a)
    return [t(resid), t(zidx), t(tu), t(mode)], dict(kw, base=t(base))


def test_scan_planes_refuses_cpu_tensors():
    args, kw = _cpu_args(inter=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        HS.scan_planes(*args, **kw)
    assert HS.LAUNCHES == 0


@pytest.mark.parametrize("bad", ["resid_int32", "zidx_int16", "base_int32",
                                 "resid_shape", "maps_not_dividing",
                                 "not_contiguous", "geometry"])
def test_scan_planes_checks_its_arguments(bad):
    args, kw = _cpu_args(inter=True)
    resid, zidx, tu, mode = args
    err = ValueError
    if bad == "resid_int32":
        args[0], err = resid.to(torch.int32), TypeError
    elif bad == "zidx_int16":
        args[1], err = zidx.to(torch.int16), TypeError
    elif bad == "base_int32":
        kw["base"], err = kw["base"].to(torch.int32), TypeError
    elif bad == "resid_shape":
        args[0] = resid[:, :-4]
    elif bad == "maps_not_dividing":
        args[1:] = [torch.cat([a, a]) for a in (zidx, tu, mode)]
        args[0] = torch.cat([resid] * 3)
        kw["base"] = torch.cat([kw["base"]] * 3)
    elif bad == "not_contiguous":
        wide = torch.zeros((*tu.shape[:2], 2 * tu.shape[2]), dtype=tu.dtype)
        wide[..., ::2] = tu
        args[2] = wide[..., ::2]
    elif bad == "geometry":
        kw["max_tu"] = 2
    with pytest.raises(err):
        HS.scan_planes(*args, **kw)
