"""The port's HEVC residual stage equals jmcodec_tpu's _residual_plane bit
for bit (tolerance 0: exact integer codec). The plain version
(kernels/hevc_resid.py: residual_reference, dequant + float64 inverse
DCT/DST) on seeded random levels that reach both dequant paths and the
int16 clips, at one size and mixed, intra luma (the DST) and the inter
form (the DCT at 4x4), with maps holding 0 and values outside `sizes`;
planes_reference, the kernel's plain version in its layout, with the
batch's chroma QP through chroma_qp and per-frame offsets, and its int16
output (the sum of overlapping blocks, which int16 holds); the constants
the kernel embeds against the codec's, and a numpy model of its partial
butterflies against the matrix products; resid_planes' checks and its CPU
dispatch; and the residual stage's two routes in hevc_tiles. The kernel
itself runs only on the card (tests/test_torch_hevc_resid_cuda.py)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.kernels import hevc_tiles as JT
from jmcodec_tpu_torch.codec.hevc import transform as HTR
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_tables as HT
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.tools.fixtures import synth_resid_planes

CSRC = os.path.join(os.path.dirname(HR.__file__), "..", "csrc",
                    "hevc_resid.cu")


def _inputs(rng, frames, Hp, Wp, sizes, extra=()):
    coeff = rng.integers(-400, 401, (frames, Hp, Wp))
    big = rng.random((frames, Hp, Wp)) < 0.02       # reach the int16 clips
    coeff[big] = rng.choice([-32768, 32767], big.sum())
    qp = rng.integers(0, 52, (frames, Hp // 4, Wp // 4))
    tu = rng.choice(np.asarray([*sizes, *extra]), (frames, Hp // 4, Wp // 4))
    return (coeff.astype(np.int32), qp.astype(np.int32),
            tu.astype(np.int32))


_jax_residual = jax.jit(JT._residual_plane, static_argnums=(3, 4))


def _jax_planes(coeff, qp, tu, luma, sizes):
    return np.stack([np.asarray(_jax_residual(
        jnp.asarray(coeff[f]), jnp.asarray(qp[f]), jnp.asarray(tu[f]), luma,
        sizes)) for f in range(coeff.shape[0])])


def _check(coeff, qp, tu, luma, sizes):
    got = HR.residual_reference(torch.from_numpy(coeff), torch.from_numpy(qp),
                                torch.from_numpy(tu), luma, sizes).numpy()
    want = _jax_planes(coeff, qp, tu, luma, sizes)
    for f in range(coeff.shape[0]):
        assert np.array_equal(got[f], want[f]), f"frame {f}"
    return want


@pytest.mark.parametrize("luma,log2", [(True, 2), (False, 2), (True, 3),
                                       (True, 4), (True, 5), (False, 4)],
                         ids=["dst4", "dct4", "dct8", "dct16", "dct32",
                              "chroma16"])
def test_residual_one_size(luma, log2):
    rng = np.random.default_rng(10 + log2 + 7 * luma)
    _check(*_inputs(rng, 1, 64, 96, (log2,)), luma, (log2,))


@pytest.mark.parametrize("luma", [True, False])
def test_residual_mixed_sizes_batched(luma):
    sizes = (2, 3, 4, 5) if luma else (2, 3, 4)
    rng = np.random.default_rng(3 + luma)
    _check(*_inputs(rng, 2, 64, 64, sizes), luma, sizes)


@pytest.mark.parametrize("luma,sizes,extra",
                         [(False, (2, 3, 4, 5), (0,)),
                          (True, (2, 3, 4, 5), (0, 1, 6)),
                          (False, (2, 3, 4), (0, 5))],
                         ids=["inter_luma", "luma_outside", "chroma_5"])
def test_residual_maps_outside_sizes(luma, sizes, extra):
    """The inter form (the DCT at 4x4 on a luma plane) and maps holding 0
    and values outside `sizes`: those cells' blocks contribute nothing."""
    rng = np.random.default_rng(40 + len(extra))
    coeff, qp, tu = _inputs(rng, 2, 64, 64, sizes, extra)
    want = _check(coeff, qp, tu, luma, sizes)
    assert np.isin(tu, extra).mean() > 0.1 and np.abs(want).max() > 0


def test_planes_reference_chroma_qp_batch():
    """planes_reference on Cb + Cr of a batch, each frame's offsets apart:
    the JAX batch's chroma QP (QPC_T of the clipped qp_y[::2, ::2] +
    offset) through _residual_plane, Cb of every frame, then Cr, in
    int16."""
    coeffs, tu, qp, offs = synth_resid_planes(3, 32, 48, seed=7,
                                              chroma=True, sizes=(2, 3, 4))
    offs = (np.array([-12, 3, 12], np.int32), offs[1])
    got = HR.planes_reference(
        tuple(torch.from_numpy(c) for c in coeffs), torch.from_numpy(tu),
        torch.from_numpy(qp), sizes=(2, 3, 4),
        offsets=tuple(torch.from_numpy(o) for o in offs)).numpy()
    assert got.dtype == np.int16 and got.shape == (6, 32, 48)
    for k, (c, off) in enumerate(zip(coeffs, offs)):
        q = JT._QPC_T[np.clip(qp[:, ::2, ::2].astype(np.int32)
                              + off[:, None, None], 0, 57)]
        want = _jax_planes(c.astype(np.int32), q, tu.astype(np.int32), False,
                           (2, 3, 4))
        assert np.array_equal(got[3 * k:3 * k + 3],
                              np.clip(want, -32768, 32767))
    q_t = HR.chroma_qp(torch.from_numpy(qp).to(torch.int32),
                       torch.from_numpy(offs[0]))
    assert set(q_t[0].unique().tolist()) <= {0, *range(52)}
    assert q_t.shape == (3, 8, 12)


def test_planes_reference_int16_holds_the_sum():
    """The int16 output loses nothing: a pixel lies in at most one block of
    each size, and a size adds at most (32767 sum_i |M(i, j)| + 2048) >>
    12 (the column stage's clip bounds its row), 28,224 over the four
    DCTs' largest columns (the DST's are smaller), below 2^15. Blocks of
    all four sizes overlapping on levels at the int16 extremes and QP 51
    (saturated dequantisation): the JAX int32 sum, and planes_reference's
    int16 planes equal to it."""
    row = lambda m: (32767 * int(np.abs(m).sum(0).max()) + 2048) >> 12
    assert sum(row(HTR.DCT[n]) for n in (4, 8, 16, 32)) == 28224
    assert row(HTR.DST4) <= row(HTR.DCT[4])
    rng = np.random.default_rng(11)
    coeff = rng.choice(np.array([-32768, 32767]), (2, 64, 64))
    qp = np.full((2, 16, 16), 51)
    tu = np.zeros((2, 16, 16), np.int64)
    for y0 in (0, 8):                # four nested origins a 32x32 region
        for x0 in (0, 8):
            tu[:, y0, x0], tu[:, y0 + 4, x0 + 4] = 5, 4
            tu[:, y0 + 6, x0 + 6], tu[:, y0 + 7, x0 + 7] = 3, 2
    want = _jax_planes(coeff.astype(np.int32), qp.astype(np.int32),
                       tu.astype(np.int32), True, (2, 3, 4, 5))
    assert 4000 < np.abs(want).max() <= 28224
    got = HR.planes_reference(
        (torch.from_numpy(coeff.astype(np.int16)),),
        torch.from_numpy(tu.astype(np.int8)),
        torch.from_numpy(qp.astype(np.int8)), sizes=(2, 3, 4, 5), dst4=True)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)


def _cu_constants():
    """The constants csrc/hevc_resid.cu embeds: dct_basis's and dst4's
    cases, its __constant__ arrays."""
    src = open(CSRC).read()

    def cases(fn):
        body = src[src.index(f"constexpr int {fn}(int"):]
        body = body[:body.index("\n}\n")]
        got = re.findall(r"case (\d+): return (-?\d+);", body)
        assert [int(k) for k, _ in got] == list(range(len(got)))
        return np.array([int(v) for _, v in got])

    arrays = {name: np.array([int(v) for v in body.split(",")])
              for name, n, body in re.findall(
                  r"__constant__ int (\w+)\[(\d+)\] = \{([^}]*)\};", src)
              if len(body.split(",")) == int(n)}
    return src, cases("dct_basis"), cases("dst4"), arrays


def _cos64(basis, a):
    """csrc/hevc_resid.cu's cos64: 64 cos(a pi / 64) from the basis."""
    a, s = a & 127, 1
    if a > 64:
        a, s = a - 64, -1
    if a > 32:
        a, s = 64 - a, -s
    return s * int(basis[a])


def _cu_dct(basis, n):
    """csrc/hevc_resid.cu's dct<n>(k, j) as an n x n matrix."""
    return np.array([[_cos64(basis, k * (32 // n) * (2 * j + 1))
                      for j in range(n)] for k in range(n)])


def test_kernel_table_is_the_codecs():
    """The constants the kernel embeds are the codec's: the DCT matrices
    its dct<n>(k, j) builds from dct_basis (the 32-point DCT's first
    column) by symmetry equal transform.DCT[n] at every size, dst4 equals
    DST4, and its constant memory holds LEVEL_SCALE and QPC_T (the JAX
    package's _QPC_T) and no transform matrix."""
    src, basis, dst, arrays = _cu_constants()
    assert len(basis) == 33 and len(dst) == 16
    for n in (4, 8, 16, 32):
        assert np.array_equal(_cu_dct(basis, n), HTR.DCT[n])
    assert np.array_equal(dst.reshape(4, 4), HTR.DST4)
    assert set(arrays) == {"kLevelScale", "kQpcT"}
    assert np.array_equal(arrays["kLevelScale"], HTR.LEVEL_SCALE)
    assert np.array_equal(arrays["kQpcT"], HT.QPC_T)
    assert np.array_equal(HT.QPC_T, JT._QPC_T)
    assert "kTab" not in src and "tab[" not in src


def _butterfly(x, n, basis):
    """A numpy model of csrc/hevc_resid.cu's idct<n> on the columns of x
    [n, cols]: the even inputs through the n/2-point butterfly, the odd
    ones through the odd rows' products, y[j] = E[j] + O[j], y[n-1-j] =
    E[j] - O[j]; only x[0] may leave int16 (its rounding bias)."""
    if n == 1:
        return _cos64(basis, 0) * x
    e = _butterfly(x[0::2], n // 2, basis)
    odd = np.array([[_cos64(basis, (2 * m + 1) * (32 // n) * (2 * j + 1))
                     for m in range(n // 2)] for j in range(n // 2)])
    # the kernel takes the odd inputs two at a time (__dp2a_lo): int16
    # inputs against int8 entries
    assert -32768 <= x[1::2].min() and x[1::2].max() <= 32767
    assert np.abs(odd).max() <= 127
    o = odd @ x[1::2]
    return np.concatenate([e + o, (e - o)[::-1]])


def _fast_dst(x, bias, dst):
    """A numpy model of csrc/hevc_resid.cu's idst4 (HM's fastInverseDst)
    on the columns of x [4, cols], with the rounding bias."""
    a, b, c = dst[0], dst[1], dst[2]
    c0, c1, c2 = x[0] + x[2], x[2] + x[3], x[0] - x[3]
    c3 = c * x[1] + bias
    return np.stack([a * c0 + b * c1 + c3, b * c2 - a * c1 + c3,
                     c * (x[0] - x[2] + x[3]) + bias,
                     b * c0 + a * c2 - (c3 - 2 * bias)])


def _stage(x, n, bias, basis, dst):
    """One stage of the kernel's transform before its shift: the DST, or
    the DCT with its rounding bias on the DC input (row 0 is 64)."""
    if dst is not None:
        return _fast_dst(x, bias, dst)
    x = x.copy()
    x[0] += bias // 64
    return _butterfly(x, n, basis)


@pytest.mark.parametrize("n", [4, 8, 16, 32, "dst4"])
def test_butterfly_is_the_matrix_product(n):
    """The kernel's decomposition (modelled in numpy on the constants the
    .cu embeds) equals the direct products of transform.DCT[n] / DST4 on
    seeded int16 columns with the extremes, both stages' rounding biases
    included and every partial sum below 2^27; and the two stages with
    their shifts and clips equal hevc_resid's plain _itransform_blocks on
    seeded blocks."""
    _, basis, dst, _ = _cu_constants()
    is_dst = n == "dst4"
    n = 4 if is_dst else n
    m = (HTR.DST4 if is_dst else HTR.DCT[n]).astype(np.int64)
    rng = np.random.default_rng(n + 100 * is_dst)
    x = rng.integers(-32768, 32768, (n, 256))
    x[:, :4] = [-32768, 32767, 0, 1]                # constant columns
    x[:, 4] = np.where(m[:, 0] < 0, -32768, 32767)  # the largest sum
    x[:, 5] = -x[:, 4] - 1
    for bias in (0, 64, 2048):
        got = _stage(x, n, bias, basis, dst if is_dst else None)
        want = m.T @ x + bias
        assert np.array_equal(got, want)
        assert np.abs(got).max() < 2 ** 27
    blocks = rng.integers(-32768, 32768, (8, n, n))
    blocks[0] = 32767
    clip = lambda v: np.clip(v, -32768, 32767)
    want = HR._itransform_blocks(torch.from_numpy(blocks.astype(np.int32)),
                                 n.bit_length() - 1, is_dst).numpy()
    for b, w in zip(blocks, want):
        d = dst if is_dst else None
        e = clip(_stage(b, n, 64, basis, d) >> 7)
        r = clip(_stage(e.T, n, 2048, basis, d) >> 12).T
        assert np.array_equal(r, w)


def _small(chroma):
    sizes = (2, 3, 4) if chroma else (2, 3, 4, 5)
    coeffs, tu, qp, offs = synth_resid_planes(2, 32, 32, seed=3,
                                              chroma=chroma, sizes=sizes)
    t = torch.from_numpy
    return ([t(c) for c in coeffs], t(tu), t(qp),
            None if offs is None else [t(o) for o in offs], sizes)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_resid_planes_cpu_dispatch(chroma):
    """On CPU tensors resid_planes is planes_reference, with no launch."""
    coeffs, tu, qp, offs, sizes = _small(chroma)
    n = HR.LAUNCHES
    got = HR.resid_planes(tuple(coeffs), tu, qp, sizes=sizes,
                          dst4=not chroma,
                          offsets=None if offs is None else tuple(offs))
    want = HR.planes_reference(tuple(coeffs), tu, qp, sizes=sizes,
                               dst4=not chroma,
                               offsets=None if offs is None else tuple(offs))
    assert HR.LAUNCHES == n and torch.equal(got, want)
    assert got.shape == (2 * len(coeffs), 32, 32) and got.any()


def test_resid_planes_checks():
    """The kernel's wrapper refuses what the kernel does not take, before
    its device check, and raises on a tensor that is not a CUDA one."""
    coeffs, tu, qp, offs, sizes = _small(True)
    meta = lambda a: torch.empty_like(a, device="meta")
    c2 = tuple(map(meta, coeffs))
    args = dict(sizes=sizes, offsets=tuple(map(meta, offs)))
    mtu, mqp = meta(tu), meta(qp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        HR._check(c2, mtu, mqp, sizes, args["offsets"])
    bad = [
        ((c2[0].to(torch.int32), c2[1]), mtu, mqp, args, TypeError),
        (c2, mtu.to(torch.int32), mqp, args, TypeError),
        (c2, mtu, mqp[:, :8], args, ValueError),
        (c2, mtu, mqp, dict(args, sizes=(1, 2)), ValueError),
        (c2, mtu, mqp, dict(args, sizes=()), ValueError),
        (c2, mtu, mqp, dict(args, sizes=(2,)), ValueError),
        (c2, mtu, mqp, dict(args, sizes=HR.LUMA_SIZES), ValueError),
        (c2, mtu, mqp, dict(args, offsets=args["offsets"][:1]), ValueError),
        (c2, mtu, mqp, dict(args, offsets=(args["offsets"][0],
                                           meta(tu)[:, 0, 0])), TypeError),
        (c2 * 2, mtu, mqp, args, ValueError),
        ((c2[0].transpose(1, 2), c2[1]), mtu, mqp, args, ValueError),
        (tuple(c[:, :24] for c in c2), mtu[:, :6], mqp[:, :12], args,
         ValueError),
    ]
    for c, t, q, kw, exc in bad:
        with pytest.raises(exc):
            HR._check(c, t, q, kw["sizes"], kw["offsets"])
        with pytest.raises(exc):
            HR.resid_planes(c, t, q, **kw)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_residual_stage_routes(chroma):
    """The residual stage's two routes in hevc_tiles (scan_kernel's:
    resid_planes, else planes_reference) give the same int16 planes on
    CPU tensors, also on int32 maps and levels, and the CPU takes the
    plain route."""
    assert not PT.scan_kernel(torch.device("cpu"))
    coeffs, tu, qp, offs, sizes = _small(chroma)
    kw = dict(sizes=sizes, dst4=not chroma,
              offsets=None if offs is None else tuple(offs))
    want = HR.planes_reference(tuple(coeffs), tu, qp, **kw)
    i32 = lambda a: a.to(torch.int32)
    for fn in (HR.planes_reference, HR.resid_planes):
        got = fn(tuple(map(i32, coeffs)), i32(tu), i32(qp), **kw)
        assert got.dtype == torch.int16 and torch.equal(got, want)
