"""The port's dequant+IDCT stage on the CPU (dequant_idct_blocks takes its
plain version, dequant_idct_reference, for CPU tensors) equals
jmcodec_tpu's Pallas kernel in interpret mode, on the cases of
tests/test_pallas_idct.py, and with the DC splice equals jmcodec_tpu's
recon._residuals. Tolerance 0: exact integer math."""

import jax
import numpy as np
import pytest
import torch

from jmcodec_tpu.kernels import pallas_idct as PK
from jmcodec_tpu.kernels import recon as JR
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon as PR
from jmcodec_tpu_torch.tools.fixtures import synth_idct_blocks

T = torch.from_numpy


def _pallas(c, qps):
    return np.asarray(PK.dequant_idct_blocks(c.astype(np.int32), qps,
                                             interpret=True))


@pytest.mark.parametrize("qp", [0, 11, 24, 37, 51])
def test_matches_pallas_kernel(qp):
    rng = np.random.default_rng(31 + qp)
    N = 700
    c = rng.integers(-200, 200, (N, 4, 4)).astype(np.int32)
    qps = np.full(N, qp, np.int32)
    got = ID.dequant_idct_blocks(T(c), T(qps))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _pallas(c, qps))


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_mixed_qp_per_block(dtype):
    rng = np.random.default_rng(32)
    N = 512
    c = rng.integers(-64, 64, (N, 4, 4)).astype(dtype)
    qps = rng.integers(0, 52, N).astype(np.int32)
    got = ID.dequant_idct_blocks(T(c), T(qps))
    assert np.array_equal(got.numpy(), _pallas(c, qps))


def test_full_range_levels_wrap_like_the_pallas_kernel():
    c, qps, _, _ = synth_idct_blocks(700, seed=5)
    assert sorted(set(qps.tolist())) == list(range(52))
    got = ID.dequant_idct_reference(T(c), T(qps))
    assert np.array_equal(got.numpy(), _pallas(c, qps))


def test_splice_replaces_dc_where_masked():
    c, qps, dc, mask = synth_idct_blocks(300, seed=6)
    plain = ID.dequant_idct_reference(T(c), T(qps)).numpy()
    got = ID.dequant_idct_reference(T(c), T(qps), T(dc), T(mask)).numpy()
    every = ID.dequant_idct_reference(T(c), T(qps), T(dc)).numpy()
    assert np.array_equal(got[~mask], plain[~mask])
    assert np.array_equal(got[mask], every[mask])
    assert not np.array_equal(got[mask], plain[mask])
    # the splice is on the dequantised DC: zero levels and dc = 64 * k give
    # a flat block of k
    z = np.zeros((4, 4, 4), np.int16)
    k = np.array([-3, 0, 1, 200], np.int32)
    flat = ID.dequant_idct_reference(T(z), T(qps[:4].copy()), T(64 * k))
    assert np.array_equal(flat.numpy(), np.broadcast_to(
        k[:, None, None], (4, 4, 4)))


def _symbol_planes(rng, mbh, mbw):
    return dict(
        luma_coeffs=rng.integers(-300, 300, (mbh * 4, mbw * 4, 4, 4)),
        luma_dc=rng.integers(-2000, 2000, (mbh, mbw, 4, 4)),
        chroma_coeffs=rng.integers(-300, 300, (2, mbh * 2, mbw * 2, 4, 4)),
        chroma_dc=rng.integers(-2000, 2000, (2, mbh, mbw, 2, 2)),
        qp=rng.integers(0, 52, (mbh, mbw)),
        mb_class=rng.integers(0, 2, (mbh, mbw)))


@pytest.mark.parametrize("coeff_dtype", [np.int16, np.int32])
def test_residuals_match_jax(coeff_dtype):
    """recon._residuals (Hadamard DC values + the spliced dequant/IDCT) on
    two frames with every qp and different chroma qp offsets."""
    rng = np.random.default_rng(33)
    mbh, mbw = 6, 9
    frames = [_symbol_planes(rng, mbh, mbw) for _ in range(2)]
    frames[0]["qp"].reshape(-1)[:52] = np.arange(52)
    offs = [(0, 0), (-3, 5)]
    jfn = jax.jit(JR._residuals)
    names = ("luma_coeffs", "luma_dc", "chroma_coeffs", "chroma_dc", "qp",
             "mb_class")
    want = [jfn(*(f[n].astype(np.int32) for n in names), np.int32(o[0]),
                np.int32(o[1])) for f, o in zip(frames, offs)]
    dts = dict(luma_coeffs=coeff_dtype, luma_dc=np.int16,
               chroma_coeffs=coeff_dtype, chroma_dc=np.int16,
               qp=np.int32, mb_class=np.int32)
    args = [T(np.stack([f[n] for f in frames]).astype(dts[n]))
            for n in names]
    off = [T(np.array([o[k] for o in offs], np.int32)) for k in (0, 1)]
    got = PR._residuals(*args, *off)
    for k in range(3):
        assert got[k].dtype == torch.int32
        for f in range(2):
            assert np.array_equal(got[k][f].numpy(), np.asarray(want[f][k]))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    c, qps, dc, mask = (T(a) for a in synth_idct_blocks(8))
    with pytest.raises(ValueError):
        ID._check(c.reshape(8, 16), qps, None, None)
    with pytest.raises(TypeError):
        ID._check(c.to(torch.int64), qps, None, None)
    with pytest.raises(TypeError):
        ID._check(c, qps.to(torch.int64), None, None)
    with pytest.raises(ValueError):
        ID._check(c, qps[:4], None, None)
    with pytest.raises(ValueError):
        ID._check(c, qps, None, mask)
    with pytest.raises(ValueError):
        ID._check(c.transpose(1, 2), qps, None, None)
    ID._check(c, qps, dc, mask)
    with pytest.raises(ValueError):
        ID.dequant_idct_blocks(c.to("meta"), qps.to("meta"))
