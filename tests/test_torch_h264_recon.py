"""The port's H.264 intra predictors, one wavefront step and the deblock
scan (jmcodec_tpu_torch.kernels.recon / recon_tiles) equal jmcodec_tpu's on
the CPU backend, bit for bit, on seeded random inputs. The port's tensors
carry a leading frame axis; the JAX functions run once per frame (one jit
per shape)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.kernels import recon as JR
from jmcodec_tpu.kernels import recon_tiles as JRT
from jmcodec_tpu_torch.kernels import recon as PR
from jmcodec_tpu_torch.kernels import recon_tiles as PRT

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
I32 = lambda a: np.asarray(a).astype(np.int32)


def test_tr_src_table_matches():
    assert np.array_equal(PR._TR_SRC, JR._TR_SRC)


def test_pred_i4_all_modes_and_availability():
    """Every mode 0..8 under every (top, left) availability."""
    rng = np.random.default_rng(41)
    modes = np.repeat(np.arange(9), 4 * 6).astype(np.int32)
    B = modes.size
    av = np.tile(np.repeat(np.arange(4), 6), 9)
    a_t, a_l = (av & 1) == 1, (av & 2) == 2
    n = rng.integers(0, 256, (B, 13)).astype(np.int32)
    want = np.asarray(JR._pred_i4_batch(jnp.asarray(n), jnp.asarray(modes),
                                        jnp.asarray(a_t), jnp.asarray(a_l)))
    got = PR._pred_i4_batch(T(n), T(modes), T(a_t), T(a_l))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 4, 4)
    assert np.array_equal(got.numpy(), want)
    # leading axes are free: the same as two frames of B / 2 lanes
    two = PR._pred_i4_batch(*(T(a.reshape(2, B // 2, *a.shape[1:]))
                              for a in (n, modes, a_t, a_l)))
    assert np.array_equal(two.numpy().reshape(B, 4, 4), want)


@pytest.mark.parametrize("size,jfn,pfn", [
    (16, JR._pred_16_batch, PR._pred_16_batch),
    (8, JR._pred_chroma_batch, PR._pred_chroma_batch)], ids=["i16", "chroma"])
def test_pred_16_and_chroma(size, jfn, pfn):
    """Every mode 0..3 under every availability; steep ramps push the plane
    mode into its clip."""
    rng = np.random.default_rng(42)
    mode = np.repeat(np.arange(4), 4 * 8).astype(np.int32)
    B = mode.size
    av = np.tile(np.repeat(np.arange(4), 8), 4)
    a_t, a_l = (av & 1) == 1, (av & 2) == 2
    t = rng.integers(0, 256, (B, size)).astype(np.int32)
    l = rng.integers(0, 256, (B, size)).astype(np.int32)
    t[::3] = np.clip(np.arange(size) * (255 // (size - 1)), 0, 255)
    l[::5] = np.clip(255 - np.arange(size) * (255 // (size - 1)), 0, 255)
    tl = rng.integers(0, 256, B).astype(np.int32)
    want = np.asarray(jfn(*(jnp.asarray(a) for a in (t, l, tl, mode, a_t,
                                                      a_l))))
    got = pfn(*(T(a) for a in (t, l, tl, mode, a_t, a_l)))
    assert tuple(got.shape) == (B, size, size)
    assert np.array_equal(got.numpy(), want)


def _step_inputs(rng, B):
    tile = lambda n: rng.integers(0, 256, (B, n, n)).astype(np.int32)
    carry = tuple(tile(n) for n in (16, 16, 16, 8, 8, 8, 8, 8, 8))
    flag = lambda: rng.integers(0, 2, B).astype(np.int32)
    xs = (rng.integers(-60, 60, (B, 16, 16)).astype(np.int32),
          rng.integers(-60, 60, (B, 8, 8)).astype(np.int32),
          rng.integers(-60, 60, (B, 8, 8)).astype(np.int32),
          rng.integers(0, 9, (B, 4, 4)).astype(np.int32),
          flag(), rng.integers(0, 4, B).astype(np.int32),
          rng.integers(0, 4, B).astype(np.int32), flag(), flag(), flag())
    valid = (rng.integers(0, 4, B) > 0).astype(np.int32)
    return carry, xs, valid


def test_intra_step_matches_jax():
    """One wavefront step on two frames of 24 lanes: random carry, every
    I4 mode, both classes, every availability; the lanes' valid flags are
    shared by the frames, as in the decode."""
    rng = np.random.default_rng(43)
    B = 24
    carry0, xs0, valid = _step_inputs(rng, B)
    carry1, xs1, _ = _step_inputs(rng, B)
    jstep = jax.jit(functools.partial(JRT._intra_step, has_inter=False))
    want = [jstep(c, (*x, valid)) for c, x in ((carry0, xs0), (carry1, xs1))]
    stack = lambda a, b: T(np.stack([a, b]))
    carry = tuple(stack(a, b) for a, b in zip(carry0, carry1))
    xs = tuple(stack(a, b) for a, b in zip(xs0, xs1))
    new_carry, ys = PRT._intra_step(carry, (*xs, T(valid)))
    for f in range(2):
        wc, wy = want[f]
        for k in range(9):
            assert np.array_equal(new_carry[k][f].numpy(), np.asarray(wc[k]))
        for k in range(3):
            assert np.array_equal(ys[k][f].numpy(), np.asarray(wy[k]))
    # the carry's inputs were not written
    assert np.array_equal(carry[0][0].numpy(), carry0[0])


@pytest.mark.parametrize("mbh,mbw", [(3, 4), (2, 7)])
def test_deblock_scan_matches_jax(mbh, mbw):
    """The whole deblock scan of a small geometry on two frames with
    different qp planes, filter offsets and chroma qp offsets. Low-contrast
    tiles, so that most edges pass the alpha/beta tests, strong ones too."""
    rng = np.random.default_rng(44 + mbh)
    mys, mxs, valid = PRT._skew_geometry(mbh, mbw)
    jg = JRT._skew_geometry(mbh, mbw)
    for a, b in zip((mys, mxs, valid), jg):
        assert np.array_equal(a, b)
    n_steps = mys.shape[0]
    vm = valid[..., None, None]

    def frame():
        base = rng.integers(60, 180, (n_steps, mbh, 1, 1))
        Y = (base + rng.integers(-6, 7, (n_steps, mbh, 16, 16))) * vm
        U = (base + rng.integers(-4, 5, (n_steps, mbh, 8, 8))) * vm
        V = (base + rng.integers(-9, 10, (n_steps, mbh, 8, 8))) * vm
        qp = rng.integers(20, 52, (n_steps, mbh)) * valid
        return [I32(a) for a in (Y, U, V, qp)]
    frames = [frame(), frame()]
    offs = [(0, 0, 0, 0), (4, -2, -3, 6)]
    jscan = jax.jit(functools.partial(JRT._deblock_tile_scan_intra,
                                      bmax=mbh))
    want = [jscan(*f, jnp.asarray(mxs), jnp.asarray(mys), jnp.asarray(valid),
                  alpha_off=np.int32(o[0]), beta_off=np.int32(o[1]),
                  chroma_qp_off=np.int32(o[2]),
                  second_chroma_qp_off=np.int32(o[3]))
            for f, o in zip(frames, offs)]
    args = [T(np.stack([frames[0][k], frames[1][k]])) for k in range(4)]
    before = [a.clone() for a in args]
    off = [T(np.array([o[k] for o in offs], np.int32)) for k in range(4)]
    got = PRT._deblock_tile_scan_intra(*args, T(mxs), T(mys), T(valid), *off)
    changed = 0
    for k in range(3):
        assert tuple(got[k].shape) == tuple(args[k].shape)
        for f in range(2):
            w = np.asarray(want[f][k])
            assert np.array_equal(got[k][f].numpy(), w)
            changed += int((w != frames[f][k]).sum())
    assert changed > 1000, "the filter hardly touched the tiles"
    for a, b in zip(args, before):
        assert torch.equal(a, b), "the scan wrote its inputs"


def test_skew_roundtrip():
    rng = np.random.default_rng(45)
    mbh, mbw = 3, 5
    mys, mxs, valid = (T(a) for a in PRT._skew_geometry(mbh, mbw))
    blocks = T(rng.integers(0, 256, (2, mbh * 4, mbw * 4, 4, 4))
               .astype(np.int32))
    tiles = PRT._to_tiles(blocks, mbh, mbw, 4)
    want = np.asarray(jnp.stack([JRT._to_tiles(jnp.asarray(b.numpy()), mbh,
                                               mbw, 4) for b in blocks]))
    assert np.array_equal(tiles.numpy(), want)
    sk = PRT._skew(tiles, mys.long(), mxs.long())
    assert tuple(sk.shape) == (2, mbw + 2 * (mbh - 1), mbh, 16, 16)
    frame = PRT._unskew_to_frame(sk, mys, mxs, valid, mbh, mbw, 16)
    assert np.array_equal(
        frame.numpy(),
        tiles.permute(0, 1, 3, 2, 4).reshape(2, mbh * 16, mbw * 16).numpy())
