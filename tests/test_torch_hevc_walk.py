"""The port's plain TU walk (hevc_walk.walk_reference, which walk() uses
for CPU tensors) equals jmcodec_tpu's XLA walk (hevc_tiles._make_walk) and
its Pallas walk (make_pallas_walk, interpret mode on the CPU) bit for bit,
on seeded synthetic scan-step states: the chroma shape of
test_hevc_walk_variants.py, a 32x32 luma shape with strong smoothing, and
the hard states of synth_state_hard (all-4x4 lanes, a lone largest TU,
lanes without a TU, z-scan Z, unavailable border patches, residuals at the
int16 extremes) at C = 16 and C = 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.kernels import hevc_tiles as JT
from jmcodec_tpu.kernels.hevc_walk_pallas import make_pallas_walk
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import (HARD_KINDS, synth_state,
                                              synth_state_hard)

# (C, max_tu, is_chroma, strong, skew): skew as the scan uses for the CTU
CASES = {"chroma32": (32, 16, True, False, 2),
         "luma32_strong": (32, 32, False, True, 3)}


def _state(name):
    C, max_tu, chroma, strong, skew = CASES[name]
    st = synth_state(C, max_tu, B=4, seed=5, skew=skew)
    kw = dict(C=C, max_tu=max_tu, is_chroma=chroma, strong=strong)
    return st, kw


@pytest.fixture(scope="module")
def xla_walk():
    """jmcodec_tpu's XLA walk (hevc_tiles._make_walk) of a geometry (C,
    max_tu, is_chroma, strong), jitted once for the module: levels above
    size 8 as fori_loops, the same candidate order and arithmetic, but the
    walk compiles once a shape instead of dispatching its ops eagerly
    (~3x faster on the CPU), and the synthetic and hard states of a
    geometry share the function."""
    walks = {}

    def get(C, max_tu, is_chroma, strong):
        key = (C, max_tu, is_chroma, strong)
        if key not in walks:
            walks[key] = jax.jit(JT._make_walk(*key, unroll_below=8))
        return walks[key]
    return get


def _jax_args(st):
    F, Z, R, T, M = st
    return (jnp.asarray(F.astype(np.int32)), jnp.asarray(Z),
            jnp.asarray(R.astype(np.int32)), jnp.asarray(T), jnp.asarray(M))


@pytest.mark.parametrize("variant", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_walk_reference_matches_jax(name, variant, xla_walk):
    st, kw = _state(name)
    got = HW.walk(*map(torch.from_numpy, st), **kw)   # CPU -> reference
    assert got.dtype == torch.int16
    if variant == "xla":
        jwalk = xla_walk(kw["C"], kw["max_tu"], kw["is_chroma"],
                         kw["strong"])
    else:
        jwalk = make_pallas_walk(kw["C"], kw["max_tu"], kw["is_chroma"],
                                 kw["strong"])
    want = np.asarray(jwalk(*_jax_args(st)))
    assert np.array_equal(got.numpy().astype(np.int32), want)


# (C, max_tu, is_chroma, strong, skew)
HARD_CASES = {"hard_luma16": (16, 16, False, False, 3),
              "hard_luma32_strong": (32, 32, False, True, 3),
              "hard_chroma32": (32, 16, True, False, 2)}


def _hard_state(name):
    C, max_tu, chroma, strong, skew = HARD_CASES[name]
    st = synth_state_hard(C, max_tu, B=len(HARD_KINDS), seed=3, skew=skew)
    kw = dict(C=C, max_tu=max_tu, is_chroma=chroma, strong=strong)
    return st, kw


@pytest.mark.parametrize("name", list(HARD_CASES))
def test_walk_reference_matches_jax_on_hard_states(name, xla_walk):
    st, kw = _hard_state(name)
    got = HW.walk(*map(torch.from_numpy, st), **kw)   # CPU -> reference
    jwalk = xla_walk(kw["C"], kw["max_tu"], kw["is_chroma"], kw["strong"])
    want = np.asarray(jwalk(*_jax_args(st)))
    assert np.array_equal(got.numpy().astype(np.int32), want)


@pytest.mark.parametrize("name", list(HARD_CASES))
def test_hard_state_holds_its_cases(name):
    """One lane of each kind, and each kind does what it is there for."""
    (F, Z, resid, tu, mode), kw = _hard_state(name)
    C4, T = kw["C"] // 4, min(kw["C"], kw["max_tu"])
    assert (tu[0] == 2).all()                                 # all 4x4
    assert (tu[1] > 0).sum() == 1 and tu[1, 0, 0] == T.bit_length() - 1
    assert not tu[2].any()
    assert resid.min() == -32768 and resid.max() == 32767
    assert (Z[5, 0] == Z[5, 0, 0]).all() and (Z[5, :, 0] == Z[5, 0, 0]).all()
    assert Z[0, 1, 2] == 1 and Z[0, 2, 1] == 2                # z-scan order
    # border patches: available and unavailable ones on both borders
    assert len(set(Z[0, 0].tolist())) == 2
    assert len(set(Z[:5, :, 0].ravel().tolist())) == 2
    out = HW.walk_reference(*map(torch.from_numpy, (F, Z, resid, tu, mode)),
                            **kw).numpy()
    assert np.array_equal(out[2], F[2])                       # no TU: unchanged
    blocks = out[4, 1:1 + kw["C"], 1:1 + kw["C"]]
    assert blocks.min() == 0 and blocks.max() == 255          # clipped both ways
    assert C4 * C4 == (tu[0] > 0).sum()


def test_synth_state_reaches_strong_smoothing():
    st, kw = _state("luma32_strong")
    args = list(map(torch.from_numpy, st))
    strong = HW.walk_reference(*args, **kw)
    weak = HW.walk_reference(*args, **dict(kw, strong=False))
    assert not torch.equal(strong, weak)


def test_walk_rejects_unknown_device():
    st, kw = _state("chroma32")
    args = [torch.from_numpy(a).to("meta") for a in st]
    with pytest.raises(ValueError):
        HW.walk(*args, **kw)
