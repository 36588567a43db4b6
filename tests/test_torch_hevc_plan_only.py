"""HevcRefDecoder(plan_only=True) of the port against the JAX package's, on
the CPU: on two small all-intra x265 streams (CTU 16; cu_qp_delta at CTU
32) the plans are equal field by field, and the port's decode of its plans
equals the libavcodec digests; on a stream whose second picture is P both
decoders stop there with the same NotImplementedError, after the same
plan of its I picture.
"""

import hashlib

import numpy as np
import pytest

from jmcodec_tpu.codec.hevc.refdec import HevcRefDecoder as JaxDecoder
from jmcodec_tpu_torch.codec.hevc.refdec import HevcRefDecoder
from jmcodec_tpu_torch.kernels.hevc_tiles import decode_plans_batch
from jmcodec_tpu_torch.tools.fixtures import session_fixture


def assert_plans_equal(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        va, vb = vars(a), vars(b)
        assert sorted(va) == sorted(vb)
        for k, x in va.items():
            y = vb[k]
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert isinstance(x, np.ndarray) and isinstance(y,
                                                                np.ndarray), k
                assert x.dtype == y.dtype and np.array_equal(x, y), \
                    f"plan {i} field {k}"
            else:
                assert x == y, f"plan {i} field {k}: {x!r} != {y!r}"


def plans_of(cls, stream):
    dec = cls(plan_only=True)
    frames = dec.decode(stream)
    assert not frames
    return dec.plans


@pytest.mark.parametrize("name", ["hevc_ctu16_64x64",
                                  "hevc_cuqp_intra_192x128"])
def test_plans_equal_the_jax_decoders(name):
    stream, digests = session_fixture(name, ".h265")
    plans = plans_of(HevcRefDecoder, stream)
    assert_plans_equal(plans, plans_of(JaxDecoder, stream))
    assert all(p.supported and p.inter4 is None for p in plans)
    Y, U, V = decode_plans_batch(plans, "cpu")
    for i, d in enumerate(digests):
        for plane, t in zip("YUV", (Y[i], U[i], V[i])):
            assert hashlib.sha256(np.ascontiguousarray(
                t.numpy())).hexdigest() == d[plane], f"frame {i} {plane}"


def test_an_inter_picture_raises_as_in_the_jax_decoder():
    stream, _ = session_fixture("hevc_cuqp_p_64x64", ".h265")
    decs = []
    for cls in (HevcRefDecoder, JaxDecoder):
        dec = cls(plan_only=True)
        with pytest.raises(NotImplementedError,
                           match="HEVC inter device plan"):
            dec.decode(stream)
        decs.append(dec)
    assert_plans_equal(decs[0].plans, decs[1].plans)
    assert len(decs[0].plans) == 1 and not decs[0].dpb
