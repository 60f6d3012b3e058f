"""Port transform/quant tables and primitives vs the JAX reference
(video_encoder_tpu/ops/transform.py). Tolerance 0: integer codec."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_encoder_tpu.codec import spec
from video_encoder_tpu.ops import transform as jtx
from video_encoder_tpu_torch.codec import tables
from video_encoder_tpu_torch.ops import transform as ttx

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def test_tables_match_reference():
    tb = tables.load("cpu")
    for got, want in ((tb.B, jtx.B), (tb.QSTEP, jtx.QSTEP),
                      (tb.ZIGZAG, jtx.ZIGZAG), (tb.UNZIGZAG, jtx.UNZIGZAG)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert (tb.TX_SHIFT, tb.MB, tb.BLK, tb.SEARCH_R, tb.QP_MIN, tb.QP_MAX) == (
        spec.TX_SHIFT, spec.MB, spec.BLK, spec.SEARCH_R, spec.QP_MIN,
        spec.QP_MAX)


def test_qstep_and_rshift_round(rng):
    qp = rng.integers(0, 64, (7, 9)).astype(np.int32)
    assert np.array_equal(ttx.qstep(_t(qp)).numpy(),
                          np.asarray(jtx.qstep(jnp.asarray(qp))))
    v = rng.integers(-(1 << 20), 1 << 20, 500).astype(np.int32)
    v[:4] = [-512, 512, -1536, 1535]   # exact halves round away from zero
    assert np.array_equal(ttx.rshift_round(_t(v), 10).numpy(),
                          np.asarray(jtx.rshift_round(jnp.asarray(v), 10)))


@pytest.mark.parametrize("mag", [255, 30])
def test_forward_inverse_transform(rng, mag):
    x = rng.integers(-mag, mag + 1, (5, 7, 8, 8)).astype(np.int32)
    x[0, 0] = mag                                      # flat extreme block
    got = ttx.forward_transform(_t(x))
    want = np.asarray(jtx.forward_transform(jnp.asarray(x)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    c = rng.integers(-4650, 4651, (5, 7, 8, 8)).astype(np.int32)
    assert np.array_equal(ttx.inverse_transform(_t(c)).numpy(),
                          np.asarray(jtx.inverse_transform(jnp.asarray(c))))


@pytest.mark.parametrize("qbias", [8, 5])
@pytest.mark.parametrize("qp", [1, 28, 51, 63])
def test_quantize_dequantize(rng, qp, qbias):
    c = rng.integers(-3925, 3926, (6, 5, 8, 8)).astype(np.int32)
    c[0, 0] = -np.arange(64).reshape(8, 8)             # small negatives floor
    q = np.full((6, 5, 1, 1), spec.QSTEP[qp], np.int32)
    got = ttx.quantize(_t(c), _t(q), qbias)
    want = np.asarray(jtx.quantize(jnp.asarray(c), jnp.asarray(q), qbias))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), spec.quantize(c, q, qbias))
    assert np.array_equal(ttx.dequantize(got, _t(q)).numpy(),
                          np.asarray(jtx.dequantize(jnp.asarray(want),
                                                    jnp.asarray(q))))


def test_zigzag_blockify_roundtrip(rng):
    plane = rng.integers(-99, 99, (24, 40)).astype(np.int32)
    blocks = ttx.blockify(_t(plane), 8)
    assert np.array_equal(blocks.numpy(),
                          np.asarray(jtx.blockify(jnp.asarray(plane), 8)))
    zz = ttx.zigzag(blocks)
    assert np.array_equal(zz.numpy(), np.asarray(jtx.zigzag(jtx.blockify(
        jnp.asarray(plane), 8))))
    assert torch.equal(ttx.unzigzag(zz), blocks)
    assert torch.equal(ttx.unblockify(ttx.unzigzag(zz)), _t(plane))
