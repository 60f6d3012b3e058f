"""Port code_plane (transform -> quant -> zigzag -> recon of one plane) vs
the reference's dispatch.code_plane, which takes its jnp path on a CPU
backend. Tolerance 0: integer codec."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_encoder_tpu.codec import spec
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.ops.kernels import codec as kcodec

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("qbias", [8, 5])
@pytest.mark.parametrize("h,w", [(48, 64), (24, 32), (40, 48)])
def test_code_plane_matches_reference(rng, h, w, qbias):
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    pred = np.clip(cur + rng.integers(-60, 61, (h, w)), 0, 255).astype(np.int32)
    pred[:8, :8] = 128                                # a flat-128 intra block
    qp = rng.choice([1, 28, 51, 63], (h // 8, w // 8))
    q_blk = spec.QSTEP[qp].astype(np.int32)
    lz_w, rec_w = jdispatch.code_plane(jnp.asarray(cur), jnp.asarray(pred),
                                       jnp.asarray(q_blk), qbias)
    lz, rec = kcodec.code_plane(_t(cur), _t(pred), _t(q_blk), qbias)
    assert lz.shape == (h // 8, w // 8, 64) and lz.dtype == torch.int32
    assert np.array_equal(lz.numpy(), np.asarray(lz_w))
    assert np.array_equal(rec.numpy(), np.asarray(rec_w))
    lz2, rec2 = dispatch.code_plane(_t(cur), _t(pred), _t(q_blk), qbias)
    assert torch.equal(lz2, lz) and torch.equal(rec2, rec)


def test_code_plane_lossless_at_qp1(rng):
    """qp 1 (step 1) reconstructs within the transform's rounding."""
    cur = rng.integers(0, 256, (16, 16)).astype(np.int32)
    pred = np.full((16, 16), 128, np.int32)
    q_blk = np.full((2, 2), spec.QSTEP[1], np.int32)
    _, rec = kcodec.code_plane(_t(cur), _t(pred), _t(q_blk))
    assert np.abs(rec.numpy() - cur).max() <= 2


# the G axis: planes [G, H, W] of G GOPs in lockstep, against jax.vmap of
# the reference's functions on their jnp route

@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("qbias", [8, 5])
def test_batched_code_plane_matches_vmapped_reference(rng, qbias, qmat):
    import jax

    g, h, w = 3, 24, 40
    cur = rng.integers(0, 256, (g, h, w)).astype(np.int32)
    pred = np.clip(cur + rng.integers(-60, 61, (g, h, w)), 0, 255).astype(np.int32)
    pred[1] = 128                                     # one GOP all intra
    qp = rng.choice([1, 28, 51, 63], (g, h // 8, w // 8))
    q_blk = spec.QSTEP[qp].astype(np.int32)           # each GOP its own steps
    jdispatch.force("jnp")
    try:
        lz_w, rec_w = jax.vmap(
            lambda c, p, q: jdispatch.code_plane(c, p, q, qbias, qmat))(
            jnp.asarray(cur), jnp.asarray(pred), jnp.asarray(q_blk))
    finally:
        jdispatch.force(None)
    for fn in (dispatch.code_plane, kcodec.code_plane_g):
        lz, rec = fn(_t(cur), _t(pred), _t(q_blk), qbias, qmat)
        assert lz.shape == (g, h // 8, w // 8, 64) and lz.dtype == torch.int32
        assert np.array_equal(lz.numpy(), np.asarray(lz_w))
        assert np.array_equal(rec.numpy(), np.asarray(rec_w))
    for i in range(g):       # each g is what the plane alone gives
        lz1, rec1 = kcodec.code_plane(_t(cur[i]), _t(pred[i]), _t(q_blk[i]),
                                      qbias, qmat)
        assert torch.equal(lz1, lz[i]) and torch.equal(rec1, rec[i])
    swapped, _ = dispatch.code_plane(_t(cur), _t(pred), _t(q_blk[::-1]), qbias,
                                     qmat)
    assert not torch.equal(swapped, lz)               # a swapped g would show


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("reset_rows", [0, 2])
def test_batched_intra_rows_match_vmapped_reference(rng, reset_rows, qmat):
    """The I-frame row scan of G planes in lockstep: [G, 8, W] stripes,
    each GOP's pred its own previous recon row."""
    import jax

    from video_encoder_tpu.ops import transform as jtx

    g, h, w = 3, 48, 64
    base = rng.integers(0, 256, (g, h + 8, w + 8)).astype(np.int32)
    cur = (base[:, :h, :w] + base[:, 1:h + 1, :w] + base[:, :h, 1:w + 1]) // 3
    qp = rng.choice([12, 28, 40], (g, h // 8, w // 8))
    q_blk = spec.QSTEP[qp].astype(np.int32)
    lv_w, rec_w = jax.vmap(lambda c, q: jtx.intra_rows_code_plane(
        c, jtx.qsteps_pos(q, qmat), 6, reset_rows))(
        jnp.asarray(cur), jnp.asarray(q_blk))
    lz, rec = dispatch.intra_rows_code_plane(_t(cur), _t(q_blk), 6, reset_rows,
                                             qmat)
    assert lz.shape == (g, h // 8, w // 8, 64) and rec.shape == (g, h, w)
    assert np.array_equal(lz.numpy(), np.asarray(jtx.zigzag(lv_w)))
    assert np.array_equal(rec.numpy(), np.asarray(rec_w))
    for i in range(g):
        lz1, rec1 = dispatch.intra_rows_code_plane(_t(cur[i]), _t(q_blk[i]), 6,
                                                   reset_rows, qmat)
        assert torch.equal(lz1, lz[i]) and torch.equal(rec1, rec[i])
