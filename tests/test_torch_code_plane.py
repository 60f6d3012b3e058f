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
