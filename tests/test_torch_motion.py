"""Port motion search / compensation / intra cost vs the JAX reference
(video_encoder_tpu/ops/motion.py). Tolerance 0: integer codec."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_encoder_tpu.ops import motion as jmotion
from video_encoder_tpu.ops import transform as jtx
from video_encoder_tpu_torch.ops import motion
from video_encoder_tpu_torch.ops.kernels import sad as ksad

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _pair(rng, h, w, flat):
    base = rng.integers(0, 256, (h + 40, w + 40)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    cur = base[20:20 + h, 20:20 + w].copy()
    ref = base[17:17 + h, 24:24 + w] + rng.integers(-2, 3, (h, w))
    if flat:  # every candidate of the flat MBs ties: first minimum wins
        cur[:, :32] = 77
        ref[:, :] = 77
    return cur, np.clip(ref, 0, 255).astype(np.int32)


@pytest.mark.parametrize("h,w,flat", [(48, 64, False), (48, 80, False),
                                      (48, 80, True)])
def test_full_search_matches_reference(rng, h, w, flat):
    cur, ref = _pair(rng, h, w, flat)
    want = jmotion.full_search(jnp.asarray(cur), jnp.asarray(ref))
    got = ksad.full_search(_t(cur), _t(ref))   # CPU tensor: plain version
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w_))
    if flat:
        assert (got[0].numpy() == -16).any() and (got[1].numpy() == -16).any()


def test_pad_ref_is_edge_replication(rng):
    p = rng.integers(0, 256, (16, 24)).astype(np.int32)
    assert np.array_equal(motion.pad_ref(_t(p), 5).numpy(),
                          np.pad(p, 5, mode="edge"))


@pytest.mark.parametrize("bs,h,w", [(16, 48, 64), (8, 24, 40)])
def test_mc_fetch_matches_reference(rng, bs, h, w):
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    nby, nbx = h // bs, w // bs
    dy = rng.integers(-bs, bs + 1, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-bs, bs + 1, (nby, nbx)).astype(np.int32)
    for yy, xx, sy, sx in ((0, 0, -1, -1), (0, -1, -1, 1), (-1, 0, 1, -1),
                           (-1, -1, 1, 1)):
        dy[yy, xx], dx[yy, xx] = sy * bs, sx * bs    # the four corners
    want = jtx.unblockify(jmotion.mc_fetch(
        jmotion.pad_ref(jnp.asarray(ref), bs), jnp.asarray(dy),
        jnp.asarray(dx), bs, bs))
    fetch = ksad.mc_fetch_plane if bs == 16 else ksad.mc_fetch_plane_chroma
    got = fetch(_t(ref), _t(dy), _t(dx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_intra_cost_and_dc(rng):
    cur = rng.integers(0, 256, (48, 80)).astype(np.int32)
    cur[:16, :16] = 200
    dc_w, cost_w = jmotion.intra_cost_and_dc(jnp.asarray(cur))
    dc, cost = motion.intra_cost_and_dc(_t(cur))
    assert np.array_equal(dc.numpy(), np.asarray(dc_w))
    assert np.array_equal(cost.numpy(), np.asarray(cost_w))
    assert int(cost[0, 0]) == 0
