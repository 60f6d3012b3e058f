"""The port's successive-elimination (SEA) full search (ops/motion.py
full_search_sea, the plain version of csrc/full_search.cu sea_kernel) vs
the reference's Pallas SEA kernel run in TPU interpret mode
(video_encoder_tpu/ops/pallas/sad.py full_search_sea_stats, and
full_search under TVC_SEA=1) and its jnp full_search. Tolerance 0:
integer codec. The interpret-mode cases take seconds each, so they live
in this file of their own."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_encoder_tpu.ops import motion as jmotion
from video_encoder_tpu.ops.pallas import sad as psad
from video_encoder_tpu_torch.ops import dispatch, motion
from video_encoder_tpu_torch.ops.kernels import sad as ksad

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _pair(rng, kind, h, w):
    """A smooth pan by (+2, +3), on which the bound prunes, or i.i.d.
    noise, on which it prunes nothing."""
    if kind == "noise":
        return (rng.integers(0, 256, (h, w)).astype(np.int32),
                rng.integers(0, 256, (h, w)).astype(np.int32))
    smooth = rng.integers(0, 256, (h + 16, w + 16)).astype(np.int32)
    for _ in range(2):
        smooth = (smooth + np.roll(smooth, 1, 0) + np.roll(smooth, 1, 1)) // 3
    return smooth[2:2 + h, 3:3 + w].copy(), smooth[:h, :w].copy()


def _eq(got, want):
    return np.array_equal(got.numpy(), np.asarray(want))


# grids that are multiples of the reference's SEA tile (_fs_tile_shape:
# 4 x 8 MBs at 64x128, two tiles of 4 x 16 at 128x256), so that no
# grid-padding MB enters the reference's per-tile count
@pytest.mark.parametrize("kind,h,w", [("smooth", 64, 128), ("noise", 64, 128),
                                      ("smooth", 128, 256)])
def test_sea_stats_matches_pallas_kernel(rng, kind, h, w):
    cur, ref = _pair(rng, kind, h, w)
    with pltpu.force_tpu_interpret_mode():
        want = psad.full_search_sea_stats(jnp.asarray(cur), jnp.asarray(ref))
    exhaustive = jmotion.full_search(jnp.asarray(cur), jnp.asarray(ref))
    got = ksad.full_search_sea_stats(_t(cur), _t(ref))   # CPU: plain version
    for g, w_, e in zip(got, want, exhaustive):
        assert g.dtype == torch.int32 and _eq(g, w_) and _eq(g, e)
    assert torch.equal(dispatch.full_search_sea_stats(_t(cur), _t(ref))[3],
                       got[3])
    # per MB: rows evaluated; per reference tile: the OR of its MBs' masks
    *plain, mask = motion.full_search_sea(_t(cur), _t(ref), with_mask=True)
    assert all(torch.equal(p, g) for p, g in zip(plain, got))
    assert mask.shape == (33, h // 16, w // 16)
    assert torch.equal(mask.sum(0, dtype=torch.int32), got[3])
    nby, nbx = h // 16, w // 16
    tm, tn = psad._fs_tile_shape(nby, nbx)
    per_tile = mask.reshape(33, nby // tm, tm, nbx // tn, tn).any(4).any(2)
    assert _eq(per_tile.sum(0, dtype=torch.int32), want[3])
    assert mask[16].all()                                 # dy = 0 comes first
    if kind == "noise":
        assert (got[3] == 33).all()
    else:
        assert got[3].float().mean() < 20 and (got[0] == 2).all() \
            and (got[1] == 3).all()


def test_sea_under_tvc_sea_matches_pallas_kernel(rng, monkeypatch):
    """TVC_SEA=1: the reference's single-plane search and its G-batched
    twin (jax.vmap) run the SEA kernel; the port's plain SEA, single and
    batched, gives their vectors; the CPU wrappers keep the exhaustive
    search, as the reference's jnp path does."""
    h, w = 64, 128
    pairs = [_pair(rng, kind, h, w) for kind in ("smooth", "noise")]
    cur = np.stack([c for c, _ in pairs])
    ref = np.stack([r for _, r in pairs])
    monkeypatch.setenv("TVC_SEA", "1")
    with pltpu.force_tpu_interpret_mode():
        one = psad.full_search(jnp.asarray(cur[0]), jnp.asarray(ref[0]))
        batch = jax.vmap(psad.full_search)(jnp.asarray(cur), jnp.asarray(ref))
    got = motion.full_search_sea(_t(cur), _t(ref))
    assert all(_eq(g, b) for g, b in zip(got[:3], batch))
    assert all(_eq(g[0], o) for g, o in zip(got[:3], one))
    for g in range(2):
        alone = motion.full_search_sea(_t(cur[g]), _t(ref[g]))
        assert all(torch.equal(a, b[g]) for a, b in zip(alone, got))
    assert got[3][0].float().mean() < got[3][1].float().mean() == 33
    for fn in (dispatch.full_search, ksad.full_search_g):
        assert all(torch.equal(a, b)
                   for a, b in zip(fn(_t(cur), _t(ref)), got[:3]))


@pytest.mark.parametrize("cols_halo", [False, True])
def test_sea_pre_haloed_matches_full_search_pre_haloed(rng, cols_halo):
    """The plain pre-haloed SEA against the plain pre-haloed search: a row
    shard (columns edge-replicate) and a 2-D tile (column halo too)."""
    h, w = 48, 64
    cur, big = _pair(rng, "smooth", h + 32, w + 32)
    cur = cur[16:16 + h, 16:16 + w]
    ref_ext = big if cols_halo else big[:, 16:16 + w]
    want = motion.full_search_pre_haloed(_t(cur), _t(ref_ext))
    got = motion.full_search_sea_pre_haloed(_t(cur), _t(ref_ext))
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want))
    assert int(got[3].min()) >= 1 and int(got[3].max()) <= 33
    assert got[3].float().mean() < 33
    stack = motion.full_search_sea_pre_haloed(_t(np.stack([cur, cur[::-1]])),
                                              _t(np.stack([ref_ext] * 2)))
    assert all(torch.equal(a[0], b) for a, b in zip(stack, got))
