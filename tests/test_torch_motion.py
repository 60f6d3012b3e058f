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


def _jsad_even_map(cur, ref):
    """The JAX reference's sad_at at each of the 289 even-even mvs,
    [nby, nbx, 289] in kE order."""
    import jax

    refpad = jmotion.pad_ref(jnp.asarray(ref), 16)
    cur_b = jtx.blockify(jnp.asarray(cur), 16)
    nby, nbx = cur.shape[0] // 16, cur.shape[1] // 16
    ev = np.arange(-16, 17, 2)
    dy = np.broadcast_to(np.repeat(ev, 17)[:, None, None], (289, nby, nbx))
    dx = np.broadcast_to(np.tile(ev, 17)[:, None, None], (289, nby, nbx))
    sads = jax.vmap(lambda a, b: jmotion.sad_at(cur_b, refpad, a, b))(
        jnp.asarray(dy, jnp.int32), jnp.asarray(dx, jnp.int32))
    return np.moveaxis(np.asarray(sads), 0, -1)


@pytest.mark.parametrize("h,w,flat", [(48, 64, False), (80, 48, False),
                                      (48, 80, True)])
def test_sad_map_even_matches_reference(rng, h, w, flat):
    cur, ref = _pair(rng, h, w, flat)
    got = ksad.sad_map_even(_t(cur), _t(ref))   # CPU tensor: plain version
    assert got.dtype == torch.int32 and got.shape == (h // 16, w // 16, 289)
    assert np.array_equal(got.numpy(), _jsad_even_map(cur, ref))


def test_sad_at_mv_takes_k_candidates(rng):
    cur, ref = _pair(rng, 48, 80, False)
    dy = rng.integers(-16, 17, (4, 3, 5)).astype(np.int32)
    dx = rng.integers(-16, 17, (4, 3, 5)).astype(np.int32)
    dy[0, 0, 0], dx[0, 0, 0], dy[3, -1, -1], dx[3, -1, -1] = -16, -16, 16, 16
    got = ksad.sad_at_mv(_t(cur), _t(ref), _t(dy), _t(dx))
    refpad = jmotion.pad_ref(jnp.asarray(ref), 16)
    cur_b = jtx.blockify(jnp.asarray(cur), 16)
    for k in range(4):
        want = jmotion.sad_at(cur_b, refpad, jnp.asarray(dy[k]), jnp.asarray(dx[k]))
        assert np.array_equal(got[k].numpy(), np.asarray(want))


def _diamond_clip(rng, h, w, kind):
    if kind == "pan":          # moves of up to (+6, -10): several steps
        base = rng.integers(0, 256, (h + 40, w + 40)).astype(np.int32)
        for _ in range(3):
            base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
        cur = base[20:20 + h, 20:20 + w]
        ref = base[14:14 + h, 30:30 + w] + rng.integers(-1, 2, (h, w))
        return cur, np.clip(ref, 0, 255).astype(np.int32)
    if kind == "frozen":       # near-static low-contrast: cost < 512 at once
        cur = 100 + rng.integers(0, 2, (h, w)).astype(np.int32)
        ref = cur + rng.integers(0, 2, (h, w)).astype(np.int32)
        return cur, ref
    return _pair(rng, h, w, kind == "flat")


@pytest.mark.parametrize("h,w,kind", [(48, 64, "pan"), (80, 48, "pan"),
                                      (48, 80, "flat"), (48, 64, "frozen"),
                                      (64, 96, "texture")])
def test_diamond_search_matches_reference(rng, h, w, kind):
    from video_encoder_tpu.codec import golden
    from video_encoder_tpu_torch.ops import dispatch

    cur, ref = _diamond_clip(rng, h, w, kind)
    want = jmotion.diamond_search(jnp.asarray(cur), jnp.asarray(ref))
    gold = golden.sad_diamond_search(cur, ref)
    plain = motion.diamond_search(_t(cur), _t(ref))        # sad_at route
    mapped = dispatch.diamond_search(_t(cur), _t(ref))     # even-map route
    for got in (plain, mapped):
        for g, w_, gg in zip(got, want, gold):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w_))
            assert np.array_equal(g.numpy(), gg)
    if kind == "frozen":   # every MB froze before its first step
        assert (plain[2].numpy() < 512).all()


def test_fixed_diamond_budget_equals_stop_at_all_frozen(rng, monkeypatch):
    """The port runs all DIAMOND_MAX_STEPS steps; the reference stops once
    every MB is frozen. On a pan whose MBs all freeze within a few steps,
    every budget from the freezing step on gives the same vectors: the
    extra steps are the identity."""
    from video_encoder_tpu.codec import golden
    from video_encoder_tpu_torch.codec import spec   # the port reads its own

    cur, ref = _diamond_clip(rng, 48, 64, "pan")
    full = motion.diamond_search(_t(cur), _t(ref))
    results = []
    for steps in range(1, spec.DIAMOND_MAX_STEPS + 1):
        monkeypatch.setattr(spec, "DIAMOND_MAX_STEPS", steps)
        results.append(motion.diamond_search(_t(cur), _t(ref)))
    same = [all(torch.equal(a, b) for a, b in zip(r, full)) for r in results]
    first = same.index(True)
    assert 1 <= first < 15           # moved for a while, then froze
    assert all(same[first:])         # every later step is the identity
    monkeypatch.undo()
    gold = golden.sad_diamond_search(cur, ref)   # stops at all-frozen
    for g, gg in zip(full, gold):
        assert np.array_equal(g.numpy(), gg)
