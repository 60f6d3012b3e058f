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


# ---------------------------------------------------------------------------
# The G axis: planes [G, H, W] of G GOPs in lockstep, against jax.vmap of the
# reference's dispatch functions on their jnp route (the route the
# reference's own batched-GOP tests take on the CPU)
# ---------------------------------------------------------------------------

G = 3


@pytest.fixture
def jnp_route():
    from video_encoder_tpu.ops import dispatch as jdispatch

    jdispatch.force("jnp")
    yield jdispatch
    jdispatch.force(None)


def _batch(rng, h, w):
    """Three plane pairs that differ: a textured pan, an all-tied flat
    pair, and a pair whose best match sits on the (+16, -16) corner."""
    cur0, ref0 = _pair(rng, h, w, False)
    cur1, ref1 = _pair(rng, h, w, True)
    base = rng.integers(0, 256, (h + 40, w + 40)).astype(np.int32)
    cur2 = base[20:20 + h, 20:20 + w]
    ref2 = base[4:4 + h, 36:36 + w]          # cur2[y, x] == ref2[y+16, x-16]
    return np.stack([cur0, cur1, cur2]), np.stack([ref0, ref1, ref2])


def _eq(got, want):
    return np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w", [(48, 64), (48, 80)])
def test_batched_full_search_matches_vmapped_reference(rng, jnp_route, h, w):
    import jax

    from video_encoder_tpu_torch.ops import dispatch

    cur, ref = _batch(rng, h, w)
    want = jax.vmap(jnp_route.full_search)(jnp.asarray(cur), jnp.asarray(ref))
    for fn in (dispatch.full_search, ksad.full_search_g, motion.full_search):
        got = fn(_t(cur), _t(ref))
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.int32 and g_.shape == (G, h // 16, w // 16)
            assert _eq(g_, w_)
    for g in range(G):   # each g is what the plane alone gives
        alone = motion.full_search(_t(cur[g]), _t(ref[g]))
        assert all(torch.equal(a, b[g]) for a, b in zip(alone, got))
    assert (got[0][1, :, 0] == -16).all() and (got[1][1, :, 0] == -16).all()
    inner = (slice(1, -1), slice(1, -1))     # the corner match, off the edges
    assert (got[0][2][inner] == 16).all() and (got[1][2][inner] == -16).all()
    assert not torch.equal(got[0][0], got[0][2])     # a swapped g would show


@pytest.mark.parametrize("h,w", [(48, 64), (80, 48)])
def test_batched_sad_map_even_matches_reference(rng, h, w):
    from video_encoder_tpu_torch.ops import dispatch

    cur, ref = _batch(rng, h, w)
    want = np.stack([_jsad_even_map(cur[g], ref[g]) for g in range(G)])
    for fn in (dispatch.sad_map_even, ksad.sad_map_even_g):
        got = fn(_t(cur), _t(ref))
        assert got.dtype == torch.int32 and got.shape == (G, h // 16, w // 16, 289)
        assert np.array_equal(got.numpy(), want)
    assert (got[1, :, 0] == got[1, :, 0, :1]).all()        # the tied MBs
    assert not np.array_equal(want[0], want[2])


@pytest.mark.parametrize("k", [None, 4])
def test_batched_sad_at_mv_matches_vmapped_reference(rng, jnp_route, k):
    import jax

    from video_encoder_tpu_torch.ops import dispatch

    h, w = 48, 80
    cur, ref = _batch(rng, h, w)
    shape = (G, 3, 5) if k is None else (G, k, 3, 5)
    dy = rng.integers(-16, 17, shape).astype(np.int32)
    dx = rng.integers(-16, 17, shape).astype(np.int32)
    dy[0, ..., 0, 0], dx[0, ..., 0, 0] = -16, -16
    dy[2, ..., -1, -1], dx[2, ..., -1, -1] = 16, 16
    one = jnp_route.sad_at_mv
    if k is not None:
        one = jax.vmap(one, in_axes=(None, None, 0, 0))
    want = jax.vmap(one)(jnp.asarray(cur), jnp.asarray(ref), jnp.asarray(dy),
                         jnp.asarray(dx))
    for fn in (dispatch.sad_at_mv, ksad.sad_at_mv_g):
        got = fn(_t(cur), _t(ref), _t(dy), _t(dx))
        assert got.dtype == torch.int32 and _eq(got, want)
    swapped = dispatch.sad_at_mv(_t(cur[::-1]), _t(ref), _t(dy), _t(dx))
    assert not torch.equal(swapped, got)


def test_batched_sad_at_mv_chroma_matches_vmapped_reference(rng):
    import jax

    from video_encoder_tpu_torch.ops import dispatch

    h, w = 24, 40
    cur = rng.integers(0, 256, (G, h, w)).astype(np.int32)
    ref = rng.integers(0, 256, (G, h, w)).astype(np.int32)
    dy = rng.integers(-8, 9, (G, 4, 3, 5)).astype(np.int32)
    dx = rng.integers(-8, 9, (G, 4, 3, 5)).astype(np.int32)
    dy[:, :, 0, 0], dx[:, :, 0, 0], dy[:, :, -1, -1], dx[:, :, -1, -1] = -8, -8, 8, 8

    def one(c, r, a, b):   # the reference's sad_at at block 8, radius 8
        pred = jmotion.mc_fetch(jmotion.pad_ref(r, 8), a, b, 8, 8)
        return jnp.abs(jtx.blockify(c, 8) - pred).sum(axis=(2, 3))

    want = jax.vmap(jax.vmap(one, in_axes=(None, None, 0, 0)))(
        jnp.asarray(cur), jnp.asarray(ref), jnp.asarray(dy), jnp.asarray(dx))
    for fn in (dispatch.sad_at_mv_chroma, ksad.sad_at_mv_chroma_g):
        assert _eq(fn(_t(cur), _t(ref), _t(dy), _t(dx)), want)


def test_batched_sad_at_mv_on_four_parity_planes(rng, jnp_route):
    """Nine candidates, each on the parity plane of its half-pel offset, of
    G reference stacks [G, 4, H, W], and the whole half-pel refine."""
    import jax

    from video_encoder_tpu_torch.ops import dispatch

    h, w = 48, 64
    cur, ref = _batch(rng, h, w)
    uv = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
    plane_of = [abs(u) * 2 + abs(v) for u, v in uv]
    dy = rng.integers(-16, 17, (G, 9, 3, 4)).astype(np.int32)
    dx = rng.integers(-16, 17, (G, 9, 3, 4)).astype(np.int32)
    dy[:, :, 0, 0], dx[:, :, 0, 0], dy[:, :, -1, -1], dx[:, :, -1, -1] = -16, -16, 16, 16

    def one(c, r, a, b):
        planes = (r, *jmotion.hpel_planes(r))
        return jnp.stack([jnp_route.sad_at_mv(c, planes[p], a[k], b[k])
                          for k, p in enumerate(plane_of)])

    want = jax.vmap(one)(jnp.asarray(cur), jnp.asarray(ref), jnp.asarray(dy),
                         jnp.asarray(dx))
    planes = motion.hpel_stack(_t(ref))
    assert planes.shape == (G, 4, h, w)
    for fn in (dispatch.sad_at_mv, ksad.sad_at_mv_g):
        assert _eq(fn(_t(cur), planes, _t(dy), _t(dx), plane_of), want)

    mv = rng.integers(-16, 17, (2, G, 3, 4)).astype(np.int32)
    mv[:, :, 0], mv[:, :, -1] = -16, 16          # candidates beyond +-32 half-pels
    want = jax.vmap(jnp_route.hpel_refine)(
        jnp.asarray(cur), jnp.asarray(ref), jnp.asarray(mv[0]), jnp.asarray(mv[1]))
    got = dispatch.hpel_refine(_t(cur), _t(ref), _t(mv[0]), _t(mv[1]))
    assert all(_eq(a, b) for a, b in zip(got, want))
    assert int(got[0].abs().max()) <= 32 and int(got[1].abs().max()) <= 32


@pytest.mark.parametrize("bs,h,w", [(16, 48, 64), (8, 24, 40)])
def test_batched_mc_fetch_matches_vmapped_reference(rng, jnp_route, bs, h, w):
    import jax

    from video_encoder_tpu_torch.ops import dispatch

    ref = rng.integers(0, 256, (G, h, w)).astype(np.int32)
    dy = rng.integers(-bs, bs + 1, (G, h // bs, w // bs)).astype(np.int32)
    dx = rng.integers(-bs, bs + 1, (G, h // bs, w // bs)).astype(np.int32)
    dy[0, 0, 0], dx[0, 0, 0], dy[2, -1, -1], dx[2, -1, -1] = -bs, -bs, bs, bs
    jfetch, fetch, kfetch = (
        (jnp_route.mc_fetch_luma_plane, dispatch.mc_fetch_luma_plane,
         ksad.mc_fetch_plane_g) if bs == 16 else
        (jnp_route.mc_fetch_chroma_plane, dispatch.mc_fetch_chroma_plane,
         ksad.mc_fetch_plane_chroma_g))
    want = jax.vmap(jfetch)(jnp.asarray(ref), jnp.asarray(dy), jnp.asarray(dx))
    for fn in (fetch, kfetch):
        got = fn(_t(ref), _t(dy), _t(dx))
        assert got.dtype == torch.int32 and _eq(got, want)
    swapped = fetch(_t(ref[::-1]), _t(dy), _t(dx))
    assert not torch.equal(swapped, got)
    # the half-pel fetch from four parity planes, selected per block: the
    # plane of the predictor of G P steps (format 4) that this block size
    # serves, at MB vectors whose chroma part (>> 1) is the chroma's
    hp = (jnp_route.mc_fetch_luma_plane_hpel if bs == 16
          else jnp_route.mc_fetch_chroma_plane_hpel)
    d2y = rng.integers(-2 * bs, 2 * bs + 1, dy.shape).astype(np.int32)
    d2x = rng.integers(-2 * bs, 2 * bs + 1, dy.shape).astype(np.int32)
    want = jax.vmap(hp)(jnp.asarray(ref), jnp.asarray(d2y), jnp.asarray(d2x))
    k = 16 // bs                      # chroma: MB vectors twice the block's
    lh, lw = h * k, w * k
    planes = [rng.integers(0, 256, (G, lh, lw)),
              rng.integers(0, 256, (G, lh // 2, lw // 2)),
              rng.integers(0, 256, (G, lh // 2, lw // 2))]
    planes[k - 1] = ref
    refs = tuple(motion.hpel_stack(_t(p)) for p in planes)
    inter = torch.ones(dy.shape, dtype=torch.bool)
    got = dispatch.mc_predict(refs, _t(d2y * k), _t(d2x * k), inter)[k - 1]
    assert _eq(got, want)


@pytest.mark.parametrize("kinds", [("pan", "flat", "frozen"),
                                   ("texture", "pan", "pan")])
def test_batched_diamond_search_matches_vmapped_reference(rng, jnp_route, kinds):
    import jax

    from video_encoder_tpu_torch.ops import dispatch

    pairs = [_diamond_clip(rng, 48, 64, kind) for kind in kinds]
    cur = np.stack([p[0] for p in pairs])
    ref = np.stack([p[1] for p in pairs])
    want = jax.vmap(jnp_route.diamond_search)(jnp.asarray(cur), jnp.asarray(ref))
    plain = motion.diamond_search(_t(cur), _t(ref))        # sad_at route
    mapped = dispatch.diamond_search(_t(cur), _t(ref))     # even-map route
    for got in (plain, mapped):
        assert all(_eq(a, b) for a, b in zip(got, want))
    for g in range(G):
        alone = dispatch.diamond_search(_t(cur[g]), _t(ref[g]))
        assert all(torch.equal(a, b[g]) for a, b in zip(alone, mapped))


def test_batched_intra_cost_and_adaptive_qp(rng):
    import jax

    cur = rng.integers(0, 256, (G, 48, 80)).astype(np.int32)
    cur[1, :16, :16] = 200
    dc_w, cost_w = jax.vmap(jmotion.intra_cost_and_dc)(jnp.asarray(cur))
    dc, cost = motion.intra_cost_and_dc(_t(cur))
    assert _eq(dc, dc_w) and _eq(cost, cost_w) and int(cost[1, 0, 0]) == 0
    qps = np.array([22, 26, 61], np.int32)
    want = jax.vmap(jmotion.adaptive_qp)(jnp.asarray(qps), cost_w)
    got = motion.adaptive_qp(_t(qps), cost)
    assert got.dtype == torch.int32 and _eq(got, want)
    alone = motion.adaptive_qp(torch.tensor(26, dtype=torch.int32), cost[1])
    assert torch.equal(alone, got[1])


# ---------------------------------------------------------------------------
# The whole SAD map (stride 1) against the reference's Pallas sad_map in TPU
# interpret mode, and the hierarchical search against the reference's jnp
# hier_search and the golden model
# ---------------------------------------------------------------------------

def test_sad_map_matches_pallas_kernel(rng):
    """The plain map equals psad.sad_map and, for G = 2, the vmap of it
    (the batched kernel); its even sublattice is sad_map_even and the
    first minimum of sad << 11 | k is full_search's."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from video_encoder_tpu.ops.pallas import sad as psad
    from video_encoder_tpu_torch.ops import dispatch

    h, w = 48, 64
    cur, ref = _batch(rng, h, w)
    cur, ref = cur[1:], ref[1:]           # the all-tied pair and the corner pair
    with pltpu.force_tpu_interpret_mode():
        one = psad.sad_map(jnp.asarray(cur[1]), jnp.asarray(ref[1]))
        both = jax.vmap(psad.sad_map)(jnp.asarray(cur), jnp.asarray(ref))
    for fn in (dispatch.sad_map, ksad.sad_map_g, motion.sad_map):
        got = fn(_t(cur), _t(ref))
        assert got.dtype == torch.int32 and got.shape == (2, 3, 4, 1089)
        assert _eq(got, both)
    single = ksad.sad_map(_t(cur[1]), _t(ref[1]))
    assert _eq(single, one) and torch.equal(single, got[1])
    even = got.reshape(2, 3, 4, 33, 33)[..., ::2, ::2].reshape(2, 3, 4, 289)
    assert torch.equal(even, motion.sad_map_even(_t(cur), _t(ref)))
    key = (got.long() * 2048 + torch.arange(1089)).amin(-1)
    k = key & 2047
    want = motion.full_search(_t(cur), _t(ref))
    assert torch.equal((k // 33 - 16).int(), want[0])
    assert torch.equal((k % 33 - 16).int(), want[1])
    assert torch.equal((key >> 11).int(), want[2])
    assert (got[0, :, 0] == got[0, :, 0, :1]).all()       # the tied MBs


def test_down2_matches_reference(rng):
    from video_encoder_tpu.codec import spec as jspec

    p = rng.integers(0, 256, (2, 32, 48)).astype(np.int32)
    want = np.stack([jspec.down2(q) for q in p])
    assert _eq(motion.down2(_t(p)), want)
    assert _eq(motion.down2(_t(p[0])), jmotion.down2(jnp.asarray(p[0])))
    assert int(motion.down2(_t([[0, 1], [0, 2]]))[0, 0]) == (0 + 1 + 0 + 2 + 2) >> 2


def _hier_pair(rng, sy, sx, h=160, w=192):
    """tests/test_hier_search.py's translation case: a heavily low-passed
    field, ref = cur shifted by (sy, sx)."""
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float64)
    for k in (1, 2, 4, 8):
        base = (base + np.roll(base, k, 0) + np.roll(base, -k, 0)
                + np.roll(base, k, 1) + np.roll(base, -k, 1)) / 5
    base = base - base.min()
    base = (base / base.max() * 255).astype(np.int32)
    return (base[32:32 + h, 32:32 + w],
            base[32 - sy:32 - sy + h, 32 - sx:32 - sx + w])


@pytest.mark.parametrize("shift", [(0, 0), (3, -5), (-14, 15), (9, 9)])
def test_hier_search_matches_reference(rng, shift):
    """The plain hier search with its default (batched) refine, with a
    refine of one candidate per call, and through dispatch (each refine
    step's 25 candidates in one sad_at_mv call) against the reference's
    jnp hier_search and golden.sad_hier_search."""
    from video_encoder_tpu.codec import golden
    from video_encoder_tpu_torch.ops import dispatch

    cur, ref = _hier_pair(rng, *shift)
    gold = golden.sad_hier_search(cur, ref)
    want = jmotion.hier_search(jnp.asarray(cur), jnp.asarray(ref))
    for a, b in zip(gold, want):
        assert np.array_equal(a, np.asarray(b))
    calls = []

    def one_at_a_time(dy, dx):
        calls.append(dy.shape)
        return motion.sad_at(_t(cur), _t(ref), dy, dx)

    for got in (motion.hier_search(_t(cur), _t(ref)),
                motion.hier_search(_t(cur), _t(ref), one_at_a_time),
                dispatch.hier_search(_t(cur), _t(ref))):
        assert all(g.dtype == torch.int32 and _eq(g, w_)
                   for g, w_ in zip(got, want))
    assert calls == [(10, 12)] * 50          # two steps of 25 candidates
    inner = np.s_[2:-2, 2:-2]
    assert ((gold[0][inner] == shift[0]) & (gold[1][inner] == shift[1])).mean() > 0.85


def test_batched_hier_search_is_per_plane(rng):
    from video_encoder_tpu_torch.ops import dispatch

    pairs = [_hier_pair(rng, *s, h=64, w=96) for s in ((3, -5), (-9, 12))]
    cur = np.stack([c for c, _ in pairs])
    ref = np.stack([r for _, r in pairs])
    got = dispatch.hier_search(_t(cur), _t(ref))
    for g in range(2):
        alone = motion.hier_search(_t(cur[g]), _t(ref[g]))
        assert all(torch.equal(a, b[g]) for a, b in zip(alone, got))
        want = jmotion.hier_search(jnp.asarray(cur[g]), jnp.asarray(ref[g]))
        assert all(_eq(a[g], b) for a, b in zip(got, want))
