"""The plain pre-haloed search, fetch and SAD of the port and the
transport functions of its tile-sharded encode, on the CPU at small sizes
with seeded numpy inputs. Tolerance 0: the codec is integer-only.

The pre-haloed functions are held against the reference's jnp twins
(`tiles._full_search_haloed`, `tiles._mc_haloed`, `tiles._sad_at_haloed`
under `dispatch.force("jnp")`, the reference's own CPU route for these
kernels) and against the port's unsharded functions on the whole frame;
the transport functions against slices of `pad_ref` of the whole plane,
top and bottom shards included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_encoder_tpu.codec import spec as jspec
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.ops import transform as jtx
from video_encoder_tpu.parallel import tiles as jtiles
from video_encoder_tpu_torch.ops import dispatch, motion
from video_encoder_tpu_torch.ops.kernels import sad as ksad
from video_encoder_tpu_torch.parallel import mesh as tmesh
from video_encoder_tpu_torch.parallel import tiles

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _plane(rng, h, w):
    """A smooth plane with a pan's worth of structure and a flat corner
    where every candidate ties."""
    base = rng.integers(0, 256, (h + 8, w + 8))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, 2, 1)) // 4
    p = base[:h, :w].copy()
    p[:16, :16] = 77
    return p


def _shards(plane, s):
    """[H, W] numpy -> [S, h, W] row shards."""
    return plane.reshape(s, plane.shape[0] // s, plane.shape[1])


def _tiles2d(plane, sr, sc):
    """[H, W] numpy -> [Sr, Sc, h, w] tiles."""
    h, w = plane.shape[0] // sr, plane.shape[1] // sc
    return plane.reshape(sr, h, sc, w).transpose(0, 2, 1, 3)


@pytest.fixture
def jnp_route():
    jdispatch.force("jnp")
    yield
    jdispatch.force(None)


# ---- the transport functions ----------------------------------------------

@pytest.mark.parametrize("s,halo", [(4, 16), (2, 16), (4, 8), (1, 16), (4, 1)])
def test_exchange_halo_and_gather_ref_are_slices_of_pad_ref(rng, s, halo):
    h_full, w = 64, 48
    plane = rng.integers(0, 256, (h_full, w))
    h = h_full // s
    padded = motion.pad_ref(_t(plane), halo)[:, halo:halo + w]   # rows only
    want = torch.stack([padded[i * h:(i + 1) * h + 2 * halo] for i in range(s)])
    sh = _t(_shards(plane, s))
    assert torch.equal(tiles.exchange_halo(sh, halo), want)
    assert torch.equal(tiles.gather_ref(sh, halo), want)
    # a GOP axis in front: every GOP exchanges among its own shards only
    two = torch.stack([sh, sh.flip(0)])
    got = tiles.exchange_halo(two, halo)
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], tiles.exchange_halo(sh.flip(0), halo))
    assert torch.equal(tiles.gather_ref(two, halo)[0], want)


def test_exchange_halo_columns_and_2d_corners(rng):
    """The column exchange is the row exchange transposed, and the 2-D
    exchange's corners come from the diagonal tiles: every extended tile
    is its window of pad_ref of the whole plane."""
    hh, ww, sr, sc, halo = 64, 96, 2, 3, 16
    plane = rng.integers(0, 256, (hh, ww))
    padded = motion.pad_ref(_t(plane), halo)
    t4 = _t(_tiles2d(plane, sr, sc))
    ext = tiles.exchange_halo_2d(t4, halo)
    h, w = hh // sr, ww // sc
    assert ext.shape == (sr, sc, h + 2 * halo, w + 2 * halo)
    for r in range(sr):
        for c in range(sc):
            want = padded[r * h:(r + 1) * h + 2 * halo, c * w:(c + 1) * w + 2 * halo]
            assert torch.equal(ext[r, c], want), (r, c)
    cols = tiles.exchange_halo(t4, halo, shard_dim=-3, axis=1)
    assert torch.equal(cols[1, 1][:, :halo], t4[1, 0][:, -halo:])
    assert torch.equal(cols[0, 0][:, :halo], t4[0, 0][:, :1].expand(h, halo))


def test_exchange_halo_matches_reference_single_shard(rng):
    """One shard: the reference's n == 1 branch replicates its own rows."""
    plane = rng.integers(0, 256, (32, 16))
    want = np.concatenate([np.repeat(plane[:1], 8, 0), plane,
                           np.repeat(plane[-1:], 8, 0)])
    got = tiles.exchange_halo(_t(plane)[None], 8)[0]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ref_mode", ["halo", "allgather"])
@pytest.mark.parametrize("s,halo", [(4, 16), (2, 8), (1, 16)])
def test_parity_ext_is_parity_then_pad(rng, ref_mode, s, halo):
    """The halo-extended parity planes are slices of pad_ref(hpel_planes(
    whole frame)): parity first, then the pad. Pad-then-parity differs at
    the frame's top edge."""
    h_full, w = 64, 32
    plane = rng.integers(0, 256, (h_full, w))
    h = h_full // s
    got = tiles._parity_ext(_t(_shards(plane, s)), halo, ref_mode)
    for q_got, q_full in zip(got, motion.hpel_planes(_t(plane))):
        padded = motion.pad_ref(q_full, halo)[:, halo:halo + w]
        for i in range(s):
            assert torch.equal(q_got[i], padded[i * h:(i + 1) * h + 2 * halo]), i
    # the trap this guards: averaging the pixel halo instead
    wrong = motion.hpel_planes(tiles.exchange_halo(_t(_shards(plane, s)), halo))
    assert not torch.equal(wrong[1][0], got[1][0])


def test_psum_sums_the_shard_axis():
    bits = torch.arange(24).reshape(2, 3, 4)
    assert torch.equal(tiles.psum(bits), bits.sum(-1))
    assert torch.equal(tiles.psum(bits, -2), bits.sum(1))


# ---- the plain pre-haloed functions against the reference's jnp twins -----

def _row_case(rng, s=4, h_full=64, w=48):
    cur = _plane(rng, h_full, w)
    ref = np.clip(np.roll(cur, (3, -5), (0, 1)) + rng.integers(-2, 3, cur.shape), 0, 255)
    ref[:32, :32] = 77       # all 1089 candidates of MB (0, 0) tie at SAD 0
    ref_ext = tiles.exchange_halo(_t(_shards(ref, s)), 16)
    return cur, ref, _t(_shards(cur, s)), ref_ext


def _grid_case(rng, sr=2, sc=2, h_full=64, w_full=96):
    cur = _plane(rng, h_full, w_full)
    ref = np.clip(np.roll(cur, (-4, 6), (0, 1)) + rng.integers(-2, 3, cur.shape), 0, 255)
    ref[:32, :32] = 77
    ref_ext = tiles.exchange_halo_2d(_t(_tiles2d(ref, sr, sc)), 16).flatten(0, 1)
    return cur, ref, _t(_tiles2d(cur, sr, sc)).flatten(0, 1).contiguous(), ref_ext


@pytest.mark.parametrize("geometry", ["rows", "grid"])
def test_full_search_pre_haloed_matches_reference_and_unsharded(
        rng, jnp_route, geometry):
    cur, ref, cur_sh, ref_ext = (_row_case if geometry == "rows" else _grid_case)(rng)
    got = motion.full_search_pre_haloed(cur_sh, ref_ext)
    for b in range(cur_sh.shape[0]):
        want = jtiles._full_search_haloed(jnp.asarray(cur_sh[b].numpy()),
                                          jnp.asarray(ref_ext[b].numpy()))
        for g, w_ in zip(got, want):
            assert np.array_equal(g[b].numpy(), np.asarray(w_)), b
        one = motion.full_search_pre_haloed(cur_sh[b], ref_ext[b])   # no batch
        assert all(torch.equal(a, c[b]) for a, c in zip(one, got))
    # the shards' results, put together, are the whole frame's
    whole = motion.full_search(_t(cur), _t(ref))
    for g, w_ in zip(got, whole):
        if geometry == "rows":
            assert torch.equal(g.flatten(0, 1), w_)
        else:
            nby, nbx = g.shape[-2:]
            assert torch.equal(
                g.reshape(2, 2, nby, nbx).permute(0, 2, 1, 3).reshape(w_.shape), w_)
    # the all-tied MB takes the first candidate, and the pan is found
    assert (int(got[0][0, 0, 0]), int(got[1][0, 0, 0]), int(got[2][0, 0, 0])) == (
        -16, -16, 0)
    assert len(set(got[0].flatten().tolist())) > 2


@pytest.mark.parametrize("bs", [16, 8])
@pytest.mark.parametrize("geometry", ["rows", "grid"])
def test_mc_fetch_pre_haloed_matches_reference_and_unsharded(
        rng, jnp_route, geometry, bs):
    r = bs
    hh, ww = (64, 48) if bs == 16 else (32, 24)
    if geometry == "grid":
        ww *= 2
    ref = rng.integers(0, 256, (hh, ww))
    dy = rng.integers(-r, r + 1, (hh // bs, ww // bs))
    dx = rng.integers(-r, r + 1, (hh // bs, ww // bs))
    dy[0, 0], dx[0, 0], dy[-1, -1], dx[-1, -1] = -r, -r, r, r
    dy[0, -1], dx[0, -1], dy[-1, 0], dx[-1, 0] = -r, r, r, -r
    whole = motion.mc_fetch_plane(_t(ref), _t(dy), _t(dx), bs)
    if geometry == "rows":
        s = 4
        ref_ext = tiles.exchange_halo(_t(_shards(ref, s)), r)
        dy_sh, dx_sh = _t(_shards(dy, s)), _t(_shards(dx, s))
        put = lambda a: a.flatten(0, 1)
    else:
        ref_ext = tiles.exchange_halo_2d(_t(_tiles2d(ref, 2, 2)), r).flatten(0, 1)
        dy_sh = _t(_tiles2d(dy, 2, 2)).flatten(0, 1).contiguous()
        dx_sh = _t(_tiles2d(dx, 2, 2)).flatten(0, 1).contiguous()
        put = lambda a: a.reshape(2, 2, hh // 2, ww // 2).permute(
            0, 2, 1, 3).reshape(hh, ww)
    got = motion.mc_fetch_pre_haloed(ref_ext, dy_sh, dx_sh, bs, r)
    assert torch.equal(put(got), whole)
    for b in range(ref_ext.shape[0]):
        want = jtiles._mc_haloed(jnp.asarray(ref_ext[b].numpy()),
                                 jnp.asarray(dy_sh[b].numpy()),
                                 jnp.asarray(dx_sh[b].numpy()), bs, r)
        assert np.array_equal(got[b].numpy(), np.asarray(want)), b
        one = motion.mc_fetch_pre_haloed(ref_ext[b], dy_sh[b], dx_sh[b], bs, r)
        assert torch.equal(one, got[b])


def test_sad_at_pre_haloed_matches_reference_and_unsharded(rng, jnp_route):
    cur, ref, cur_sh, ref_ext = _row_case(rng)
    s = cur_sh.shape[0]
    dy = rng.integers(-16, 17, (3, 4, 3))
    dx = rng.integers(-16, 17, (3, 4, 3))
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -16, -16, 16, 16
    whole = motion.sad_at(_t(cur), _t(ref), _t(dy), _t(dx))       # [3, 4, 3]
    dy_sh = _t(dy.reshape(3, s, 1, 3).transpose(1, 0, 2, 3))      # [S, 3, 1, 3]
    dx_sh = _t(dx.reshape(3, s, 1, 3).transpose(1, 0, 2, 3))
    got = motion.sad_at_pre_haloed(cur_sh, ref_ext, dy_sh, dx_sh)
    assert torch.equal(got.permute(1, 0, 2, 3).reshape(3, 4, 3), whole)
    for b in range(s):
        blocks = jtx.blockify(jnp.asarray(cur_sh[b].numpy()), jspec.MB)
        for k in range(3):
            want = jtiles._sad_at_haloed(
                blocks, jnp.asarray(ref_ext[b].numpy()),
                jnp.asarray(dy_sh[b, k].numpy()), jnp.asarray(dx_sh[b, k].numpy()),
                jtiles.HALO_Y)
            assert np.array_equal(got[b, k].numpy(), np.asarray(want))
    # a stack of planes, one per candidate
    planes = torch.stack([ref_ext, ref_ext.flip(-1).contiguous()], -3)
    both = motion.sad_at_pre_haloed(cur_sh, planes, dy_sh[:, :2], dx_sh[:, :2], [1, 0])
    assert torch.equal(both[:, 1], got[:, 1])
    assert not torch.equal(both[:, 0], got[:, 0])


def test_hpel_refine_on_haloed_planes_matches_reference_and_unsharded(
        rng, jnp_route):
    """The sharded refine (the unsharded nine-candidate program on
    halo-extended parity planes) gives the whole frame's vectors and the
    reference's `_hpel_refine_haloed`."""
    cur, ref, cur_sh, ref_ext = _row_case(rng)
    s = cur_sh.shape[0]
    ref_sh = _t(_shards(ref, s))
    dy0, dx0, _ = motion.full_search(_t(cur), _t(ref))
    whole = dispatch.hpel_refine(_t(cur), _t(ref), dy0, dx0)
    planes = (ref_ext, *tiles._parity_ext(ref_sh, 16, "halo"))
    dy_sh = _t(_shards(dy0.numpy(), s))
    dx_sh = _t(_shards(dx0.numpy(), s))
    got = dispatch.hpel_refine(cur_sh, None, dy_sh, dx_sh,
                               torch.stack(planes, -3),
                               sad_fn=dispatch.sad_at_mv_pre_haloed)
    for g, w_ in zip(got, whole):
        assert torch.equal(g.flatten(0, 1), w_)
    assert bool(((got[0] & 1) | (got[1] & 1)).any())
    keys = ((0, 0), (0, 1), (1, 0), (1, 1))
    hs, ws = cur_sh.shape[-2:]
    stack_c = _t(rng.integers(0, 256, (4, hs // 2 + 16, ws // 2)))
    for b in range(s):
        jplanes = {k: jnp.asarray(p[b].numpy()) for k, p in zip(keys, planes)}
        want = jtiles._hpel_refine_haloed(
            jnp.asarray(cur_sh[b].numpy()), jplanes,
            jnp.asarray(dy_sh[b].numpy()), jnp.asarray(dx_sh[b].numpy()))
        for g, w_ in zip(got, want):
            assert np.array_equal(g[b].numpy(), np.asarray(w_))
        # and the half-pel MC from those planes: the luma of the format-4
        # predictor from pre-haloed stacks (the chroma stacks are random)
        mc = dispatch.mc_predict_pre_haloed(
            (torch.stack([p[b] for p in planes]), stack_c, stack_c),
            got[0][b], got[1][b], torch.ones(got[0][b].shape, dtype=torch.bool))[0]
        jmc = jtiles._hpel_mc_haloed(jplanes, jnp.asarray(got[0][b].numpy()),
                                     jnp.asarray(got[1][b].numpy()), 16, 16)
        assert np.array_equal(mc.numpy(), np.asarray(jmc))


def test_wrappers_take_the_plain_version_for_cpu_tensors(rng):
    """On a CPU tensor each wrapper, and the dispatch rule, is the plain
    version; the launch counters do not move."""
    from video_encoder_tpu_torch.ops.kernels import build

    _, _, cur_sh, ref_ext = _row_case(rng)
    before = dict(build.LAUNCHES)
    want = motion.full_search_pre_haloed(cur_sh, ref_ext)
    for fn in (ksad.full_search_pre_haloed, dispatch.full_search_pre_haloed):
        assert all(torch.equal(a, b) for a, b in zip(fn(cur_sh, ref_ext), want))
    dy, dx, _ = want
    mc = motion.mc_fetch_pre_haloed(ref_ext, dy, dx, 16, 16)
    assert torch.equal(ksad.mc_fetch_pre_haloed(ref_ext, dy, dx, 16, 16), mc)
    assert torch.equal(dispatch.mc_fetch_pre_haloed(ref_ext, dy, dx, 16, 16), mc)
    sad = motion.sad_at_pre_haloed(cur_sh, ref_ext, dy, dx)
    assert torch.equal(ksad.sad_at_mv_pre_haloed(cur_sh, ref_ext, dy, dx), sad)
    assert torch.equal(dispatch.sad_at_mv_pre_haloed(cur_sh, ref_ext, dy, dx), sad)
    assert torch.equal(sad, want[2])           # the search's own minimum
    assert build.LAUNCHES == before
    for name in ("full_search_haloed", "mc_fetch_haloed_luma",
                 "mc_fetch_haloed_chroma", "sad_at_mv_haloed"):
        assert name in build.LAUNCHES
        assert "tvc_" + name.replace("_luma", "").replace("_chroma", "") in build._SIGNATURES


@pytest.mark.parametrize("fn,args", [
    (motion.full_search_pre_haloed, ((32, 48), (48, 48))),       # 16 rows short
    (motion.full_search_pre_haloed, ((32, 48), (64, 64))),       # half a column halo
    (motion.mc_fetch_pre_haloed, ((2, 3), (40, 48), 16, 16)),
])
def test_pre_haloed_shapes_are_checked(fn, args):
    if fn is motion.full_search_pre_haloed:
        cur, ref = (torch.zeros(s, dtype=torch.int32) for s in args)
        with pytest.raises(ValueError, match="pre-haloed"):
            fn(cur, ref)
    else:
        mv = torch.zeros(args[0], dtype=torch.int32)
        with pytest.raises(ValueError, match="pre-haloed"):
            fn(torch.zeros(args[1], dtype=torch.int32), mv, mv, *args[2:])


# ---- the 2-D grid's rc mb pace and the mesh -------------------------------

@pytest.mark.parametrize("sc", [1, 2, 4])
def test_mb_rc_offsets_tile2d_equals_unsharded(rng, sc):
    nby, nbx = 3, 8
    est = rng.integers(0, 5000, (2, nby, nbx))          # two row shards
    est[1, 1] = 0                                        # an empty MB row
    sharded = est.reshape(2, nby, sc, nbx // sc).transpose(0, 2, 1, 3)
    got = tiles.mb_rc_offsets_tile2d(torch.from_numpy(sharded))
    assert got.dtype == torch.int32 and got.shape == (2, sc, nby, nbx // sc)
    for r in range(2):
        want = jspec.mb_rc_offsets(est[r])
        assert np.array_equal(
            got[r].permute(1, 0, 2).reshape(nby, nbx).numpy(), want)
    assert int(got.abs().max()) > 0


def test_mesh_layouts_and_checks():
    m = tmesh.make_codec_mesh(3, 4, "cpu")
    assert m.shape == {"gop": 3, "tile": 4} and m.device == "cpu"
    m.check_frame(1080, 1920)                            # 68 MB rows / 4
    assert tiles.check_tile_config(m, 1080, 1920, 1, 0) == 17
    assert tiles.check_tile_config(m, 1080, 1920, 4, 17) == 17
    with pytest.raises(ValueError, match="do not divide over 4 row shards"):
        m.check_frame(360, 640)                          # 23 MB rows
    with pytest.raises(ValueError, match="intra_slice_mbrows"):
        tiles.check_tile_config(m, 1080, 1920, 3, 0)
    with pytest.raises(ValueError, match="per-shard MB rows \\(17\\)"):
        tiles.check_tile_config(m, 1080, 1920, 3, 4)
    g = tmesh.make_tile_mesh_2d(2, 3, "cpu")
    assert g.shape == {"tr": 2, "tc": 3}
    g.check_frame(64, 96)
    with pytest.raises(ValueError, match="column shards"):
        g.check_frame(64, 64)
    with pytest.raises(ValueError, match="sizes >= 1"):
        tmesh.make_codec_mesh(0, 2)
    assert tmesh.make_codec_mesh().shape == {"gop": 1, "tile": 1}
