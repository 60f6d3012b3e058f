"""The plain MC predictor of the port (`motion.mc_predict`, the CPU and
`force("plain")` route of the one-launch predictor kernel) against the
JAX reference's P-frame prediction, on the CPU with seeded numpy inputs.
Tolerance 0: the codec is integer-only.

The reference is `video_encoder_tpu/pipeline/gop_engine.py
predict_p_traced` on its jnp path (`dispatch.force("jnp")`), with its
search and half-pel refine replaced by vectors and costs chosen here, so
that the masks (all inter, all intra, mixed) and the vectors (on the
+-16 pel and +-32 half-pel edges) are the test's. The batched form is
held against G single calls, the pre-haloed form (row shards and a 2-D
tile grid) against the unsharded predictor on the whole frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.pipeline import gop_engine as jgop
from video_encoder_tpu_torch.ops import dispatch, motion
from video_encoder_tpu_torch.ops.kernels import build
from video_encoder_tpu_torch.ops.kernels import sad as ksad
from video_encoder_tpu_torch.pipeline import gop_engine as tgop

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.fixture
def jnp_path():
    jdispatch.force("jnp")
    yield
    jdispatch.force(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _case(rng, h, w, fmt, mask, lead=()):
    """Planes, vectors on the range's edges, and a mode mask: cur_y,
    ref_y [.., h, w], ref_cb, ref_cr [.., h/2, w/2]; dy, dx per MB in pels
    (fmt 1) or half-pels (fmt 4); is_inter per MB."""
    r = 16 if fmt < 4 else 32
    nby, nbx = h // 16, w // 16
    cur, ref = (rng.integers(0, 256, (*lead, h, w)) for _ in range(2))
    rcb, rcr = (rng.integers(0, 256, (*lead, h // 2, w // 2)) for _ in range(2))
    dy, dx = (rng.integers(-r, r + 1, (*lead, nby, nbx)) for _ in range(2))
    dy[..., 0, :], dx[..., :, 0] = -r, -r          # the top and left edges
    dy[..., -1, :], dx[..., :, -1] = r, r          # the bottom and right
    dy[..., 0, -1], dx[..., -1, 0] = r - 1, 1 - r  # odd: half-pels at format 4
    inter = {"inter": np.ones((*lead, nby, nbx), bool),
             "intra": np.zeros((*lead, nby, nbx), bool),
             "mixed": rng.random((*lead, nby, nbx)) < 0.6}[mask]
    return cur, ref, rcb, rcr, dy, dx, inter


def _refs(ref, rcb, rcr, fmt):
    planes = [_t(p) for p in (ref, rcb, rcr)]
    if fmt >= 4:
        return tuple(motion.hpel_stack(p) for p in planes)
    return tuple(p.unsqueeze(-3) for p in planes)


@pytest.mark.parametrize("mask", ["inter", "intra", "mixed"])
@pytest.mark.parametrize("fmt", [1, 4])
@pytest.mark.parametrize("h,w", [(48, 80), (64, 32)])
def test_predict_matches_reference(rng, jnp_path, monkeypatch, h, w, fmt, mask):
    """pred_y, pred_cb, pred_cr of the reference's predict_p_traced at the
    test's vectors and modes: the port's predict_p_traced, motion's plain
    predictor, the kernel wrapper's CPU route and the dispatch rule."""
    cur, ref, rcb, rcr, dy, dx, inter = _case(rng, h, w, fmt, mask)
    sad = np.zeros(dy.shape, np.int32)
    icost = np.where(inter, 0, -1).astype(np.int32)   # is_inter = sad <= icost
    fake = (jnp.asarray(dy, jnp.int32), jnp.asarray(dx, jnp.int32), jnp.asarray(sad))
    monkeypatch.setattr(jdispatch, "full_search", lambda *a: fake)
    monkeypatch.setattr(jdispatch, "hpel_refine", lambda *a: fake)
    want = jgop.predict_p_traced(jnp.asarray(cur), jnp.asarray(ref),
                                 jnp.asarray(rcb), jnp.asarray(rcr),
                                 jnp.asarray(icost), search="full", fmt=fmt)
    tfake = (_t(dy), _t(dx), _t(sad))
    monkeypatch.setattr(dispatch, "full_search", lambda *a: tfake)
    monkeypatch.setattr(dispatch, "hpel_refine", lambda *a, **kw: tfake)
    got = tgop.predict_p_traced(_t(cur), _t(ref), _t(rcb), _t(rcr), _t(icost),
                                "full", fmt)
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w_).astype(np.int64))
    refs = _refs(ref, rcb, rcr, fmt)
    args = (refs, _t(dy), _t(dx), torch.from_numpy(inter))
    for fn in (motion.mc_predict, ksad.mc_predict, dispatch.mc_predict):
        preds = fn(*args)
        assert all(p.dtype == torch.int32 and torch.equal(p, g)
                   for p, g in zip(preds, got[3:]))
    if mask == "intra":
        assert all(bool((p == 128).all()) for p in got[3:])


@pytest.mark.parametrize("fmt", [1, 4])
def test_batched_predict_is_g_single_calls(rng, fmt):
    """[G, ...] planes, vectors and modes give per g what a single call on
    g's slice gives, on every route; the GOPs' predictors differ."""
    g = 3
    _, ref, rcb, rcr, dy, dx, inter = _case(rng, 48, 64, fmt, "mixed", (g,))
    refs = _refs(ref, rcb, rcr, fmt)
    args = (_t(dy), _t(dx), torch.from_numpy(inter))
    for fn in (motion.mc_predict, ksad.mc_predict, dispatch.mc_predict):
        got = fn(refs, *args)
        assert [tuple(p.shape) for p in got] == [(g, 48, 64), (g, 24, 32),
                                                 (g, 24, 32)]
        for i in range(g):
            one = fn(tuple(r[i] for r in refs), *(a[i] for a in args))
            assert all(torch.equal(p[i], o) for p, o in zip(got, one))
    assert not torch.equal(got[0][0], got[0][1])


def _windows(stack, r, sr, sc):
    """Tiles of a stack [P, H, W] as a pre-haloed encode has them:
    [Sr * Sc, P, h + 2r, w (+ 2r with sc > 1)], slices of pad_ref of the
    whole plane; with one column of tiles the columns carry no halo."""
    p, hh, ww = stack.shape
    h, w = hh // sr, ww // sc
    pad = motion.pad_ref(stack, r)
    cw = w + 2 * r if sc > 1 else w
    c0 = 0 if sc > 1 else r
    return torch.stack([pad[:, i * h:i * h + h + 2 * r, c0 + j * w:c0 + j * w + cw]
                        for i in range(sr) for j in range(sc)]).contiguous()


def _split(a, sr, sc):
    """[.., nby, nbx] -> [Sr * Sc, nby / Sr, nbx / Sc], row-major tiles."""
    nby, nbx = a.shape[-2:]
    return a.reshape(sr, nby // sr, sc, nbx // sc).permute(0, 2, 1, 3).reshape(
        sr * sc, nby // sr, nbx // sc).contiguous()


def _join(t, sr, sc):
    b, h, w = t.shape
    return t.reshape(sr, sc, h, w).permute(0, 2, 1, 3).reshape(sr * h, sc * w)


@pytest.mark.parametrize("fmt", [1, 4])
@pytest.mark.parametrize("sr,sc", [(4, 1), (2, 1), (2, 2), (1, 3)])
def test_pre_haloed_predict_is_the_unsharded_one(rng, fmt, sr, sc):
    """The shards' predictors from their pre-haloed stacks, put together,
    are the unsharded predictor of the whole frame: row shards (the
    columns edge-replicate) and a 2-D tile grid (both halos)."""
    h, w = 128, 96
    _, ref, rcb, rcr, dy, dx, inter = _case(rng, h, w, fmt, "mixed")
    refs = _refs(ref, rcb, rcr, fmt)
    args = (_t(dy), _t(dx), torch.from_numpy(inter))
    whole = motion.mc_predict(refs, *args)
    refs_ext = tuple(_windows(s, r, sr, sc) for s, r in zip(refs, (16, 8, 8)))
    sh = tuple(_split(a, sr, sc) for a in args)
    for fn in (lambda *a: motion.mc_predict(*a, halo=True),
               ksad.mc_predict_pre_haloed, dispatch.mc_predict_pre_haloed):
        got = fn(refs_ext, *sh)
        assert all(torch.equal(_join(p, sr, sc), q) for p, q in zip(got, whole))
    one = dispatch.mc_predict_pre_haloed(tuple(r[1] for r in refs_ext),
                                         *(a[1] for a in sh))
    assert all(torch.equal(o, p[1]) for o, p in zip(one, got))


@pytest.mark.parametrize("fmt", [1, 4])
def test_plain_route_is_motion_mc_predict(rng, monkeypatch, fmt):
    """On the CPU, and under force("plain"), the dispatch rule and the
    wrapper are the plain predictor, which runs no single-plane fetch of
    dispatch; the launch counters do not move."""
    calls = []
    for name in ("mc_fetch_luma_plane", "mc_fetch_chroma_plane",
                 "mc_fetch_pre_haloed"):
        real = getattr(dispatch, name)
        monkeypatch.setattr(dispatch, name, lambda *a, _n=name, _f=real: (
            calls.append(_n) or _f(*a)))
    before = dict(build.LAUNCHES)
    _, ref, rcb, rcr, dy, dx, inter = _case(rng, 32, 48, fmt, "mixed")
    args = (_refs(ref, rcb, rcr, fmt), _t(dy), _t(dx), torch.from_numpy(inter))
    want = motion.mc_predict(*args)
    dispatch.force("plain")
    try:
        forced = dispatch.mc_predict(*args)
    finally:
        dispatch.force(None)
    for got in (dispatch.mc_predict(*args), ksad.mc_predict(*args), forced):
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert calls == [] and build.LAUNCHES == before
    assert {"mc_predict", "mc_predict_g", "mc_predict_haloed"} <= set(build.LAUNCHES)
    assert "tvc_mc_predict" in build._SIGNATURES


@pytest.mark.parametrize("bad", ["cpu", "dtype", "planes", "extent", "halo",
                                 "modes"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(rng, bad):
    """The predictor's wrapper checks before it launches: a CPU tensor, a
    wrong dtype, stacks of different P, a reference of other extents, an
    unhaloed reference for the pre-haloed entry, modes of another shape.
    No card is needed: each raises before the launch."""
    _, ref, rcb, rcr, dy, dx, inter = _case(rng, 32, 48, 4, "mixed")
    refs = list(_refs(ref, rcb, rcr, 4))
    dy, dx, inter, halo = _t(dy), _t(dx), torch.from_numpy(inter), False
    if bad == "dtype":
        dy = dy.long()
    elif bad == "planes":
        refs[1] = refs[1][:1]
    elif bad == "extent":
        refs[0] = refs[0][..., :-16, :]
    elif bad == "halo":
        halo = True
    elif bad == "modes":
        inter = inter[:, :-1]
    with pytest.raises(ValueError, match="mc_predict"):
        ksad._mc_predict(tuple(refs), dy, dx, inter, halo)
