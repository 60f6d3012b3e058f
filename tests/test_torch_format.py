"""Formats 2-4 and rc adaptive/vbv of the port, module by module, against
the JAX reference (jnp path under `dispatch.force("jnp")`, the block_pack
Pallas kernel in interpret mode) and the numpy spec. Tolerance 0
everywhere: the codec is integer-only. On the CPU the port's wrappers run
their plain PyTorch versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_encoder_tpu.codec import entropy as jent
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec import spec as jspec
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.ops import motion as jmotion
from video_encoder_tpu.ops import transform as jtx
from video_encoder_tpu.ops.pallas import entropy_pack as ep
from video_encoder_tpu.pipeline import gop_engine as jgop
from video_encoder_tpu_torch.codec import entropy, tables
from video_encoder_tpu_torch.ops import dispatch, motion
from video_encoder_tpu_torch.ops import transform as tx
from video_encoder_tpu_torch.ops.kernels import codec as kcodec
from video_encoder_tpu_torch.ops.kernels import entropy_pack as kpack
from video_encoder_tpu_torch.ops.kernels import sad as ksad
from video_encoder_tpu_torch.pipeline import gop_engine as tgop

torch.set_num_threads(1)


@pytest.fixture
def jnp_path():
    jdispatch.force("jnp")
    yield
    jdispatch.force(None)


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


def _eq(got: torch.Tensor, want) -> bool:
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == np.int32 and want.dtype == np.uint32:   # words
        got = got.view(np.uint32)
    return np.array_equal(got.astype(np.int64), want.astype(np.int64))


def _smooth(rng, h, w):
    a = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int32)
    a = (a + np.roll(a, 1, 0) + np.roll(a, 1, 1) + np.roll(a, (1, 1), (0, 1))) // 4
    return a


# ---------------------------------------------------------------------------
# block_pack, format-2 syntax
# ---------------------------------------------------------------------------

def _v2_levels(rng, by, bx):
    """A plane's [by, bx, 64] levels with the syntax's corners: all-zero
    blocks, DC-only blocks, dc - pred at +7850 and -7850, a block whose
    only coefficient is the last AC, and a dense block that overflows."""
    lv = np.zeros((by, bx, 64), np.int32)
    mask = rng.random(lv.shape) < 0.15
    lv[mask] = rng.integers(-300, 301, mask.sum())
    lv[0, 0] = 0                                  # all-zero, pred 0
    lv[0, 1] = 0
    lv[0, 1, 0] = -17                             # DC-only
    lv[0, 2] = 0                                  # all-zero after a DC: cbf 0
    lv[1, 0] = 0
    lv[1, 0, 0] = -3925
    lv[1, 1] = 0
    lv[1, 1, 0] = 3925                            # dc - pred = +7850
    lv[1, 2] = 0
    lv[1, 2, 0] = -3925                           # dc - pred = -7850
    lv[1, 3] = 0
    lv[1, 3, 63] = 1                              # run of 62 from position 1
    lv[2, 0] = rng.integers(-3925, 3926, 64)      # dense: overflows 16 words
    return lv


@pytest.mark.parametrize("by,bx,words", [(4, 6, 16), (6, 10, 24), (3, 5, 78)])
def test_block_pack_v2_matches_reference(rng, by, bx, words):
    lv = _v2_levels(rng, by, bx)
    pred = np.asarray(jent._dc_pred_left(jnp.asarray(lv)))
    tpred = entropy._dc_pred_left(_t(lv))
    assert _eq(tpred, pred)
    assert not tpred[:, 0].any()                  # 0 at the start of each row
    flat, fpred = lv.reshape(-1, 64), pred.reshape(-1)

    v, l = jent.block_symbols_v2(jnp.asarray(flat), jnp.asarray(fpred))
    want_w, want_b, want_ovf = jent.pack_dense(v, l, words)
    tv, tl = entropy.block_symbols_v2(_t(flat), _t(fpred))
    assert _eq(tv, v) and _eq(tl, l)
    got_w, got_b = kpack.block_pack(_t(flat), words, _t(fpred), 2)
    assert got_w.dtype == torch.int32 and got_b.dtype == torch.int32
    assert _eq(got_b, want_b) and _eq(got_w, want_w)
    assert bool((got_b > 32 * words).any()) == bool(want_ovf) == (words < 78)
    # the Pallas kernel itself, in interpret mode
    pw, pb = ep._block_pack_impl(jnp.asarray(flat), jnp.asarray(fpred)[:, None],
                                 2, words, interpret=True)
    assert _eq(got_b, pb) and _eq(got_w, pw)
    # the corners: cbf alone; se(+-7850) is 27 bits; the dispatch rule
    bits = got_b.reshape(by, bx)
    assert int(bits[0, 0]) == 1 and int(bits[0, 2]) == 1
    assert int(bits[1, 1]) == int(bits[1, 2]) == 1 + 27 + 1
    dw, db = dispatch.block_pack(_t(flat), words, _t(fpred), 2)
    assert torch.equal(dw, got_w) and torch.equal(db, got_b)


def test_block_pack_v2_needs_dc_pred():
    with pytest.raises(ValueError, match="dc_pred"):
        kpack.block_pack(torch.zeros((4, 64), dtype=torch.int32), 16, None, 2)


def test_block_pack_v2_worst_case_fits_block_words_max():
    """cbf + se(+-7850) + ue(63) + 63 x (ue(0) run + se(+-3925) level)."""
    lv = np.full((2, 64), 3925, np.int32)
    lv[1] = -3925
    pred = np.array([-3925, 3925], np.int32)
    _, bits = kpack.block_pack(_t(lv), entropy.BLOCK_WORDS_MAX, _t(pred), 2)
    assert bits.tolist() == [1 + 27 + 13 + 63 * (1 + 25)] * 2
    assert 1 + 27 + 13 + 63 * 38 <= 32 * entropy.BLOCK_WORDS_MAX


# ---------------------------------------------------------------------------
# v2 headers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("r", [16, 32])
def test_header_slots_v2_match_reference(rng, is_p, r):
    nby, nbx = 4, 7
    is_inter = rng.random((nby, nbx)) < 0.7
    is_inter[0] = True                             # a whole inter row
    is_inter[1, 0], is_inter[1, 1] = False, True   # left MB intra
    dy = rng.integers(-r, r + 1, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-r, r + 1, (nby, nbx)).astype(np.int32)
    dy[0, 0], dy[0, 1] = r, -r                     # the widest difference
    qpd = rng.integers(-3, 4, (nby, nbx)).astype(np.int32)
    jv, jl = jent._header_slots_v2(jnp.asarray(qpd), is_p, jnp.asarray(is_inter),
                                   jnp.asarray(dy), jnp.asarray(dx))
    tv, tl = entropy._header_slots(_t(qpd), is_p, torch.from_numpy(is_inter),
                                   _t(dy), _t(dx), fmt=2)
    assert _eq(tv, jv) and _eq(tl, jl)
    ww, wb, _ = jent.pack_header(jv, jl)
    gw, gb, govf = entropy.pack_header(tv, tl)
    assert _eq(gb, wb) and _eq(gw, ww) and not bool(govf)
    if is_p:    # column 0 predicts from zero: same code as format 1
        v1, l1 = entropy._header_slots(_t(qpd), is_p, torch.from_numpy(is_inter),
                                       _t(dy), _t(dx))
        assert torch.equal(tv[:, :, 0], v1[:, :, 0])
        assert not torch.equal(tv, v1)


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("is_p", [False, True])
def test_frame_pack_v2_matches_reference(rng, jnp_path, is_p, emit):
    nby, nbx, bw = 3, 4, 24
    ly, lcb, lcr = (_v2_levels(rng, m * nby, m * nbx) for m in (2, 1, 1))
    for lv in (ly, lcb, lcr):
        lv[2, 0] = 0                               # keep every block in budget
    qpd = rng.integers(-2, 3, (nby, nbx)).astype(np.int32)
    is_inter = (rng.random((nby, nbx)) < 0.6) & is_p
    dy = rng.integers(-32, 33, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-32, 33, (nby, nbx)).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (ly, lcb, lcr, qpd)] + [
        is_p, jnp.asarray(is_inter), jnp.asarray(dy), jnp.asarray(dx), bw]
    targs = [_t(ly), _t(lcb), _t(lcr), _t(qpd), is_p,
             torch.from_numpy(is_inter), _t(dy), _t(dx), bw]
    ww, wbits, wmb, wovf = jent.pack_frame_planes_v2(*jargs, 2000)
    if emit == "frame":
        gw, gbits, gmb, govf = entropy.pack_frame_planes(*targs, 2000, fmt=2)
        assert _eq(gw, ww)
    else:
        from video_encoder_tpu_torch.codec.mux import bit_concat
        cw, cbits, gmb, govf = entropy.pack_frame_chunks(*targs, fmt=2)
        gbits = int(cbits.sum())
        payload, nbits = bit_concat(
            [(cw[c].numpy().view(np.uint32), int(b))
             for c, b in enumerate(cbits) if b])
        nw = (gbits + 31) // 32
        assert nbits == gbits
        assert payload == np.asarray(ww)[:nw].astype(">u4").tobytes()
    assert int(gbits) == int(wbits) and not bool(govf) and not bool(wovf)
    assert _eq(gmb, wmb)
    est = entropy.frame_mb_bits(*targs, fmt=2)
    assert torch.equal(est, gmb)


# ---------------------------------------------------------------------------
# code_plane with the quant matrix, the row scan
# ---------------------------------------------------------------------------

def test_qsteps_pos_matches_spec(rng):
    q = rng.choice(jspec.QSTEP, (3, 5)).astype(np.int32)
    for use in (False, True):
        want = jspec.qsteps_pos(q, use)
        assert _eq(tx.qsteps_pos(_t(q), use), want)
        assert _eq(tx.qsteps_pos(_t(q), use), jtx.qsteps_pos(jnp.asarray(q), use))
    assert int(tx.qsteps_pos(_t(np.array([1])), True).min()) == 1


@pytest.mark.parametrize("qbias", [8, 5])
@pytest.mark.parametrize("h,w", [(48, 80), (24, 40)])
def test_code_plane_qmat_matches_reference(rng, jnp_path, h, w, qbias):
    tex = _smooth(rng, h, w)
    cur = tex[:h, :w]
    pred = np.clip(tex[2:2 + h, 3:3 + w] + rng.integers(-30, 31, (h, w)), 0, 255)
    qp = rng.choice([1, 20, 28, 63], (h // 8, w // 8))
    q_blk = np.asarray(jspec.QSTEP)[qp].astype(np.int32)
    wl, wr = jdispatch.code_plane(jnp.asarray(cur), jnp.asarray(pred),
                                  jnp.asarray(q_blk), qbias, True)
    for fn in (kcodec.code_plane, dispatch.code_plane, tx.code_plane):
        gl, gr = fn(_t(cur), _t(pred), _t(q_blk), qbias, True)
        assert _eq(gl, wl) and _eq(gr, wr)
    flat, _ = tx.code_plane(_t(cur), _t(pred), _t(q_blk), qbias, False)
    assert not _eq(flat, wl)                      # the matrix took effect


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("reset_rows", [0, 1, 2])
def test_intra_rows_code_plane_matches_reference(rng, reset_rows, qmat):
    h, w = 48, 64
    cur = _smooth(rng, h, w)[:h, :w]
    qp = rng.choice([12, 28, 40], (h // 8, w // 8))
    q_blk = np.asarray(jspec.QSTEP)[qp].astype(np.int32)
    qs = jtx.qsteps_pos(jnp.asarray(q_blk), qmat)
    wl, wr = jtx.intra_rows_code_plane(jnp.asarray(cur), qs, 6, reset_rows)
    nl, nr = jspec.intra_rows_code_plane(cur, jspec.qsteps_pos(q_blk, qmat), 6,
                                         reset_rows)
    for fn in (tx.intra_rows_code_plane, dispatch.intra_rows_code_plane):
        gl, gr = fn(_t(cur), _t(q_blk), 6, reset_rows, qmat)
        assert _eq(gl, jtx.zigzag(wl)) and _eq(gr, wr)
        assert _eq(tx.unzigzag(gl), nl) and _eq(gr, nr)
    if reset_rows:   # a reset row codes as a first row does
        top, _ = tx.intra_rows_code_plane(
            _t(cur[8 * reset_rows:]), _t(q_blk[reset_rows:]), 6, 0, qmat)
        assert torch.equal(gl[reset_rows], top[0])


# ---------------------------------------------------------------------------
# half-pel planes, refine and MC; the chroma SAD
# ---------------------------------------------------------------------------

def test_hpel_planes_match_reference(rng):
    p = rng.integers(0, 256, (32, 48)).astype(np.int32)
    want = jmotion.hpel_planes(jnp.asarray(p))
    got = motion.hpel_planes(_t(p))
    gold = golden.hpel_planes(p)
    for g, w_, n in zip(got, want, gold):
        assert _eq(g, w_) and _eq(g, n)
    stack = motion.hpel_stack(_t(p))
    assert stack.shape == (4, 32, 48) and _eq(stack[0], p) and _eq(stack[3], want[2])


@pytest.mark.parametrize("bs,h,w,k", [(8, 32, 48, 3), (8, 24, 40, 1), (16, 32, 48, 2)])
def test_sad_at_block_sizes_match_reference(rng, bs, h, w, k):
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    dy = rng.integers(-bs, bs + 1, (k, h // bs, w // bs)).astype(np.int32)
    dx = rng.integers(-bs, bs + 1, (k, h // bs, w // bs)).astype(np.int32)
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -bs, -bs, bs, bs
    refpad = jmotion.pad_ref(jnp.asarray(ref), bs)
    cur_b = jtx.blockify(jnp.asarray(cur), bs)
    want = np.stack([
        np.abs(np.asarray(cur_b) - np.asarray(jmotion.mc_fetch(
            refpad, jnp.asarray(dy[i]), jnp.asarray(dx[i]), bs, bs))).sum((2, 3))
        for i in range(k)])
    if bs == 16:
        assert np.array_equal(want[0], np.asarray(jmotion.sad_at(
            cur_b, refpad, jnp.asarray(dy[0]), jnp.asarray(dx[0]))))
        fns = (ksad.sad_at_mv, dispatch.sad_at_mv)
    else:
        fns = (ksad.sad_at_mv_chroma, dispatch.sad_at_mv_chroma)
    assert _eq(motion.sad_at(_t(cur), _t(ref), _t(dy), _t(dx), bs), want)
    for fn in fns:
        assert _eq(fn(_t(cur), _t(ref), _t(dy), _t(dx)), want)


def test_sad_at_plane_of_each_candidate_matches_reference(rng):
    """Candidate k on planes[plane_of[k]] is the reference's sad_at on that
    plane's pad, through the plain version, the wrapper and the dispatch."""
    h, w, plane_of = 32, 48, [0, 3, 1, 1, 2]
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    planes = rng.integers(0, 256, (4, h, w)).astype(np.int32)
    dy = rng.integers(-16, 17, (5, h // 16, w // 16)).astype(np.int32)
    dx = rng.integers(-16, 17, (5, h // 16, w // 16)).astype(np.int32)
    cur_b = jtx.blockify(jnp.asarray(cur), 16)
    want = np.stack([np.asarray(jmotion.sad_at(
        cur_b, jmotion.pad_ref(jnp.asarray(planes[p]), 16),
        jnp.asarray(dy[k]), jnp.asarray(dx[k]))) for k, p in enumerate(plane_of)])
    args = (_t(cur), _t(planes), _t(dy), _t(dx))
    assert _eq(motion.sad_at(*args, plane_of=plane_of), want)
    assert _eq(ksad.sad_at_mv(*args, plane_of), want)
    assert _eq(dispatch.sad_at_mv(*args, plane_of), want)


def _hpel_case(rng, case, h=48, w=80):
    """(cur, ref, dy, dx) for the refine: a true half-pel shift, an
    all-tied flat frame, and integer vectors on the +-16 edge."""
    nby, nbx = h // 16, w // 16
    if case == "flat":
        cur = np.full((h, w), 77, np.int32)
        ref = np.full((h, w), 77, np.int32)
        dy = rng.integers(-16, 17, (nby, nbx))
        dx = rng.integers(-16, 17, (nby, nbx))
    else:
        big = _smooth(rng, 2 * h + 8, 2 * w + 8)

        def down(oy, ox):
            o = big[oy:oy + 2 * h, ox:ox + 2 * w]
            return (o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2]
                    + o[1::2, 1::2] + 2) // 4
        ref, cur = down(4, 4), down(5, 7)          # (+0.5, +1.5) px
        if case == "halfpel":
            dy = np.zeros((nby, nbx), np.int64)
            dx = np.ones((nby, nbx), np.int64)
        else:                                      # the +-16 edge
            dy = rng.choice([-16, 16], (nby, nbx))
            dx = rng.choice([-16, 16], (nby, nbx))
            dy[0, 0], dx[0, 0] = 16, 3
    return (cur.astype(np.int32), ref.astype(np.int32), dy.astype(np.int32),
            dx.astype(np.int32))


@pytest.mark.parametrize("case", ["halfpel", "flat", "edge"])
def test_hpel_refine_matches_reference(rng, jnp_path, case):
    cur, ref, dy, dx = _hpel_case(rng, case)
    want = jdispatch.hpel_refine(jnp.asarray(cur), jnp.asarray(ref),
                                 jnp.asarray(dy), jnp.asarray(dx))
    got = dispatch.hpel_refine(_t(cur), _t(ref), _t(dy), _t(dx))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32 and _eq(g, w_)
    d2y, d2x, _ = got
    assert int(d2y.abs().max()) <= 32 and int(d2x.abs().max()) <= 32
    if case == "flat":      # all nine tie: the first valid one, row-major
        exp_y = np.where(2 * dy - 1 >= -32, 2 * dy - 1, 2 * dy)
        exp_x = np.where(2 * dx - 1 >= -32, 2 * dx - 1, 2 * dx)
        assert _eq(d2y, exp_y) and _eq(d2x, exp_x)
    if case == "halfpel":
        assert bool(((d2y & 1) | (d2x & 1)).any())
    if case == "edge":      # candidates beyond +-32 are never taken
        assert int(d2y[0, 0]) <= 32
    planes = motion.hpel_stack(_t(ref))
    again = dispatch.hpel_refine(_t(cur), _t(ref), _t(dy), _t(dx), planes)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("bs,h,w", [(16, 48, 80), (8, 24, 40)])
def test_hpel_mc_matches_reference(rng, jnp_path, bs, h, w):
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    r2 = 2 * bs
    d2y = rng.integers(-r2, r2 + 1, (h // bs, w // bs)).astype(np.int32)
    d2x = rng.integers(-r2, r2 + 1, (h // bs, w // bs)).astype(np.int32)
    d2y[0, 0], d2x[0, 0], d2y[-1, -1], d2x[-1, -1] = -r2, -r2 + 1, r2, r2 - 1
    jfn = (jdispatch.mc_fetch_luma_plane_hpel if bs == 16
           else jdispatch.mc_fetch_chroma_plane_hpel)
    want = jfn(jnp.asarray(ref), jnp.asarray(d2y), jnp.asarray(d2x))
    # the port's predictor of a format-4 P step makes this plane from its
    # four parity planes at MB vectors whose chroma part (>> 1) is the
    # chroma's; the other planes are random
    k = 16 // bs
    planes = [rng.integers(0, 256, (h * k, w * k)),
              rng.integers(0, 256, (h * k // 2, w * k // 2)),
              rng.integers(0, 256, (h * k // 2, w * k // 2))]
    planes[k - 1] = ref
    refs = tuple(motion.hpel_stack(_t(p)) for p in planes)
    inter = torch.ones(d2y.shape, dtype=torch.bool)
    got = dispatch.mc_predict(refs, _t(d2y * k), _t(d2x * k), inter)[k - 1]
    assert got.dtype == torch.int32 and _eq(got, want)


@pytest.mark.parametrize("search", ["full", "diamond"])
def test_predict_p_traced_fmt4_matches_reference(rng, jnp_path, search):
    cur, ref, _, _ = _hpel_case(rng, "halfpel")
    rcb = rng.integers(0, 256, (24, 40)).astype(np.int32)
    rcr = rng.integers(0, 256, (24, 40)).astype(np.int32)
    _, icost = jmotion.intra_cost_and_dc(jnp.asarray(cur))
    want = jgop.predict_p_traced(jnp.asarray(cur), jnp.asarray(ref),
                                 jnp.asarray(rcb), jnp.asarray(rcr), icost,
                                 search=search, fmt=4)
    _, ticost = motion.intra_cost_and_dc(_t(cur))
    got = tgop.predict_p_traced(_t(cur), _t(ref), _t(rcb), _t(rcr), ticost,
                                search, 4)
    for g, w_ in zip(got, want):
        assert _eq(g, w_)
    assert bool(((got[0] & 1) | (got[1] & 1))[got[2]].any())


# ---------------------------------------------------------------------------
# rate control: adaptive qp, the vbv carry, chroma qp
# ---------------------------------------------------------------------------

def test_adaptive_qp_matches_reference(rng):
    act = rng.integers(0, 70000, (6, 9)).astype(np.int32)
    act[0, :4] = [0, 1, 1023, 1024]
    for qp in (1, 28, 63):
        want = jmotion.adaptive_qp(jnp.asarray(qp, jnp.int32), jnp.asarray(act))
        got = motion.adaptive_qp(torch.tensor(qp, dtype=torch.int32), _t(act))
        assert got.dtype == torch.int32 and _eq(got, want)


@pytest.mark.parametrize("rc,target,vbv", [
    ("vbv", 20000, 160000), ("vbv", 20000, 30000), ("vbv", 900_000_000, 2_000_000_000),
    ("bitrate", 20000, 0), ("mb", 20000, 0), ("none", 0, 0), ("adaptive", 0, 0)])
def test_rc_carry_matches_spec(rng, rc, target, vbv):
    """A run of frames through the device carry against spec.vbv_next and
    the bitrate rule in Python ints (int64 on the device: (bits - target)
    * 4 passes int32 at the largest rate)."""
    qp, full = 28, jspec.vbv_init(vbv)
    tqp = torch.tensor(qp, dtype=torch.int32)
    tfull = torch.tensor(full, dtype=torch.int64)
    for _ in range(40):
        bits = int(rng.integers(0, 4 * max(target, 1) + 1))
        if rc == "vbv":
            qp, full = jspec.vbv_next(qp, full, bits, target, vbv)
        elif rc in ("bitrate", "mb"):
            qp = max(1, min(63, qp + max(-2, min(2, (bits - target) * 4 // target))))
        tqp, tfull = tgop.rc_carry_step(rc, target, vbv, tqp, tfull,
                                        torch.tensor(bits, dtype=torch.int64))
        assert (int(tqp), int(tfull)) == (qp, full)
    assert tqp.dtype == torch.int32


@pytest.mark.parametrize("cqpo", [0, 4, -12, 12])
def test_plane_qsteps_apply_chroma_offset(rng, cqpo):
    qp_mb = rng.integers(1, 64, (3, 4)).astype(np.int32)
    qy, qcb, qcr = tgop._plane_qsteps(_t(qp_mb), cqpo)
    qstep = np.asarray(jspec.QSTEP)
    assert _eq(qy, np.repeat(np.repeat(qstep[qp_mb], 2, 0), 2, 1))
    assert _eq(qcb, qstep[np.clip(qp_mb + cqpo, 1, 63)]) and torch.equal(qcb, qcr)
    assert qy.is_contiguous() and qcb.is_contiguous()
    assert tables.load("cpu").QMAT.tolist() == np.asarray(jspec.QMAT).tolist()
