"""Port format-1 entropy pack vs the JAX reference
(video_encoder_tpu/codec/entropy.py and the block_pack Pallas kernel in
interpret mode). Tolerance 0 on words and bit counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_encoder_tpu.codec import entropy as jent
from video_encoder_tpu.ops.pallas import entropy_pack as ep
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.ops.kernels import entropy_pack as kpack

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _levels(rng, n, density, mag=3000, extremes=True):
    lv = np.zeros((n, 64), np.int32)
    mask = rng.random((n, 64)) < density
    lv[mask] = rng.integers(-mag, mag + 1, mask.sum())
    lv[0] = 0                                    # all-zero block
    lv[2, 63] = 1                                # single trailing coef
    if extremes:
        lv[1] = rng.integers(-3925, 3926, 64)    # dense, extreme: overflows
        lv[3, 0] = -3925                         # DC-only
    return lv


def test_ue_se_codes(rng):
    v = rng.integers(-5000, 5000, 300).astype(np.int32)
    for tf, jf in ((entropy.se_code, jent.se_code),
                   (entropy.ue_code, jent.ue_code)):
        x = np.abs(v) if tf is entropy.ue_code else v
        (gv, gl), (wv, wl) = tf(_t(x)), jf(jnp.asarray(x))
        assert np.array_equal(gv.numpy(), np.asarray(wv).astype(np.int64))
        assert np.array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("n,words", [(37, 16), (300, 24), (64, 78)])
def test_block_pack_matches_reference(rng, n, words):
    lv = _levels(rng, n, 0.2)
    v, l = jent.block_symbols(jnp.asarray(lv))
    want_w, want_b, want_ovf = jent.pack_dense(v, l, words)
    got_w, got_b = kpack.block_pack(_t(lv), words)   # CPU: plain version
    assert got_w.dtype == torch.int64 and got_b.dtype == torch.int32
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_w.numpy(), np.asarray(want_w).astype(np.int64))
    assert bool((got_b > 32 * words).any()) == bool(want_ovf)
    # and against the Pallas kernel itself, run in interpret mode
    pw, pb = ep._block_pack_impl(jnp.asarray(lv), jnp.zeros((n, 1), jnp.int32),
                                 1, words, interpret=True)
    assert np.array_equal(got_b.numpy(), np.asarray(pb))
    assert np.array_equal(got_w.numpy(), np.asarray(pw).astype(np.int64))


def test_block_pack_overflow_keeps_true_length(rng):
    lv = rng.integers(-3925, 3926, (8, 64)).astype(np.int32)
    words, bits = kpack.block_pack(_t(lv), 16)
    assert int(bits.min()) > 32 * 16
    full, _ = kpack.block_pack(_t(lv), entropy.BLOCK_WORDS_MAX)
    assert torch.equal(full[:, :16], words)       # truncation, not garbage


def test_pack_header_matches_reference(rng):
    nby, nbx = 3, 5
    is_inter = rng.random((nby, nbx)) < 0.6
    dy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    qpd = rng.integers(-3, 4, (nby, nbx)).astype(np.int32)
    for is_p in (False, True):
        jv, jl = jent._header_slots(jnp.asarray(qpd), is_p,
                                    jnp.asarray(is_inter), jnp.asarray(dy),
                                    jnp.asarray(dx))
        ww, wb, _ = jent.pack_header(jv, jl)
        tv, tl = entropy._header_slots(_t(qpd), is_p,
                                       torch.from_numpy(is_inter), _t(dy),
                                       _t(dx))
        gw, gb, _ = entropy.pack_header(tv, tl)
        assert np.array_equal(gb.numpy(), np.asarray(wb))
        assert np.array_equal(gw.numpy(), np.asarray(ww).astype(np.int64))


@pytest.mark.parametrize("is_p,cap", [(True, 600), (False, 600), (True, 40)])
def test_frame_assembly_matches_pack_frame_planes(rng, is_p, cap):
    nby, nbx, bw = 2, 3, 16
    # no block overflows its 16 words: the frame cap alone is under test
    ly = _levels(rng, 4 * nby * nbx, 0.1, 40, False).reshape(2 * nby, 2 * nbx, 64)
    lcb = _levels(rng, nby * nbx, 0.05, 20, False).reshape(nby, nbx, 64)
    lcr = _levels(rng, nby * nbx, 0.05, 20, False).reshape(nby, nbx, 64)
    ly[0, 1, :] = rng.integers(-3, 4, 64)
    qpd = np.zeros((nby, nbx), np.int32)
    is_inter = rng.random((nby, nbx)) < 0.5
    dy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    ww, wbits, wmb, wovf = jent.pack_frame_planes(
        jnp.asarray(ly), jnp.asarray(lcb), jnp.asarray(lcr), jnp.asarray(qpd),
        is_p, jnp.asarray(is_inter), jnp.asarray(dy), jnp.asarray(dx), bw, cap)
    gw, gbits, gmb, govf = entropy.pack_frame_planes(
        _t(ly), _t(lcb), _t(lcr), _t(qpd), is_p, torch.from_numpy(is_inter),
        _t(dy), _t(dx), bw, cap)
    assert int(gbits) == int(wbits)
    assert bool(govf) == bool(wovf) == (int(gbits) > 32 * cap)
    assert np.array_equal(gmb.numpy(), np.asarray(wmb))
    if not govf:
        assert np.array_equal(gw.numpy(), np.asarray(ww).astype(np.int64))
    else:  # words of an overflowing frame are never emitted (worst-case
        # rerun); the port's are the stream's first `cap` words
        full, _, _, _ = entropy.pack_frame_planes(
            _t(ly), _t(lcb), _t(lcr), _t(qpd), is_p,
            torch.from_numpy(is_inter), _t(dy), _t(dx), bw, 600)
        assert torch.equal(gw, full[:cap])
