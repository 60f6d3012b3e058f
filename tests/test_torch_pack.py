"""Port span merges (codec/pack.py, the plain versions of the span_merge
kernels) vs the Pallas super_merge_mb / super_merge kernels in interpret
mode, and the chunk-emit pack vs the reference's. Tolerance 0: strings
compared masked to their bit counts, and the bit counts themselves."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_encoder_tpu.codec import entropy as jent
from video_encoder_tpu.ops.pallas import pack as ppack
from video_encoder_tpu_torch.codec import entropy, mux, pack
from video_encoder_tpu_torch.ops import dispatch

torch.set_num_threads(1)


def _strings(rng, n, w, bits):
    """Valid MSB-first strings [n, w] uint32 with the given bit counts
    (words past each count zero)."""
    words = np.zeros((n, w), np.uint32)
    for i, b in enumerate(bits):
        nw = (int(b) + 31) // 32
        vals = rng.integers(0, 2**32, nw, dtype=np.uint64).astype(np.uint32)
        if nw and b & 31:
            vals[-1] &= np.uint32(0xFFFFFFFF) << np.uint32(32 - (b & 31))
        words[i, :nw] = vals
    return words


def _mb_sources(rng, n_mbs, w, max_bits):
    """Per-MB sources as the pack makes them: header (<= 38 bits, 2
    words), four luma, Cb, Cr strings; piece bits in piece order."""
    hb = rng.integers(1, 39, n_mbs)
    bits = rng.integers(0, max_bits + 1, (n_mbs, 6))
    bits[rng.random((n_mbs, 6)) < 0.2] = 0
    hw = _strings(rng, n_mbs, 2, hb)
    blocks = _strings(rng, n_mbs * 6, w, bits.reshape(-1)).reshape(n_mbs, 6, w)
    pb = np.concatenate([hb[:, None], bits, np.zeros((n_mbs, 1), int)], 1)
    return hw, blocks[:, :4], blocks[:, 4], blocks[:, 5], pb.reshape(-1).astype(np.int32)


def _t32(a):
    """uint32 words as the port carries them: int32 of the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


def _masked(words, bits):
    """Words with every bit past the string's count cleared (int32 words
    are viewed as uint32 before they widen)."""
    words = np.asarray(words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    words = words.astype(np.uint64)
    col = np.arange(words.shape[1])[None, :] * 32
    keep = np.clip(np.asarray(bits)[:, None] - col, 0, 32).astype(np.uint64)
    mask = ((np.uint64(1) << keep) - np.uint64(1)) << (np.uint64(32) - keep)
    return words & mask


def _port_spans(hw, yw, cbw, crw, pb, w):
    plan = pack.span_plan(yw.shape[0], w)
    words, bits, ovf = pack.span_merge_mb(
        _t32(hw), _t32(yw), _t32(cbw), _t32(crw), torch.from_numpy(pb),
        plan.m1, plan.cw1, plan.n1)
    if plan.two_stage:
        words, bits, ovf2 = pack.span_merge(words, bits, plan.g, plan.stop,
                                            plan.cwf)
        ovf = ovf | ovf2
    return plan, words.numpy(), bits.numpy(), bool(ovf)


@pytest.mark.parametrize("n_mbs,w,max_bits,two_stage", [
    (30, 16, 200, False),     # single stage: 240 pieces -> strings of 16
    (7, 16, 300, False),      # tiny frame: strings of 4 pieces, half an MB
    (100, 78, 900, True),     # BLOCK_WORDS_MAX: k1 = 256, two stages
    (130, 48, 500, False),    # single stage of 64 pieces, budgeted width
])
def test_span_merge_matches_super_merge_mb(rng, n_mbs, w, max_bits, two_stage):
    hw, yw, cbw, crw, pb = _mb_sources(rng, n_mbs, w, max_bits)
    plan, got_w, got_b, got_ovf = _port_spans(hw, yw, cbw, crw, pb, w)
    assert plan.two_stage == two_stage
    with pltpu.force_tpu_interpret_mode():
        want_w, want_b, want_ovf = ppack.super_merge_mb(
            jnp.asarray(hw), jnp.asarray(yw), jnp.asarray(cbw),
            jnp.asarray(crw), jnp.asarray(pb))
    assert got_w.shape == np.asarray(want_w).shape
    assert np.array_equal(got_b, np.asarray(want_b))
    assert not got_ovf or bool(want_ovf)       # the port flags less, never more
    if not bool(want_ovf):
        assert np.array_equal(_masked(got_w, got_b),
                              _masked(want_w, got_b))
    # the host glue of the span strings is the frame payload
    pieces = np.concatenate([
        np.pad(hw, ((0, 0), (0, w - 2)))[:, None], yw, cbw[:, None],
        crw[:, None], np.zeros((n_mbs, 1, w), np.uint32)], 1).reshape(-1, w)
    want_payload, want_bits = jent.tree_concat(
        jnp.asarray(pieces), jnp.asarray(pb), int(pb.sum() + 31) // 32 + 1)
    payload, nbits = mux.bit_concat(
        [(got_w[s].view(np.uint32), int(b)) for s, b in enumerate(got_b)])
    assert nbits == int(want_bits)
    nw = (nbits + 31) // 32
    assert payload == np.asarray(want_payload)[:nw].astype(">u4").tobytes()


def test_span_merge_stage2_matches_reduce(rng):
    """Stage 2 alone against the Pallas reduce kernel: 64 stage-1 strings
    of 513 words at w = 16 (k1 = 1024, m1 = 128) -> 16 spans of 2049."""
    n, cw1, cwf = 64, 513, 2049
    bits = rng.integers(0, 32 * cw1 + 1, n).astype(np.int32)
    bits[::7] = 0
    strings = _strings(rng, n, cw1, bits)
    words, got_b, ovf = pack.span_merge(_t32(strings), torch.from_numpy(bits),
                                        32, 8, cwf)
    with pltpu.force_tpu_interpret_mode():
        want_w, want_b, want_ovf = ppack._reduce(
            jnp.asarray(strings), jnp.asarray(bits), 32, 8, cwf,
            ppack._merge_budget(16), 128)
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert not bool(ovf) or bool(want_ovf)
    ok = got_b.numpy() <= 32 * cwf
    assert np.array_equal(_masked(words.numpy(), got_b.numpy())[ok],
                          _masked(want_w, got_b.numpy())[ok])


@pytest.mark.parametrize("bits_per_piece,overflows", [(300, True), (64, False)])
def test_span_merge_overflow_flag(rng, bits_per_piece, overflows):
    """Dense 300-bit pieces at w = 16 fit their 512-bit block budget but
    overflow the 128-piece stage-1 width (513 words = 16416 bits), as in
    tests/test_merge_budget_overflow.py; sparse 64-bit pieces do not. The
    reference flags every input the port flags."""
    n_mbs, w = 128, 16
    hw = np.zeros((n_mbs, 2), np.uint32)
    blocks = _strings(rng, n_mbs * 6, w, [bits_per_piece] * (n_mbs * 6))
    blocks = blocks.reshape(n_mbs, 6, w)
    pb = np.zeros((n_mbs, 8), np.int32)
    pb[:, 1:7] = bits_per_piece
    pb = pb.reshape(-1)
    _, _, _, ovf = _port_spans(hw, blocks[:, :4], blocks[:, 4], blocks[:, 5],
                               pb, w)
    assert ovf == overflows
    with pltpu.force_tpu_interpret_mode():
        _, _, want_ovf = ppack.super_merge_mb(
            jnp.asarray(hw), jnp.asarray(blocks[:, :4]),
            jnp.asarray(blocks[:, 4]), jnp.asarray(blocks[:, 5]),
            jnp.asarray(pb))
    assert not ovf or bool(want_ovf)


@pytest.mark.parametrize("n_pieces,w", [(240, 16), (65280, 16), (800, 78),
                                        (1920, 24), (56, 16)])
def test_span_geometry_is_the_reference(n_pieces, w):
    assert pack.span_geometry(n_pieces, w) == ppack.span_geometry(n_pieces, w)
    assert pack._merge_budget(w) == ppack._merge_budget(w)
    assert pack._stage1_k(w) == ppack._stage1_k(w)
    assert entropy.chunk_capacity(n_pieces, w) == jent.chunk_capacity(n_pieces, w)


@pytest.mark.parametrize("is_p", [True, False])
def test_pack_frame_chunks_matches_reference(rng, is_p):
    nby, nbx, bw = 4, 6, 16

    def levels(shape, density):
        lv = np.zeros(shape + (64,), np.int32)
        mask = rng.random(shape + (64,)) < density
        lv[mask] = rng.integers(-20, 21, mask.sum())
        return lv

    ly, lcb, lcr = levels((2 * nby, 2 * nbx), 0.1), levels((nby, nbx), 0.05), \
        levels((nby, nbx), 0.05)
    qpd = rng.integers(-2, 3, (nby, nbx)).astype(np.int32)
    inter = rng.random((nby, nbx)) < 0.5
    dy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    t = [torch.from_numpy(a) for a in (ly, lcb, lcr, qpd)]
    gw, gb, gmb, govf = entropy.pack_frame_chunks(
        *t, is_p, torch.from_numpy(inter), torch.from_numpy(dy),
        torch.from_numpy(dx), bw)
    ww, wb, wmb, wovf = jent.pack_frame_chunks(
        *(jnp.asarray(a) for a in (ly, lcb, lcr, qpd)), is_p,
        jnp.asarray(inter), jnp.asarray(dy), jnp.asarray(dx), bw)
    assert np.array_equal(gb.numpy(), np.asarray(wb))
    assert np.array_equal(gmb.numpy(), np.asarray(wmb))
    assert bool(govf) == bool(wovf) is False
    width = gw.shape[1]
    assert np.array_equal(_masked(gw.numpy(), gb.numpy()),
                          _masked(np.asarray(ww)[:, :width], gb.numpy()))
    # the rc=mb pass-1 estimate is the pack's per-MB bit count
    est = entropy.frame_mb_bits(*t, is_p, torch.from_numpy(inter),
                                torch.from_numpy(dy), torch.from_numpy(dx), bw)
    assert torch.equal(est, gmb)
    # the frame payload equals frame emit's
    fw, fbits, _, _ = entropy.pack_frame_planes(
        *t, is_p, torch.from_numpy(inter), torch.from_numpy(dy),
        torch.from_numpy(dx), bw, 4096)
    payload, nbits = mux.bit_concat(
        [(gw[s].numpy(), int(b)) for s, b in enumerate(gb)])
    assert nbits == int(fbits)
    nw = (nbits + 31) // 32
    assert gw.dtype == fw.dtype == torch.int32
    assert payload == fw[:nw].numpy().view(np.uint32).astype(">u4").tobytes()


def test_dispatch_span_merge_on_cpu_is_the_plain_version(rng):
    hw, yw, cbw, crw, pb = _mb_sources(rng, 12, 16, 100)
    args = (_t32(hw), _t32(yw), _t32(cbw), _t32(crw), torch.from_numpy(pb),
            16, 257, 6)
    got = dispatch.span_merge_mb(*args)
    want = pack.span_merge_mb(*args)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
