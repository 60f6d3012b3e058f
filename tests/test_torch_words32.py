"""The port's word contract: a word is a torch.int32 holding the
reference's uint32 bit pattern, at every boundary on the CPU and on the
card. Held against the JAX reference on the CPU (its jnp path under
`dispatch.force("jnp")`, the Pallas merges in TPU interpret mode; the
`ref` fixture imports it, so the card host, which has no JAX, skips
those cases and runs the rest with --noconftest) on
seeded strings whose words have bit 31 set, so that a sign extension or
an arithmetic shift anywhere shows in the bytes. Tolerance 0: the codec
is integer. The refusal of int64 words by the kernel wrappers needs the
card and skips without one."""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from video_encoder_tpu_torch.codec import entropy, mux, pack
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.parallel import tiles
from video_encoder_tpu_torch.parallel.mesh import make_ring_mesh
from video_encoder_tpu_torch.parallel.ring import RingEncoder
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

BIT31 = np.uint32(0x80000000)


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.fixture
def ref():
    """The JAX reference's modules on its jnp path (dispatch.force("jnp")).
    Imported here, not at the top: the card host has no JAX, and there
    this file runs its card case alone."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from video_encoder_tpu.codec import entropy as ent
    from video_encoder_tpu.codec import golden
    from video_encoder_tpu.codec.config import EncoderConfig
    from video_encoder_tpu.ops import dispatch as jdispatch
    from video_encoder_tpu.ops.pallas import pack as ppack
    from video_encoder_tpu.parallel import ring, tiles as jtiles
    from video_encoder_tpu.pipeline import gop_engine

    jdispatch.force("jnp")
    yield types.SimpleNamespace(
        jax=jax, jnp=jnp, pltpu=pltpu, ent=ent, golden=golden,
        EncoderConfig=EncoderConfig, ppack=ppack, ring=ring, tiles=jtiles,
        gop_engine=gop_engine)
    jdispatch.force(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _as_int32(words_u32):
    """uint32 words as the port carries them: int32 of the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(words_u32, np.uint32).view(np.int32))


def _strings(rng, shape, w, bits):
    """MSB-first strings [*shape, w] uint32 with bit counts bits [*shape]:
    random words whose first bit is set wherever a string has bits (so
    every piece's first word has bit 31 set, and a piece ending at a word
    boundary leaves a set bit 31 in its last word too), zeros past each
    count."""
    bits = np.asarray(bits)
    keep = np.clip(bits[..., None] - np.arange(w) * 32, 0, 32).astype(np.uint64)
    vals = rng.integers(0, 2**32, (*bits.shape, w), dtype=np.uint64)
    vals[..., 0] |= np.uint64(BIT31)
    words = np.where(keep > 0, vals >> (np.uint64(32) - keep)
                     << (np.uint64(32) - keep), 0).astype(np.uint32)
    assert (words[bits > 0, 0] & BIT31).all()
    return words


def _bits(rng, shape, w, empty=0.15):
    """Bit counts [*shape] in [0, 32 w], some empty, some whole words, so
    the pieces land at every offset mod 32."""
    bits = rng.integers(0, 32 * w + 1, shape)
    bits[rng.random(shape) < empty] = 0
    whole = rng.random(shape) < 0.2
    bits[whole] = 32 * rng.integers(1, w + 1, int(whole.sum()))
    return bits.astype(np.int32)


def _masked(words, bits):
    """uint32 words with every bit past the string's count cleared."""
    words = np.asarray(words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    col = np.arange(words.shape[-1]) * 32
    keep = np.clip(np.asarray(bits)[..., None] - col, 0, 32).astype(np.uint64)
    mask = (((np.uint64(1) << keep) - np.uint64(1))
            << (np.uint64(32) - keep)).astype(np.uint32)
    return words & mask


# ---- every dispatch entry that returns words gives int32 -------------------

def _levels(rng, shape, density):
    lv = np.zeros((*shape, 64), np.int32)
    mask = rng.random(lv.shape) < density
    lv[mask] = rng.integers(-300, 301, int(mask.sum()))
    lv.reshape(-1, 64)[0] = rng.integers(-3925, 3926, 64)   # dense, long
    return lv


def _frame_args(rng, nby=2, nbx=3):
    return (_t(_levels(rng, (2 * nby, 2 * nbx), 0.2)),
            _t(_levels(rng, (nby, nbx), 0.1)),
            _t(_levels(rng, (nby, nbx), 0.1)),
            _t(rng.integers(-2, 3, (nby, nbx))), True,
            torch.from_numpy(rng.random((nby, nbx)) < 0.5),
            _t(rng.integers(-16, 17, (nby, nbx))),
            _t(rng.integers(-16, 17, (nby, nbx))))


def _entry_words(rng, entry):
    """The words that a dispatch entry (or a frame-level pack through it)
    returns on the CPU."""
    if entry.startswith("block_pack"):
        lv = _levels(rng, (6,), 0.3).reshape(-1, 64)
        fmt = 2 if entry.endswith("2") else 1
        dcp = _t(rng.integers(-40, 41, lv.shape[0])) if fmt == 2 else None
        return dispatch.block_pack(_t(lv), 16, dcp, fmt)[0]
    if entry == "span_merge_mb" or entry == "span_merge":
        n_mbs, w = 100, 78                              # two stages
        plan = pack.span_plan(n_mbs, w)
        bits = _bits(rng, (n_mbs, 8), 8)
        bits[:, 0] = np.minimum(bits[:, 0], 64)
        bits[:, 7] = 0
        src = _strings(rng, (n_mbs, 8), w, bits)
        words, sbits, _ = dispatch.span_merge_mb(
            _as_int32(src[:, 0, :2]), _as_int32(src[:, 1:5]),
            _as_int32(src[:, 5]), _as_int32(src[:, 6]),
            _t(bits.reshape(-1)), plan.m1, plan.cw1, plan.n1)
        if entry == "span_merge_mb":
            return words
        return dispatch.span_merge(words, sbits, plan.g, plan.stop,
                                   plan.cwf)[0]
    if entry == "chunk_merge":
        bits = _bits(rng, (64,), 4)
        return dispatch.chunk_merge(_as_int32(_strings(rng, (64,), 4, bits)),
                                    _t(bits), 16)[0]
    if entry == "pack_bits":
        v, l = entropy.mb_symbols(torch.from_numpy(
            _levels(rng, (2, 3, 6), 0.2)), _t(np.zeros((2, 3))), False,
            torch.zeros((2, 3), dtype=torch.bool), _t(np.zeros((2, 3))),
            _t(np.zeros((2, 3))))
        return entropy.pack_bits(v, l, entropy.max_words(6))[0]
    args = _frame_args(rng)
    if entry == "pack_frame_planes":
        return entropy.pack_frame_planes(*args, 16, 600)[0]
    if entry == "pack_frame_rows":
        return entropy.pack_frame_rows(*args, 16, 300)[0]
    return entropy.pack_frame_chunks(*args, 16)[0]


@pytest.mark.parametrize("force", [None, "plain"])
@pytest.mark.parametrize("entry", [
    "block_pack_f1", "block_pack_f2", "span_merge_mb", "span_merge",
    "chunk_merge", "pack_frame_planes", "pack_frame_chunks",
    "pack_frame_rows", "pack_bits"])
def test_dispatch_entries_return_int32_words(rng, entry, force):
    dispatch.force(force)
    try:
        words = _entry_words(rng, entry)
    finally:
        dispatch.force(None)
    assert words.dtype == torch.int32
    assert bool((words < 0).any())           # bit 31 set somewhere


# ---- shift_split: the logical shift of a word with bit 31 set --------------

def test_shift_split_is_the_uint32_shift(rng):
    w = rng.integers(0, 2**32, (32, 40), dtype=np.uint64).astype(np.uint32)
    w[:, :8] |= BIT31
    s = np.arange(32)[:, None]
    hi, lo = entropy.shift_split(_as_int32(w), torch.from_numpy(s))
    assert hi.dtype == lo.dtype == torch.int32
    w64, s64 = w.astype(np.uint64), s.astype(np.uint64)
    want_hi = (w64 >> s64).astype(np.uint32)
    want_lo = np.where(s == 0, 0, (w64 << (np.uint64(32) - s64))
                       & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi)
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo)


# ---- frame_concat and the merges against the reference ---------------------

@pytest.mark.parametrize("lead", [(), (3,)])
def test_frame_concat_bit31_equals_tree_concat(rng, ref, lead):
    n, w, n_words = 40, 6, 200
    bits = _bits(rng, (*lead, n), w)
    words = _strings(rng, (*lead, n), w, bits)
    got_w, got_b = entropy.frame_concat(_as_int32(words), _t(bits), n_words)
    assert got_w.dtype == torch.int32 and bool((got_w < 0).any())
    fn = ref.jax.jit(lambda a, b: ref.ent.tree_concat(a, b, n_words))
    if lead:
        fn = ref.jax.vmap(fn)
    want_w, want_b = fn(ref.jnp.asarray(words), ref.jnp.asarray(bits))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_w.numpy().view(np.uint32), np.asarray(want_w))


def _mb_sources(rng, n_mbs, w):
    bits = _bits(rng, (n_mbs, 8), w)
    bits[:, 0] = np.minimum(bits[:, 0], 38)      # the header: 2 words
    bits[:, 7] = 0
    src = _strings(rng, (n_mbs, 8), w, bits)
    return (src[:, 0, :2], src[:, 1:5], src[:, 5], src[:, 6],
            bits.reshape(-1))


def _payload(ref, strings, bits):
    return ref.tiles.bit_concat([(np.asarray(s, np.uint32), int(b))
                                 for s, b in zip(strings, bits) if b])


@pytest.mark.parametrize("n_mbs,w", [(30, 16), (100, 78)])
def test_span_merges_bit31_equal_super_merge_mb(rng, ref, n_mbs, w):
    """span_merge_mb, then span_merge where the plan has two stages (100
    MBs at BLOCK_WORDS_MAX), against the Pallas super_merge_mb; the host
    glue of each side's strings gives the same payload."""
    hw, yw, cbw, crw, pb = _mb_sources(rng, n_mbs, w)
    plan = pack.span_plan(n_mbs, w)
    words, bits, ovf = pack.span_merge_mb(
        _as_int32(hw), _as_int32(yw), _as_int32(cbw), _as_int32(crw), _t(pb),
        plan.m1, plan.cw1, plan.n1)
    if plan.two_stage:
        words, bits, ovf2 = pack.span_merge(words, bits, plan.g, plan.stop,
                                            plan.cwf)
        ovf = ovf | ovf2
    assert plan.two_stage == (w == 78) and not bool(ovf)
    assert words.dtype == torch.int32 and bool((words < 0).any())
    with ref.pltpu.force_tpu_interpret_mode():
        want_w, want_b, want_ovf = ref.ppack.super_merge_mb(
            ref.jnp.asarray(hw), ref.jnp.asarray(yw), ref.jnp.asarray(cbw),
            ref.jnp.asarray(crw), ref.jnp.asarray(pb))
    assert np.array_equal(bits.numpy(), np.asarray(want_b))
    assert np.array_equal(_masked(words, bits.numpy()),
                          _masked(np.asarray(want_w)[:, :words.shape[1]],
                                  bits.numpy()))
    got = mux.bit_concat([(s, int(b)) for s, b in
                          zip(words.numpy(), bits.numpy()) if b])
    assert got == _payload(ref, np.asarray(want_w), np.asarray(want_b))


def test_span_merge_stage2_bit31_equals_reduce(rng, ref):
    n, cw1, cwf = 64, 513, 2049
    bits = _bits(rng, (n,), cw1)
    strings = _strings(rng, (n,), cw1, bits)
    got_w, got_b, ovf = pack.span_merge(_as_int32(strings), _t(bits), 32, 8,
                                        cwf)
    with ref.pltpu.force_tpu_interpret_mode():
        want_w, want_b, _ = ref.ppack._reduce(
            ref.jnp.asarray(strings), ref.jnp.asarray(bits), 32, 8, cwf,
            ref.ppack._merge_budget(16), 128)
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    ok = got_b.numpy() <= 32 * cwf
    assert np.array_equal(_masked(got_w, got_b.numpy())[ok],
                          _masked(want_w, got_b.numpy())[ok])


def test_chunk_merge_bit31_equals_pallas(rng, ref):
    n, w, k = 128, 8, 32
    bits = _bits(rng, (n,), w)
    words = _strings(rng, (n,), w, bits)
    got_w, got_b = pack.chunk_merge(_as_int32(words), _t(bits), k)
    with ref.pltpu.force_tpu_interpret_mode():
        want_w, want_b = ref.ppack.chunk_merge(ref.jnp.asarray(words),
                                               ref.jnp.asarray(bits), k)
    assert got_w.dtype == torch.int32 and bool((got_w < 0).any())
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_w.numpy().view(np.uint32), np.asarray(want_w))


@pytest.mark.parametrize("fn", ["frame_concat", "span_merge_mb", "span_merge",
                                "chunk_merge"])
def test_plain_versions_refuse_int64_words(rng, fn):
    """An int64 word would be sign-free where the int32 one is negative:
    the plain versions refuse it instead of taking its low half."""
    words = torch.from_numpy(_strings(rng, (16,), 4, _bits(rng, (16,), 4))
                             .astype(np.int64))
    bits = _t(np.full(16, 40))
    calls = {
        "frame_concat": lambda: entropy.frame_concat(words, bits, 40),
        "span_merge_mb": lambda: pack.span_merge_mb(
            words[:2, :2], words[:2, :4, None].expand(2, 4, 4).contiguous(),
            words[:2], words[2:4], bits, 8, 40, 2),
        "span_merge": lambda: pack.span_merge(words, bits, 8, 4, 40),
        "chunk_merge": lambda: pack.chunk_merge(words, bits, 8),
    }
    with pytest.raises(TypeError, match="int32"):
        calls[fn]()


# ---- the host glue: bit_concat, the GOP engine, the 2-D grid, the ring -----

def test_bit_concat_bit31_equals_reference(rng, ref):
    bits = _bits(rng, (30,), 5)
    words = _strings(rng, (30,), 5, bits)
    want = ref.tiles.bit_concat([(s, int(b)) for s, b in zip(words, bits)])
    got32 = mux.bit_concat([(s.view(np.int32), int(b))
                            for s, b in zip(words, bits)])
    assert got32 == mux.bit_concat([(s, int(b)) for s, b in zip(words, bits)])
    assert got32 == want
    with pytest.raises(TypeError, match="32-bit"):
        mux.bit_concat([(words[0].astype(np.int64), int(bits[0]))])


def _outs(rng, t, emit, n_mbs):
    """A GOP's [T, ...] device results with bit-31 words: frame emit
    (words [T, cap], bits int64) or chunk emit (words [T, C, cw], cbits)."""
    outs = dict(n_inter=_t(rng.integers(0, n_mbs + 1, t)),
                qp=_t(rng.integers(20, 40, t)),
                sse=torch.from_numpy(rng.integers(1, 10**6, (t, 3))),
                ovf=torch.zeros(t, dtype=torch.bool))
    if emit == "frame":
        bits = rng.integers(1, 32 * 60, t)
        outs["words"] = _as_int32(_strings(rng, (t,), 64, bits))
    else:
        cbits = _bits(rng, (t, 5), 12)
        outs["words"] = _as_int32(_strings(rng, (t, 5), 12, cbits))
        outs["cbits"] = _t(cbits)
        bits = cbits.sum(-1)
    outs["bits"] = torch.from_numpy(bits.astype(np.int64))
    return outs


@pytest.mark.parametrize("emit", ["frame", "chunks"])
def test_gop_packets_bit31_equal_reference(rng, ref, emit):
    """download + gop_packets of int32 words against the reference
    engine's encode_gop_finish on the same words as uint32."""
    t, h, w = 3, 32, 48
    cfg = ref.EncoderConfig(width=w, height=h, gop_n=t, base_qp=28)
    planes = [(rng.integers(0, 256, (h, w)),
               rng.integers(0, 256, (h // 2, w // 2)),
               rng.integers(0, 256, (h // 2, w // 2))) for _ in range(t)]
    outs = _outs(rng, t, emit, (h // 16) * (w // 16))
    eng = GopEngine(config_from_dict(dataclasses.asdict(cfg)), device="cpu",
                    emit=emit)
    host = eng.download(outs)
    assert host["words"].dtype == np.uint32
    got, _ = eng.gop_packets([Frame.from_planes(*p) for p in planes], 7, host,
                             1.0)
    jouts = {k: ref.jnp.asarray(v.numpy().view(np.uint32) if k == "words"
                                else v.numpy()) for k, v in outs.items()}
    want, _ = ref.gop_engine.GopEngine(cfg).encode_gop_finish(dict(
        frames=[ref.golden.Frame.from_planes(*p) for p in planes],
        first_index=7, t0=time.perf_counter(), outs=jouts))
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]


def test_tile_grid_glue_bit31_equals_reference(rng, ref):
    """assemble_frame_2d of int32 words [T, Sr, Sc, nby_s, row_words]
    against the reference's on uint32 words [Sr, Sc, T, nby_s, ...]."""
    t, sr, sc, nby_s, row_words = 2, 2, 3, 2, 9
    row_bits = _bits(rng, (t, sr, sc, nby_s), row_words)
    words = _strings(rng, (t, sr, sc, nby_s), row_words, row_bits)
    for k in range(t):
        got = tiles.assemble_frame_2d(words.view(np.int32), row_bits, k)
        want = ref.tiles.assemble_frame_2d(np.moveaxis(words, 0, 2),
                                           np.moveaxis(row_bits, 0, 2), k)
        assert got == want


def test_ring_glue_bit31_equals_reference(rng, ref, monkeypatch):
    """The ring's packets from one step's int32 words [T, D, cap] against
    the reference RingEncoder's from the same words as uint32, three
    streams of lengths 3, 2, 1 on a ring of 4 (padded slots dropped)."""
    d, t, h, w = 4, 3, 32, 48
    cfg = ref.EncoderConfig(width=w, height=h, gop_n=t, base_qp=28)
    streams = [[ref.golden.Frame.from_planes(
        rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h // 2, w // 2)),
        rng.integers(0, 256, (h // 2, w // 2))) for _ in range(n)]
        for n in (3, 2, 1)]
    bits = rng.integers(1, 32 * 60, (t, d))
    words = _strings(rng, (t, d), 64, bits)
    qp = rng.integers(20, 40, (t, d)).astype(np.int32)
    outs = dict(words=_as_int32(words),
                bits=torch.from_numpy(bits.astype(np.int64)), qp=_t(qp),
                n_inter=torch.zeros((t, d), dtype=torch.int64),
                sse=torch.zeros((t, d, 3), dtype=torch.int64),
                ovf=torch.zeros(t, dtype=torch.bool))

    ring = RingEncoder(config_from_dict(dataclasses.asdict(cfg)),
                       make_ring_mesh(d, device="cpu"))
    monkeypatch.setattr(ring.engine, "run_batch", lambda *a, **k: outs)
    got = ring.encode_streams(
        [[Frame.from_planes(f.y, f.cb, f.cr) for f in s] for s in streams],
        [0, 10, 20])
    jnp = ref.jnp
    monkeypatch.setattr(ref.ring, "encode_ring_jit", lambda *a, **k: dict(
        words=jnp.asarray(words), bits=jnp.asarray(bits), qp=jnp.asarray(qp),
        ovf=jnp.zeros(t, bool)))
    want = ref.ring.RingEncoder(cfg, types.SimpleNamespace(
        shape={"ring": d})).encode_streams(streams, [0, 10, 20])
    assert [[p.to_bytes() for p in s] for s in got] == \
        [[p.to_bytes() for p in s] for s in want]


# ---- on the card: the kernel wrappers refuse int64 words -------------------

@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["block_pack", "span_merge_mb",
                                    "span_merge", "chunk_merge"])
def test_kernel_wrappers_take_and_give_int32_words(cuda, rng, kernel):
    """Each kernel's words come out int32; a merge handed int64 words
    raises and does not convert them."""
    from video_encoder_tpu_torch.ops.kernels import entropy_pack as kep
    from video_encoder_tpu_torch.ops.kernels import pack as kpack

    if kernel == "block_pack":
        lv = _t(_levels(rng, (8,), 0.3).reshape(-1, 64)).to(cuda)
        words, _ = kep.block_pack(lv, 16)
        assert words.dtype == torch.int32
        return
    bits = _bits(rng, (32,), 4)
    w32 = _as_int32(_strings(rng, (32,), 4, bits)).to(cuda)
    b = _t(bits).to(cuda)
    calls = {
        "span_merge_mb": lambda w: kpack.span_merge_mb(
            w[:4, :2].contiguous(), w[:16].reshape(4, 4, 4), w[16:20],
            w[20:24], b, 8, 40, 4),
        "span_merge": lambda w: kpack.span_merge(w, b, 8, 4, 40),
        "chunk_merge": lambda w: kpack.chunk_merge(w, b, 8),
    }
    assert calls[kernel](w32)[0].dtype == torch.int32
    with pytest.raises(ValueError, match="int32"):
        calls[kernel](w32.long())
