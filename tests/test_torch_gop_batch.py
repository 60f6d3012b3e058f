"""The batched-GOP encode of the port (GopEngine.start of G GOPs,
run_batch) on the CPU, mirroring tests/test_gop_batch.py at its size
(48x32, T = 3, G = 3): the packets of G GOPs encoded in lockstep equal,
byte for byte, the port's own sequential encode_gop packets and the
reference GopEngine.encode_gops packets, under every rc mode, formats 1
to 4, diamond search, per-GOP base qps, the overflow rerun and both
emits. Then the pieces that carry the G axis: the frame assembly, the
folded span merges, the rate-control carry. Tolerance 0: integer codec."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from conftest import make_clip
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.pipeline import gop_engine as jgop
from video_encoder_tpu_torch.codec import entropy, pack
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline import gop_engine
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

W, H, T, G = 48, 32, 3, 3
FIRSTS = [i * T for i in range(G)]

# name -> (config fields, per-GOP base qps or None)
_CASES = {
    "rc-none": (dict(), None),
    "rc-adaptive": (dict(rc="adaptive"), None),
    "rc-bitrate": (dict(rc="bitrate", target_kbps=300), None),
    "rc-vbv": (dict(rc="vbv", target_kbps=300, vbv_kbits=150), None),
    "rc-mb": (dict(rc="mb", target_kbps=300), None),
    "v2": (dict(format_version=2, chroma_qp_offset=2), None),
    "v3": (dict(format_version=3, chroma_qp_offset=2), None),
    "v3-qmat": (dict(format_version=3, chroma_qp_offset=2, quant_matrix=True),
                None),
    "v4": (dict(format_version=4, chroma_qp_offset=2), None),
    "diamond": (dict(search="diamond"), None),
    "per-gop-qps": (dict(), [22, 26, 31]),
    "overflow-qp4": (dict(base_qp=4), None),
}


def _clip():
    return make_clip(np.random.default_rng(2024), W, H, T * G)


def _split(frames):
    return [frames[i * T:(i + 1) * T] for i in range(G)]


@functools.lru_cache(maxsize=None)
def _reference_packets(case):
    """The reference GopEngine.encode_gops packets of a case (one JAX
    compile, shared by both emits), on its jnp route."""
    kw, qps = _CASES[case]
    rcfg = EncoderConfig(**{**dict(width=W, height=H, gop_n=T, base_qp=26), **kw})
    gops = _split([golden.Frame.from_planes(*p) for p in _clip()])
    jdispatch.force("jnp")
    try:
        out = jgop.GopEngine(rcfg).encode_gops(gops, FIRSTS, qps)
    finally:
        jdispatch.force(None)
    return rcfg, [[p.to_bytes() for p in pk] for pk, _ in out]


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_batch_matches_sequential_and_reference(case, emit):
    rcfg, want = _reference_packets(case)
    qps = _CASES[case][1]
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    gops = _split([Frame.from_planes(*p) for p in _clip()])
    eng = GopEngine(cfg, device="cpu", emit=emit)
    seq = [eng.encode_gop(g, f, None if qps is None else qps[i])
           for i, (g, f) in enumerate(zip(gops, FIRSTS))]
    handle = eng.start(gops, FIRSTS, qps)
    if case == "overflow-qp4" and emit == "frame":
        # the frame capacity overflowed: the whole batch is run again (the
        # span strings at BLOCK_WORDS_MAX are exact and do not overflow)
        assert bool(handle.outs["ovf"].any())
    bat = eng.finish(handle)
    assert len(bat) == G
    for gi, ((sp, ss), (bp, bs)) in enumerate(zip(seq, bat)):
        got = [p.to_bytes() for p in bp]
        assert got == [p.to_bytes() for p in sp]
        assert got == want[gi]
        assert [p.index for p in bp] == list(range(FIRSTS[gi], FIRSTS[gi] + T))
        for a, b in zip(ss, bs):    # the stats are each GOP's own
            assert (a.bits, a.base_qp, a.n_inter_mb, a.n_intra_mb) == (
                b.bits, b.base_qp, b.n_inter_mb, b.n_intra_mb)
            assert a.psnr_y == b.psnr_y and a.psnr_cr == b.psnr_cr
    if case.startswith("rc-") and case not in ("rc-none", "rc-adaptive"):
        assert len({p.base_qp for bp, _ in bat for p in bp}) > 1   # the carry moved
    if qps is not None:
        assert [bp[0].base_qp for bp, _ in bat] == qps
    assert len({tuple(p.payload for p in bp) for bp, _ in bat}) == G   # GOPs differ


def test_batch_order_is_the_order_given():
    """GOPs handed over in another order come back in that order."""
    cfg = config_from_dict(dict(width=W, height=H, gop_n=T, base_qp=26))
    gops = _split([Frame.from_planes(*p) for p in _clip()])
    eng = GopEngine(cfg, device="cpu")
    a = eng.finish(eng.start(gops, FIRSTS, [22, 26, 31]))
    b = eng.finish(eng.start(gops[::-1], FIRSTS[::-1], [31, 26, 22]))
    for (ap, _), (bp, _) in zip(a, b[::-1]):
        assert [p.to_bytes() for p in ap] == [p.to_bytes() for p in bp]


def test_batch_of_one_and_unequal_lengths():
    cfg = config_from_dict(dict(width=W, height=H, gop_n=T, base_qp=26))
    gops = _split([Frame.from_planes(*p) for p in _clip()])
    eng = GopEngine(cfg, device="cpu")
    (one, _), = eng.finish(eng.start(gops[:1], [0]))
    alone, _ = eng.encode_gop(gops[0], 0)
    assert [p.to_bytes() for p in one] == [p.to_bytes() for p in alone]
    # a lockstep launch of one GOP ([T, 1, H, W] planes through run_batch)
    # gives the same packets through the same finish
    planes = eng.upload(lambda p: [getattr(f, p) for f in gops[0]], (T, 1))
    qps = [cfg.base_qp]
    (batch, _), = eng.finish(gop_engine.Launch(
        gops[:1], [0], *planes, qps, eng.run_batch(*planes, qps), 0.0,
        eng.run_batch, eng.download))
    assert [p.to_bytes() for p in batch] == [p.to_bytes() for p in alone]
    with pytest.raises(ValueError, match="equal length"):
        eng.finish(eng.start([gops[0], gops[1][:2]], [0, 3]))


def test_run_batch_shapes_and_block_budget(monkeypatch):
    """run_batch takes [T, G, H, W] planes and returns [T, G, ...] tensors
    with one overflow flag per frame step; the block budget is that of the
    smallest qp of the batch, the worst case under xl."""
    seen = []
    real = gop_engine.code_pack_traced
    monkeypatch.setattr(gop_engine, "code_pack_traced", lambda *a, **kw: (
        seen.append((kw["block_words"], kw["cap_words"])) or real(*a, **kw)))
    cfg = config_from_dict(dict(width=W, height=H, gop_n=T))
    eng = GopEngine(cfg, device="cpu", emit="chunks")
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (T, G, H, W), dtype=np.uint8))
    c = torch.from_numpy(rng.integers(0, 256, (2, T, G, H // 2, W // 2),
                                      dtype=np.uint8))
    outs = eng.run_batch(y, c[0], c[1], [30, 15, 22])
    n_mbs = (H // 16) * (W // 16)
    assert seen == [(gop_engine.block_words_for_qp(15),
                     entropy.capacity_words(n_mbs))] * T
    assert outs["bits"].shape == outs["n_inter"].shape == outs["qp"].shape == (T, G)
    assert outs["sse"].shape == (T, G, 3) and outs["ovf"].shape == (T,)
    assert outs["words"].shape[:2] == outs["cbits"].shape[:2] == (T, G)
    assert outs["qp"][0].tolist() == [30, 15, 22]
    assert outs["bits"].dtype == torch.int64 and outs["qp"].dtype == torch.int32
    assert outs["words"].dtype == torch.int32
    seen.clear()
    eng.run_batch(y, c[0], c[1], [30, 15, 22], xl=True)
    assert seen == [(entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs))] * T


def _levels(rng, lead, by, bx, density):
    lv = np.zeros((*lead, by, bx, 64), np.int64)
    mask = rng.random(lv.shape) < density
    lv[mask] = rng.integers(-40, 41, mask.sum())
    return torch.from_numpy(lv.astype(np.int32))


def _frame_args(rng, g, nby, nbx, density=0.08):
    lead = (g,)
    return (_levels(rng, lead, 2 * nby, 2 * nbx, density),
            _levels(rng, lead, nby, nbx, density),
            _levels(rng, lead, nby, nbx, density),
            torch.from_numpy(rng.integers(-2, 3, (g, nby, nbx)).astype(np.int32)),
            True,
            torch.from_numpy(rng.random((g, nby, nbx)) < 0.7),
            torch.from_numpy(rng.integers(-16, 17, (g, nby, nbx)).astype(np.int32)),
            torch.from_numpy(rng.integers(-16, 17, (g, nby, nbx)).astype(np.int32)))


def _one(args, g):
    return tuple(a[g] if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("fmt", [1, 2])
def test_batched_frame_pack_restarts_at_every_gop(rng, fmt):
    """pack_frame_planes on [G, ...]: each GOP's payload, bit count and
    per-MB bits are what the frame alone gives (the prefix sum restarts,
    the left-neighbour predictors stay inside the plane)."""
    g, nby, nbx = 3, 2, 3
    args = _frame_args(rng, g, nby, nbx)
    cap = entropy.capacity_words(nby * nbx)
    words, total, mb_bits, ovf = entropy.pack_frame_planes(*args, 24, cap, fmt=fmt)
    assert words.shape == (g, cap) and total.shape == (g,) and not bool(ovf)
    assert mb_bits.shape == (g, nby, nbx)
    est = entropy.frame_mb_bits(*args, 24, fmt)
    assert torch.equal(est, mb_bits)
    for i in range(g):
        w1, t1, m1, _ = entropy.pack_frame_planes(*_one(args, i), 24, cap, fmt=fmt)
        assert torch.equal(w1, words[i]) and int(t1) == int(total[i])
        assert torch.equal(m1, mb_bits[i])
    assert len({int(t) for t in total}) == g
    # one GOP past a tiny capacity raises the batch's one flag
    assert bool(entropy.pack_frame_planes(*args, 24, int(total.max()) // 32 - 1,
                                          fmt=fmt)[3])


@pytest.mark.parametrize("nby,nbx,two_stage,padded", [
    (2, 3, False, True), (4, 4, False, False), (20, 20, True, True)])
def test_batched_chunk_pack_folds_without_leaking(rng, nby, nbx, two_stage,
                                                  padded):
    """pack_frame_chunks on [G, ...] launches each merge once on G * n
    rows: every GOP's span strings are the frame's own, for single-stage
    and two-stage plans, with and without empty MBs padded in."""
    g, bw = 3, 16
    plan = pack.span_plan(nby * nbx, bw)
    assert plan.two_stage == two_stage
    assert (plan.n1 * plan.m1 > 8 * nby * nbx) == padded
    args = _frame_args(rng, g, nby, nbx, 0.03)
    words, bits, mb_bits, ovf = entropy.pack_frame_chunks(*args, bw, fmt=2)
    assert words.shape == (g, plan.n_strings, plan.cwf) and not bool(ovf)
    assert bits.shape == (g, plan.n_strings)
    for i in range(g):
        w1, b1, m1, _ = entropy.pack_frame_chunks(*_one(args, i), bw, fmt=2)
        assert torch.equal(w1, words[i]) and torch.equal(b1, bits[i])
        assert torch.equal(m1, mb_bits[i])


def test_folded_merges_launch_once(rng, monkeypatch):
    """block_pack runs once per plane and each span merge once per frame
    step, whatever G is."""
    from video_encoder_tpu_torch.ops import dispatch

    counts = {"block_pack": 0, "span_merge_mb": 0, "span_merge": 0}
    for name in counts:
        real = getattr(dispatch, name)
        monkeypatch.setattr(dispatch, name, lambda *a, _n=name, _f=real, **kw: (
            counts.__setitem__(_n, counts[_n] + 1) or _f(*a, **kw)))
    entropy.pack_frame_chunks(*_frame_args(rng, 4, 20, 20, 0.03), 16, fmt=2)
    assert counts == {"block_pack": 3, "span_merge_mb": 1, "span_merge": 1}


@pytest.mark.parametrize("rc", ["bitrate", "vbv", "mb", "none"])
def test_rc_carry_step_is_elementwise_over_gops(rc):
    from video_encoder_tpu.codec import spec as jspec

    target, vbv = 9000, 40000
    qp = torch.tensor([1, 26, 40, 63], dtype=torch.int32)
    fullness = torch.tensor([0, 20000, 35000, 40000], dtype=torch.int64)
    bits = torch.tensor([200000, 9000, 100, 2_000_000_000], dtype=torch.int64)
    q2, f2 = gop_engine.rc_carry_step(rc, target, vbv, qp, fullness, bits)
    assert q2.shape == (4,) and q2.dtype == torch.int32 and f2.dtype == torch.int64
    for i in range(4):
        q1, f1 = gop_engine.rc_carry_step(rc, target, vbv, qp[i], fullness[i],
                                          bits[i])
        assert int(q1) == int(q2[i]) and int(f1) == int(f2[i])
        if rc == "vbv":
            assert (int(q1), int(f1)) == jspec.vbv_next(
                int(qp[i]), int(fullness[i]), int(bits[i]), target, vbv)


def test_mb_rc_offsets_per_gop(rng):
    from video_encoder_tpu.codec import spec as jspec

    est = rng.integers(0, 5000, (3, 4, 6))
    est[1, 2] = 0                                   # an empty MB row
    got = gop_engine.mb_rc_offsets(torch.from_numpy(est))
    for g in range(3):
        assert np.array_equal(got[g].numpy(), jspec.mb_rc_offsets(est[g]))
