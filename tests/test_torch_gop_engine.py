"""Port GopEngine (plain PyTorch on the CPU) vs the JAX GopEngine and the
numpy golden model: packet byte-equality under both emits, full and
diamond search, formats 1 to 4, every rc mode, including the exact
overflow -> worst-case rerun. One JAX GopEngine compile per configuration.
The port takes its own EncoderConfig and Frame classes, made from the
reference's by `config_from_dict` and `Frame.from_planes`."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from conftest import make_clip
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.pipeline import gop_engine as jgop
from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_gop
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)


def _frames(clip):
    return [golden.Frame.from_planes(*p) for p in clip]


def test_gop_engine_matches_jax_engine_and_golden(rng):
    frames = _frames(make_clip(rng, 48, 32, 4))
    cfg = EncoderConfig(width=48, height=32, gop_n=4, base_qp=28)
    gpk, gst = encode_gop(cfg, GoldenEngine(), frames, 0, 0)
    jpk, jst = jgop.GopEngine(cfg).encode_gop(frames, 0)
    tpk, tst = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in jpk]
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]
    for t, j, g in zip(tst, jst, gst):
        assert (t.frame_type, t.base_qp, t.bits) == (j.frame_type, j.base_qp, j.bits)
        assert (t.n_intra_mb, t.n_inter_mb) == (j.n_intra_mb, j.n_inter_mb)
        # the JAX engine sums SSE in float32, the port in int64
        for a, b in ((t.psnr_y, j.psnr_y), (t.psnr_cb, j.psnr_cb),
                     (t.psnr_cr, j.psnr_cr)):
            assert abs(a - b) < 1e-3
        assert abs(t.psnr_y - g.psnr_y) < 1e-9


@pytest.mark.parametrize("w,h,qp", [(64, 48, 28), (80, 48, 20), (48, 40, 36)])
def test_gop_engine_matches_golden(rng, w, h, qp):
    frames = _frames(make_clip(rng, w, h, 3))
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=qp)
    gpk, _ = encode_gop(cfg, GoldenEngine(), frames, 5, 5)
    tpk, tst = GopEngine(cfg, device="cpu").encode_gop(frames, 5)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]
    assert [p.index for p in tpk] == [5, 6, 7]
    assert tst[0].n_inter_mb == 0 and tst[1].frame_type == 1


def test_overflow_rerun_matches_golden(rng):
    """Noise at qp 1 overflows the budgeted frame capacity: the GOP is
    encoded again at worst-case capacity, with the same bytes as golden."""
    h, w = 32, 48
    clip = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(3)]
    frames = _frames(clip)
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=1)
    eng = GopEngine(cfg, device="cpu")
    handle = eng.start([frames], [0])
    assert bool(handle.outs["ovf"].any())             # the budget overflowed
    tpk, _ = eng.finish(handle)[0]
    gpk, _ = encode_gop(cfg, GoldenEngine(), frames, 0, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]


@pytest.mark.parametrize("change,kw", [
    (dict(gop_devices=2), {}),
    (dict(tile_devices=2), {}),
    (dict(gop_devices=2, tile_devices=2), {}),
    (dict(gop_devices=4, format_version=4), dict(emit="frame")),
    (dict(tile_devices=2, format_version=3, intra_slice_mbrows=1),
     dict(emit="chunks")),
])
def test_unported_settings_raise(change, kw):
    cfg = dataclasses.replace(EncoderConfig(width=32, height=32), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A"):
        GopEngine(cfg, device="cpu", **kw)


def test_cuda_device_is_never_silently_cpu():
    cfg = EncoderConfig(width=32, height=32)
    if torch.cuda.is_available():
        assert GopEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GopEngine(cfg)


def _skewed_clip(rng, w, h, n):
    """Left half flat, right half noise (tests/test_rc_mb.py): each MB
    row overspends its uniform pace late, so rc=mb offsets fire."""
    clip = []
    for t in range(n):
        y = np.full((h, w), 120, np.uint8)
        y[:, w // 2:] = rng.integers(0, 256, (h, w // 2))
        y[t % h, :] = 200
        clip.append((y, np.full((h // 2, w // 2), 128, np.uint8),
                     np.full((h // 2, w // 2), 128, np.uint8)))
    return clip


_DIAMOND_CASES = {
    # rc=mb on skewed content: per-MB offsets and the frame carry engage
    "mb": (lambda rng: _skewed_clip(rng, 96, 48, 5),
           dict(width=96, height=48, gop_n=5, base_qp=26, search="diamond",
                rc="mb", target_kbps=64)),
    # rc=bitrate (the frame half of mb): the carry moves qp up and down
    "bitrate": (lambda rng: make_clip(rng, 96, 48, 4),
                dict(width=96, height=48, gop_n=4, base_qp=24,
                     search="diamond", rc="bitrate", target_kbps=700)),
}


@functools.lru_cache(maxsize=None)
def _diamond_reference(case):
    """(frames, cfg, JAX GopEngine packets/stats, golden packets/stats):
    one JAX engine compile per configuration, shared by both emits."""
    make, kw = _DIAMOND_CASES[case]
    frames = _frames(make(np.random.default_rng(99)))
    cfg = EncoderConfig(**kw)
    return (frames, cfg, jgop.GopEngine(cfg).encode_gop(frames, 0),
            encode_gop(cfg, GoldenEngine(), frames, 0, 0))


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("case", ["mb", "bitrate"])
def test_diamond_rc_matches_jax_engine_and_golden(case, emit):
    frames, cfg, (jpk, jst), (gpk, gst) = _diamond_reference(case)
    tpk, tst = GopEngine(cfg, device="cpu", emit=emit).encode_gop(frames, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in jpk]
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]
    qps = [p.base_qp for p in tpk]
    assert qps == [p.base_qp for p in jpk] == [s.base_qp for s in tst]
    assert [s.bits for s in tst] == [s.bits for s in jst] == [s.bits for s in gst]
    assert len(set(qps)) > 1                      # the carry moved qp
    if case == "bitrate":
        assert any(b < a for a, b in zip(qps, qps[1:]))   # down as well as up


def test_rc_mb_offsets_fire():
    """Same clip and rate under rc=mb and rc=bitrate: the frame carry is
    the same rule, so any payload difference is the per-MB offsets."""
    frames, cfg, _, _ = _diamond_reference("mb")
    mb, _ = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
    br, _ = GopEngine(dataclasses.replace(cfg, rc="bitrate"),
                      device="cpu").encode_gop(frames, 0)
    assert mb[0].payload != br[0].payload


def test_chunk_emit_overflow_rerun_matches_golden(rng):
    """Noise at qp 28 overflows the budgeted span width (64 pieces of 16
    words at 4 words per piece) under chunk emit, diamond search and
    rc=mb: the GOP is encoded again at worst-case capacity, with golden's
    bytes and per-frame qps."""
    h, w = 128, 128
    clip = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(3)]
    frames = _frames(clip)
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=28,
                        search="diamond", rc="mb", target_kbps=200)
    eng = GopEngine(cfg, device="cpu", emit="chunks")
    handle = eng.start([frames], [0])
    assert bool(handle.outs["ovf"].any())             # a budget overflowed
    tpk, tst = eng.finish(handle)[0]
    gpk, gst = encode_gop(cfg, GoldenEngine(), frames, 0, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]
    assert [s.base_qp for s in tst] == [s.base_qp for s in gst]


# (fmt, search, rc, cqpo, qmat, islice, emit)
_FORMAT_CASES = [
    (2, "full", "none", 0, False, 0, "frame"),
    (2, "full", "none", 4, False, 0, "chunks"),
    (3, "full", "none", 0, False, 0, "frame"),
    (3, "full", "none", -3, True, 0, "chunks"),
    (3, "full", "none", 0, False, 1, "frame"),
    (3, "diamond", "none", 2, True, 2, "chunks"),
    (4, "full", "none", 0, False, 0, "frame"),
    (4, "full", "none", 2, True, 0, "frame"),
    (4, "full", "none", 2, True, 0, "chunks"),
    (4, "diamond", "none", 0, False, 0, "frame"),
    (1, "full", "adaptive", 0, False, 0, "frame"),
    (4, "full", "adaptive", 3, True, 1, "chunks"),
    (1, "full", "vbv", 0, False, 0, "frame"),
    (2, "diamond", "vbv", 4, False, 0, "chunks"),
    (3, "full", "mb", 0, False, 0, "frame"),
    (3, "full", "mb", 2, True, 2, "chunks"),
    (4, "diamond", "bitrate", 0, False, 0, "frame"),
]


def _halfpel_clip(rng, w, h, n):
    """A texture made at twice the size and reduced by 2x2 means at an odd
    offset per frame: true half-pel motion, so the format-4 refine leaves
    the integer grid; chroma moves too."""
    big = rng.integers(0, 256, (2 * h + 32, 2 * w + 32)).astype(np.int64)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    cbig = rng.integers(96, 160, (h + 32, w + 32)).astype(np.int64)

    def down(a, oy, ox, hh, ww):
        o = a[oy:oy + 2 * hh, ox:ox + 2 * ww]
        return ((o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2]
                 + 2) // 4).astype(np.uint8)
    clip = []
    for t in range(n):
        y = down(big, 3 * t, 5 * t, h, w)
        y[(5 * t) % (h - 16):(5 * t) % (h - 16) + 16, 8:24] = 230
        clip.append((y, down(cbig, t, 2 * t, h // 2, w // 2),
                     down(cbig[::-1].copy(), 2 * t, t, h // 2, w // 2)))
    return clip


@pytest.mark.parametrize("fmt,search,rc,cqpo,qmat,islice,emit", _FORMAT_CASES)
def test_formats_match_jax_engine_and_golden(fmt, search, rc, cqpo, qmat,
                                             islice, emit):
    w, h, n = 96, 64, 4
    clip = _halfpel_clip(np.random.default_rng(fmt * 100 + cqpo + 50), w, h, n)
    rcfg = EncoderConfig(
        width=w, height=h, gop_n=n, base_qp=26, search=search, rc=rc,
        target_kbps=250 if rc in ("vbv", "mb", "bitrate") else 0,
        vbv_kbits=30 if rc == "vbv" and fmt == 2 else 0,
        format_version=fmt, chroma_qp_offset=cqpo, quant_matrix=qmat,
        intra_slice_mbrows=islice)
    gframes = _frames(clip)
    gpk, gst = encode_gop(rcfg, GoldenEngine(), gframes, 0, 0)
    jdispatch.force("jnp")
    try:
        jpk, jst = jgop.GopEngine(rcfg).encode_gop(gframes, 0)
    finally:
        jdispatch.force(None)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    assert cfg.config_hash() == rcfg.config_hash()
    frames = [Frame.from_planes(*p) for p in clip]
    tpk, tst = GopEngine(cfg, device="cpu", emit=emit).encode_gop(frames, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in jpk]
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]
    assert [s.base_qp for s in tst] == [s.base_qp for s in gst]
    assert [s.n_inter_mb for s in tst] == [s.n_inter_mb for s in jst]
    assert tst[1].n_inter_mb > 0
    if rc in ("vbv", "mb", "bitrate"):
        assert len({s.base_qp for s in tst}) > 1          # the carry moved qp
    for t, g in zip(tst, gst):
        assert abs(t.psnr_y - g.psnr_y) < 1e-9
        assert abs(t.psnr_cb - g.psnr_cb) < 1e-9


def test_format4_picks_half_pel_vectors():
    """On the half-pel clip format 4 spends fewer bits than format 3 (same
    I frame, better P prediction), and its stream differs from format
    3's: the refine left the integer grid."""
    clip = _halfpel_clip(np.random.default_rng(5), 96, 64, 3)
    frames = [Frame.from_planes(*p) for p in clip]
    bits = {}
    for fmt in (3, 4):
        cfg = config_from_dict(dict(width=96, height=64, gop_n=3,
                                    format_version=fmt))
        _, st = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
        bits[fmt] = [s.bits for s in st]
    assert bits[3][0] == bits[4][0]
    assert sum(bits[4][1:]) < sum(bits[3][1:])


@pytest.mark.parametrize("emit,w,h,qp", [("frame", 48, 32, 1),
                                         ("chunks", 128, 128, 28)])
def test_format2_overflow_rerun_matches_golden(rng, emit, w, h, qp):
    """Noise overflows the budgets under the format-2 syntax (the frame
    capacity at qp 1; the budgeted span width at qp 28 under chunk emit):
    the GOP is encoded again at worst-case capacity (BLOCK_WORDS_MAX,
    max_words), with golden's bytes."""
    clip = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(3)]
    rcfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=qp,
                         format_version=2, chroma_qp_offset=-1)
    eng = GopEngine(config_from_dict(dataclasses.asdict(rcfg)), device="cpu",
                    emit=emit)
    handle = eng.start([[Frame.from_planes(*p) for p in clip]], [0])
    assert bool(handle.outs["ovf"].any())             # the budget overflowed
    tpk, _ = eng.finish(handle)[0]
    gpk, _ = encode_gop(rcfg, GoldenEngine(), _frames(clip), 0, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]


def test_vbv_fullness_stays_on_the_device(rng):
    """The vbv carry is device state: run() returns without the qps of
    later frames ever reaching the host, and they match golden's."""
    clip = make_clip(rng, 64, 48, 5)
    rcfg = EncoderConfig(width=64, height=48, gop_n=5, rc="vbv",
                         target_kbps=120, vbv_kbits=8)
    tpk, _ = GopEngine(config_from_dict(dataclasses.asdict(rcfg)),
                       device="cpu").encode_gop(
        [Frame.from_planes(*p) for p in clip], 0)
    gpk, _ = encode_gop(rcfg, GoldenEngine(), _frames(clip), 0, 0)
    assert [p.to_bytes() for p in tpk] == [p.to_bytes() for p in gpk]
    assert len({p.base_qp for p in tpk}) > 2
