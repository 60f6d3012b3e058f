"""The port's per-frame engine (`pipeline/device_engine.py`) and its pack
(`entropy.mb_symbols`, `pack_bits`, `mb_bit_counts`) against the
reference's, and the per-frame clip loops (`pipeline/encoder.py`
`encode_clip`, the per-frame branch of `encode_clip_twopass`) against the
reference's engine and the golden model, byte for byte (tolerance 0: the
codec is integer-only). Also pinned: the reference per-frame engine's
rc-mb defect, which the port refuses to copy."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clip
from video_encoder_tpu.codec import entropy as jent
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.bitstream import demux
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.pipeline import device_engine as jdev
from video_encoder_tpu.pipeline import encoder as jenc
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline import device_engine, encoder

torch.set_num_threads(1)

W, H = 64, 48


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(rng, nby, nbx, density):
    """Zigzag levels [nby, nbx, 6, 64]: sparse, with some large values and
    some all-zero blocks."""
    lv = rng.integers(-40, 41, (nby, nbx, 6, 64))
    lv[rng.random(lv.shape) > density] = 0
    lv[rng.random(lv.shape) < 0.002] = rng.choice([-2047, 1500, 2047])
    lv[:, :, 2][rng.random((nby, nbx)) < 0.5] = 0
    return lv.astype(np.int32)


def _headers(rng, nby, nbx):
    qpd = rng.integers(-6, 7, (nby, nbx)).astype(np.int32)
    inter = rng.random((nby, nbx)) < 0.6
    dy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    return qpd, inter, dy, dx


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("is_p", [False, True])
def test_mb_symbols_pack_bits_and_bit_counts_match_reference(seed, is_p):
    rng = np.random.default_rng(seed)
    nby, nbx = 3, 4
    lv = _levels(rng, nby, nbx, (0.05, 0.3, 0.9)[seed])
    qpd, inter, dy, dx = _headers(rng, nby, nbx)
    jv, jl = jent.mb_symbols(jnp.asarray(lv), jnp.asarray(qpd),
                             jnp.asarray(is_p), jnp.asarray(inter),
                             jnp.asarray(dy), jnp.asarray(dx))
    tv, tl = entropy.mb_symbols(_t(lv), _t(qpd), is_p, _t(inter), _t(dy),
                                _t(dx))
    assert tv.shape == tl.shape == (nby, nbx, entropy.HEADER_SLOTS + 6 * 130)
    assert np.array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    got_mb = entropy.mb_bit_counts(tl)
    assert got_mb.dtype == torch.int32
    assert np.array_equal(got_mb.numpy(), np.asarray(jent.mb_bit_counts(jl)))

    n_words = entropy.max_words(nby * nbx)
    jw, jb = jent.pack_bits(jv, jl, n_words)
    tw, tb = entropy.pack_bits(tv, tl, n_words)
    assert int(tb) == int(jb) and int(tb) % 32   # the last word partly filled
    assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    # the same arrays into too few words: both drop the words past the end
    short = int(jb) // 64
    jw, jb = jent.pack_bits(jv, jl, short)
    tw, tb = entropy.pack_bits(tv, tl, short)
    assert int(tb) == int(jb)
    assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw))


def test_assemble_then_scatter_is_the_identity(rng):
    yb = _t(rng.integers(-99, 99, (6, 8, 64)).astype(np.int32))
    cb = _t(rng.integers(-99, 99, (3, 4, 64)).astype(np.int32))
    cr = _t(rng.integers(-99, 99, (3, 4, 64)).astype(np.int32))
    blocks = device_engine.assemble_blocks(yb, cb, cr)
    want = jdev.assemble_blocks(jnp.asarray(yb.numpy()), jnp.asarray(cb.numpy()),
                                jnp.asarray(cr.numpy()))
    assert blocks.shape == (3, 4, 6, 64)
    assert np.array_equal(blocks.numpy(), np.asarray(want))
    for got, orig in zip(device_engine.scatter_blocks(blocks), (yb, cb, cr)):
        assert torch.equal(got, orig)
    # 8x8 trailing axes, as the reference lays them out
    b6 = _t(rng.integers(-9, 9, (2, 3, 6, 8, 8)).astype(np.int32))
    y, c1, c2 = device_engine.scatter_blocks(b6)
    assert torch.equal(device_engine.assemble_blocks(y, c1, c2), b6)
    for got, want in zip((y, c1, c2), jdev.scatter_blocks(jnp.asarray(b6.numpy()))):
        assert np.array_equal(got.numpy(), np.asarray(want))


_CASES = {
    "full-none": dict(),
    "full-bitrate": dict(rc="bitrate", target_kbps=150),
    "full-vbv": dict(rc="vbv", target_kbps=150, vbv_kbits=12),
    "diamond-adaptive": dict(search="diamond", rc="adaptive"),
    "gop1": dict(gop_n=1),
}


@pytest.fixture(scope="module")
def clip():
    return make_clip(np.random.default_rng(1234), W, H, 5)


def _packets(stream: bytes):
    return [(p.frame_type, p.base_qp, p.payload_bits, p.payload)
            for p in demux(io.BytesIO(stream))[1]]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_encode_clip_matches_reference_engine_and_golden(clip, case):
    jcfg = EncoderConfig(**dict(dict(width=W, height=H, gop_n=3, base_qp=27),
                                **_CASES[case]))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got, ref_dev, gold = io.BytesIO(), io.BytesIO(), io.BytesIO()
    summary = encoder.encode_clip(cfg, clip, got, 5,
                                  engine=device_engine.DeviceEngine("cpu"))
    jenc.encode_clip(jcfg, clip, ref_dev, 5, engine=jdev.DeviceEngine())
    want = jenc.encode_clip(jcfg, clip, gold, 5, engine=jenc.GoldenEngine())
    assert got.getvalue() == ref_dev.getvalue() == gold.getvalue()
    assert summary.frames == 5 and summary.total_bits == want.total_bits
    assert summary.sum_psnr_y == want.sum_psnr_y
    if jcfg.rc in ("bitrate", "vbv"):   # the carry moved the frame qp
        assert len({p[1] for p in _packets(got.getvalue())}) > 1


def test_vbv_case_is_not_the_bitrate_stream(clip):
    """The vbv case above exercises the buffer term, not only the
    proportional one it shares with rc bitrate."""
    streams = []
    for rc in ("bitrate", "vbv"):
        kw = dict(_CASES["full-vbv"], rc=rc)
        cfg = config_from_dict(dataclasses.asdict(
            EncoderConfig(width=W, height=H, gop_n=3, base_qp=27, **kw)))
        buf = io.BytesIO()
        encoder.encode_clip(cfg, clip, buf, 5,
                            engine=device_engine.DeviceEngine("cpu"))
        streams.append(_packets(buf.getvalue()))
    assert streams[0] != streams[1]


def test_per_frame_two_pass_matches_reference(clip):
    jcfg = EncoderConfig(width=W, height=H, gop_n=2, base_qp=26,
                         rc="bitrate", target_kbps=120)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got, want = io.BytesIO(), io.BytesIO()
    summary = encoder.encode_clip_twopass(
        cfg, lambda: iter(clip), got, 5,
        engine=device_engine.DeviceEngine("cpu"))
    jenc.encode_clip_twopass(jcfg, lambda: iter(clip), want, 5,
                             engine=jdev.DeviceEngine())
    assert got.getvalue() == want.getvalue()
    assert summary.frames == 5
    qps = [p[1] for p in _packets(got.getvalue())]
    assert qps[0] == qps[1] and qps[2] == qps[3] and len(set(qps)) > 1


def test_reference_rc_mb_defect_is_pinned_and_refused(clip):
    """The reference's per-frame engine ignores rc mb: its rc-mb packets
    are its rc-bitrate packets, not the golden model's rc-mb packets. The
    port's per-frame engine raises instead."""
    def packets(rc, engine):
        jcfg = EncoderConfig(width=W, height=H, gop_n=4, base_qp=27, rc=rc,
                             target_kbps=200)
        buf = io.BytesIO()
        jenc.encode_clip(jcfg, clip[:4], buf, 4, engine=engine)
        return _packets(buf.getvalue())

    ref_mb = packets("mb", jdev.DeviceEngine())
    assert ref_mb == packets("bitrate", jdev.DeviceEngine())
    assert ref_mb != packets("mb", jenc.GoldenEngine())
    cfg = config_from_dict(dataclasses.asdict(
        EncoderConfig(width=W, height=H, gop_n=4, rc="mb", target_kbps=200)))
    with pytest.raises(ValueError, match="rc='mb'"):
        encoder.encode_clip(cfg, clip, io.BytesIO(), 4,
                            engine=device_engine.DeviceEngine("cpu"))


def test_frame_results_match_reference_and_reuse_the_recon(clip):
    """One I and one P frame through the engine: payload (big-endian
    words, last word partly filled), bits, recon, mb_bits and MB counts
    equal the reference engine's; a P frame whose ref is a copy of the
    returned recon (uploaded anew) gives what the returned recon itself
    (kept on the device) gives."""
    jcfg = EncoderConfig(width=W, height=H, gop_n=2, base_qp=30,
                         search="diamond", rc="adaptive")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    frames = [Frame.from_planes(*p) for p in clip[:2]]
    eng, ref_eng = device_engine.DeviceEngine("cpu"), jdev.DeviceEngine()
    jframes = [golden.Frame.from_planes(*p) for p in clip[:2]]
    i_got = eng.encode(cfg, frames[0], None, 0, 30)
    i_want = ref_eng.encode(jcfg, jframes[0], None, 0, 30)
    p_got = eng.encode(cfg, frames[1], i_got.recon, 1, 30)
    p_want = ref_eng.encode(jcfg, jframes[1], i_want.recon, 1, 30)
    for got, want in ((i_got, i_want), (p_got, p_want)):
        assert got.payload == want.payload and got.payload_bits % 32
        assert got.payload_bits == want.payload_bits
        assert (got.n_intra, got.n_inter) == (want.n_intra, want.n_inter)
        assert got.mb_bits.dtype == np.int32
        assert np.array_equal(got.mb_bits, want.mb_bits)
        for a, b in zip((got.recon.y, got.recon.cb, got.recon.cr),
                        (want.recon.y, want.recon.cb, want.recon.cr)):
            assert a.dtype == np.int32 and np.array_equal(a, b)
    assert p_got.n_inter > 0
    copy = Frame(i_got.recon.y.copy(), i_got.recon.cb.copy(),
                 i_got.recon.cr.copy())
    again = device_engine.DeviceEngine("cpu").encode(cfg, frames[1], copy, 1,
                                                     30)
    assert again.payload == p_got.payload


@pytest.mark.parametrize("kw,msg", [
    (dict(format_version=2), "format 1 only"),
    (dict(search="hier"), "not a device-engine mode"),
])
def test_engine_refuses_what_it_does_not_code(clip, kw, msg):
    cfg = config_from_dict(dataclasses.asdict(
        EncoderConfig(width=W, height=H, **kw)))
    frame = Frame.from_planes(*clip[0])
    with pytest.raises(ValueError, match=msg):
        device_engine.DeviceEngine("cpu").encode(cfg, frame, None, 0, 28)


def test_cuda_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_engine.DeviceEngine()
