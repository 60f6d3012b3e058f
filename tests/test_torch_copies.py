"""The port's own copies of the reference's host modules against their
originals: the tables, constants and integer programs of `spec`, the
config's canonical string and hash, stream and frame headers, the frame
model, raw YUV I/O and the metrics. A copy is a copy: same behaviour."""

import dataclasses
import inspect
import io
import itertools

import numpy as np
import pytest

from video_encoder_tpu.codec import bitstream as jbits
from video_encoder_tpu.codec import config as jconfig
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec import native as jnative
from video_encoder_tpu.codec import spec as jspec
from video_encoder_tpu.io import yuv as jyuv
from video_encoder_tpu.utils import metrics as jmetrics
from video_encoder_tpu_torch.codec import bitstream, config, frame, native, spec
from video_encoder_tpu_torch.io import yuv
from video_encoder_tpu_torch.utils import metrics


def _public(mod):
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


def test_spec_tables_and_constants_equal():
    ours, theirs = _public(spec), _public(jspec)
    assert sorted(ours) == sorted(theirs)
    n_tables = n_consts = 0
    for name, want in theirs.items():
        got = ours[name]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
            n_tables += 1
        elif isinstance(want, (int, float, str, tuple)):
            assert got == want, name
            n_consts += 1
    assert n_tables >= 5 and n_consts >= 8
    for name in ("B_MATRIX", "QSTEP", "ZIGZAG", "UNZIGZAG", "QMAT"):
        assert isinstance(theirs[name], np.ndarray)


def test_spec_functions_equal(rng):
    for vbv in (0, 30000, 240000):
        assert spec.vbv_init(vbv) == jspec.vbv_init(vbv)
    qp, full = 30, 15000
    for bits in rng.integers(0, 90000, 50):
        got = spec.vbv_next(qp, full, int(bits), 20000, 30000)
        assert got == jspec.vbv_next(qp, full, int(bits), 20000, 30000)
        qp, full = got
    est = rng.integers(0, 3000, (5, 11))
    assert np.array_equal(spec.mb_rc_offsets(est), jspec.mb_rc_offsets(est))
    q = rng.choice(jspec.QSTEP, (4, 6))
    for use in (False, True):
        assert np.array_equal(spec.qsteps_pos(q, use), jspec.qsteps_pos(q, use))
    plane = rng.integers(0, 256, (30, 44))
    assert np.array_equal(spec.pad_plane(plane, 16), jspec.pad_plane(plane, 16))
    x = rng.integers(-255, 256, (3, 8, 8))
    assert np.array_equal(spec.forward_transform(x), jspec.forward_transform(x))


_GRID = [dict(zip(("format_version", "rc", "search", "quant_bias"), v))
         for v in itertools.product((1, 2, 3, 4), ("none", "adaptive", "vbv", "mb"),
                                    ("full", "diamond"), (8, 5))]


def test_config_canonical_and_hash_equal_over_a_grid():
    seen = set()
    for kw in _GRID:
        fmt = kw["format_version"]
        kw = dict(kw, width=96, height=64, gop_n=7, base_qp=31,
                  target_kbps=900 if kw["rc"] in ("vbv", "mb") else 0,
                  vbv_kbits=50 if kw["rc"] == "vbv" else 0,
                  chroma_qp_offset=3 if fmt >= 2 else 0,
                  quant_matrix=fmt >= 3, intra_slice_mbrows=2 if fmt >= 3 else 0,
                  fps_num=30000, fps_den=1001)
        want = jconfig.EncoderConfig(**kw)
        got = config.EncoderConfig(**kw)
        assert got.canonical() == want.canonical()
        assert got.config_hash() == want.config_hash()
        assert got.target_bits_per_frame() == want.target_bits_per_frame()
        assert got.vbv_bits() == want.vbv_bits()
        assert (got.intra_only, got.search_mode_id) == (want.intra_only,
                                                       want.search_mode_id)
        carried = config.config_from_dict(dataclasses.asdict(want))
        assert carried == got and isinstance(carried, config.EncoderConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        seen.add(got.config_hash())
    assert len(seen) == len(_GRID)


@pytest.mark.parametrize("kw,msg", [
    (dict(width=33, height=32), "even"),
    (dict(width=32, height=32, base_qp=64), "base_qp"),
    (dict(width=32, height=32, rc="vbv"), "requires target_kbps"),
    (dict(width=32, height=32, chroma_qp_offset=1), "format_version>=2"),
    (dict(width=32, height=32, format_version=2, quant_matrix=True), "quant_matrix"),
    (dict(width=32, height=32, quant_bias=0), "quant_bias"),
    (dict(width=32, height=32, format_version=5), "unknown format"),
])
def test_config_errors_equal(kw, msg):
    for cls in (config.EncoderConfig, jconfig.EncoderConfig):
        with pytest.raises(ValueError, match=msg):
            cls(**kw)
    with pytest.raises(TypeError):
        config.config_from_dict(dict(width=32, height=32, no_such_field=1))


@pytest.mark.parametrize("kw", [
    dict(), dict(gop_n=1), dict(format_version=2, chroma_qp_offset=-5),
    dict(format_version=3, quant_matrix=True, intra_slice_mbrows=3),
    dict(format_version=4, chroma_qp_offset=12, search="diamond"),
])
def test_stream_headers_and_packets_byte_equal(rng, kw):
    want_cfg = jconfig.EncoderConfig(width=64, height=48, **kw)
    cfg = config.config_from_dict(dataclasses.asdict(want_cfg))
    a, b = io.BytesIO(), io.BytesIO()
    jbits.write_stream_header(a, want_cfg, 9)
    bitstream.write_stream_header(b, cfg, 9)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    b.seek(0)
    assert dataclasses.asdict(bitstream.read_stream_header(b)) == \
        dataclasses.asdict(jbits.read_stream_header(a))

    payloads = [rng.integers(0, 256, 4 * n, dtype=np.uint8).tobytes()
                for n in (3, 1, 7)]
    a, b = io.BytesIO(), io.BytesIO()
    ma, mb = jbits.OrderedMux(a, want_cfg, 3), bitstream.OrderedMux(b, cfg, 3)
    for i in (1, 0, 2):                           # out of order
        args = (i, int(i > 0), 20 + i, 32 * len(payloads[i]) // 4 - 5, payloads[i])
        pa, pb = jbits.FramePacket(*args), bitstream.FramePacket(*args)
        assert pa.to_bytes() == pb.to_bytes()
        ma.push(pa)
        mb.push(pb)
    ma.close()
    mb.close()
    assert a.getvalue() == b.getvalue()
    b.seek(0)
    info, packets = bitstream.demux(b)
    assert [p.payload for p in packets] == payloads and info.frame_count == 3


def test_frame_model_equal(rng):
    y = rng.integers(0, 256, (30, 44), dtype=np.uint8)
    cb = rng.integers(0, 256, (15, 22), dtype=np.uint8)
    cr = rng.integers(0, 256, (15, 22), dtype=np.uint8)
    got, want = frame.Frame.from_planes(y, cb, cr), golden.Frame.from_planes(y, cb, cr)
    for a, b in zip((got.y, got.cb, got.cr), (want.y, want.cb, want.cr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert frame.mb_grid(got) == golden.mb_grid(want) == (2, 3)
    for a, b in zip(got.crop(44, 30), want.crop(44, 30)):
        assert np.array_equal(a, b)


def test_yuv_io_equal(rng, tmp_path):
    w, h = 44, 30
    planes = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
              for _ in range(3)]
    pa, pb = tmp_path / "a.yuv", tmp_path / "b.yuv"
    for mod, path in ((jyuv, pa), (yuv, pb)):
        with open(path, "wb") as f:
            for p in planes:
                mod.write_yuv_frame(f, *p)
    assert pa.read_bytes() == pb.read_bytes()
    assert yuv.count_yuv_frames(str(pb), w, h) == jyuv.count_yuv_frames(str(pa), w, h) == 3
    gw, gh, gfps, gframes = yuv.open_clip(str(pb), w, h)
    ww, wh, wfps, wframes = jyuv.open_clip(str(pa), w, h)
    assert (gw, gh, gfps) == (ww, wh, wfps)
    for g, w_ in zip(gframes, wframes):
        assert all(np.array_equal(a, b) for a, b in zip(g, w_))
    raw = planes[0][0].tobytes() + planes[0][1].tobytes() + planes[0][2].tobytes()
    for a, b in zip(yuv.split_i420(raw, w, h), jyuv.split_i420(raw, w, h)):
        assert np.array_equal(a, b)


def test_metrics_equal(rng):
    a = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-4, 5, a.shape), 0, 255).astype(np.uint8)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a)
    sa, sb = metrics.RunSummary(), jmetrics.RunSummary()
    for i in range(4):
        kw = dict(index=i, frame_type=int(i > 0), base_qp=28, bits=1000 + i,
                  psnr_y=30.5 + i, psnr_cb=40.0, psnr_cr=41.0, ms=2.0,
                  n_intra_mb=3, n_inter_mb=i)
        fa, fb = metrics.FrameStats(**kw), jmetrics.FrameStats(**kw)
        assert fa.to_json() == fb.to_json()
        sa.add(fa)
        sb.add(fb)
    assert sa.to_json() == sb.to_json() and sa.frames == 4


def test_native_decode_equals_reference_binding(rng):
    """The port's binding (its own build under build/oracle/) decodes a
    format-4 stream to the same frames as the reference's binding."""
    from conftest import make_clip
    from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_clip

    clip = make_clip(rng, 48, 32, 3)
    cfg = jconfig.EncoderConfig(width=48, height=32, gop_n=3, format_version=4,
                                quant_matrix=True)
    buf = io.BytesIO()
    encode_clip(cfg, clip, buf, 3, engine=GoldenEngine())
    got = native.decode_stream(buf.getvalue(), 48, 32, 3)
    assert native._LIB_PATH.endswith("/build/oracle/liboracle.so")
    if jnative.available():
        want = jnative.decode_stream(buf.getvalue(), 48, 32, 3)
        assert np.array_equal(got, want)
    assert got.shape[0] == 3
