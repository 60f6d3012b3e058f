"""The port's golden model (`codec/golden.py`, `codec/bitio.py`) against
the reference's, tolerance 0 (the codec is integer-only): `encode_frame`'s
payload, bits, recon and per-MB stats, and `decode_frame` of those
payloads, over formats 1-4 x search full/diamond/hier x rc
none/adaptive/vbv/mb at 64x48, 96x64 and the odd 80x48 grid (an I frame
and two P frames each); the bit layer on random codes; and the golden
engines in the clip loops, against the reference's loop, the port's GOP
engine and the C++ decoder."""

import dataclasses
import io
import itertools

import numpy as np
import pytest

from conftest import make_clip
from video_encoder_tpu.codec import bitio as jbitio
from video_encoder_tpu.codec import config as jconfig
from video_encoder_tpu.codec import golden as jgolden
from video_encoder_tpu.pipeline import encoder as jencoder
from video_encoder_tpu_torch.codec import bitio, golden
from video_encoder_tpu_torch.codec.bitstream import OrderedMux
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline import decoder, encoder
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

SIZES = ((64, 48), (96, 64), (80, 48))   # 80x48: a 5 x 3 MB grid
GRID = list(itertools.product((1, 2, 3, 4), ("full", "diamond", "hier"),
                              ("none", "adaptive", "vbv", "mb")))
QPS = (26, 31, 23)   # the I frame's, then each P frame's base qp


def _ref_cfg(fmt, search, rc, w, h, **kw):
    """The reference's config of one grid case: each format with its own
    flags (chroma qp offset from 2, quant matrix and intra slices from 3)."""
    return jconfig.EncoderConfig(
        width=w, height=h, gop_n=3, search=search, rc=rc,
        target_kbps=300 if rc in ("vbv", "mb") else 0,
        format_version=fmt, chroma_qp_offset=3 if fmt >= 2 else 0,
        quant_matrix=fmt >= 3, intra_slice_mbrows=1 if fmt >= 3 else 0,
        quant_bias=5 if search == "diamond" else 8, **kw)


def _planes(f):
    return f.y, f.cb, f.cr


def _same_frame(a, b):
    for p, q in zip(_planes(a), _planes(b)):
        assert p.dtype == q.dtype and np.array_equal(p, q)


@pytest.mark.parametrize("i", range(len(GRID)),
                         ids=["-".join(map(str, c)) for c in GRID])
def test_encode_and_decode_frames_equal_the_reference(i):
    fmt, search, rc = GRID[i]
    w, h = SIZES[i % len(SIZES)]
    clip = make_clip(np.random.default_rng(100 + i), w, h, 3)
    want_cfg = _ref_cfg(fmt, search, rc, w, h)
    cfg = config_from_dict(dataclasses.asdict(want_cfg))
    ref = want_ref = None
    dec_ref = None
    for k, planes in enumerate(clip):
        ftype = int(k > 0)
        got = golden.encode_frame(cfg, Frame.from_planes(*planes), ref,
                                  ftype, QPS[k])
        want = jgolden.encode_frame(want_cfg, jgolden.Frame.from_planes(*planes),
                                    want_ref, ftype, QPS[k])
        assert isinstance(got.recon, Frame)
        assert got.payload == want.payload
        assert got.payload_bits == want.payload_bits > 0
        _same_frame(got.recon, want.recon)
        assert got.mb_bits.dtype == want.mb_bits.dtype
        assert np.array_equal(got.mb_bits, want.mb_bits)
        assert got.mb_bits.sum() == got.payload_bits
        assert (got.n_intra, got.n_inter) == (want.n_intra, want.n_inter)
        args = (w, h, ftype, QPS[k], got.payload, got.payload_bits)
        fmt_args = (fmt, cfg.chroma_qp_offset, cfg.quant_matrix,
                    cfg.intra_slice_mbrows)
        dec = golden.decode_frame(*args, dec_ref, *fmt_args)
        _same_frame(dec, jgolden.decode_frame(
            *args, None if dec_ref is None else jgolden.Frame(*_planes(dec_ref)),
            *fmt_args))
        _same_frame(dec, got.recon)
        ref, want_ref, dec_ref = got.recon, want.recon, dec


def test_bit_writer_and_reader_equal_the_reference():
    rng = np.random.default_rng(7)
    kinds = rng.integers(0, 3, 3000)
    ue = rng.integers(0, 1 << rng.integers(1, 16, 3000))
    se = rng.integers(-(1 << 14), 1 << 14, 3000)
    lengths = rng.integers(0, 33, 3000)
    raw = [int(rng.integers(0, 1 << int(n))) if n else 0 for n in lengths]
    writers = (bitio.BitWriter(), jbitio.BitWriter())
    for bw in writers:
        for j, kind in enumerate(kinds):
            if kind == 0:
                bw.put_ue(int(ue[j]))
            elif kind == 1:
                bw.put_se(int(se[j]))
            else:
                bw.put(raw[j], int(lengths[j]))
    got, want = writers
    assert got.nbits == want.nbits > 32 * 100
    assert np.array_equal(got.words(), want.words())
    assert got.tobytes() == want.tobytes()
    payload = got.tobytes()
    readers = (bitio.BitReader(payload, got.nbits),
               jbitio.BitReader(payload, got.nbits))
    seqs = []
    for br in readers:
        seq = []
        for j, kind in enumerate(kinds):
            seq.append(br.get_ue() if kind == 0 else br.get_se() if kind == 1
                       else br.get(int(lengths[j])))
        assert br.pos == got.nbits
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[0] == [int(ue[j]) if k == 0 else int(se[j]) if k == 1
                       else raw[j] for j, k in enumerate(kinds)]
    with pytest.raises(AssertionError, match="overrun"):
        readers[0].get(1)


@pytest.mark.parametrize("kw", [
    dict(search="full"),
    dict(search="hier", rc="mb", target_kbps=300),
    dict(search="diamond", format_version=2, chroma_qp_offset=-4, rc="vbv",
         target_kbps=200, vbv_kbits=30),
    dict(format_version=4, quant_matrix=True, intra_slice_mbrows=2,
         rc="bitrate", target_kbps=300),
], ids=["full", "hier-mb", "v2-diamond-vbv", "v4-qmat-islice-bitrate"])
def test_golden_engine_clip_equals_the_reference(kw):
    """encode_clip through GoldenEngine: the reference's encode_clip (whose
    default engine is its golden model), a short last GOP included."""
    clip = make_clip(np.random.default_rng(21), 64, 48, 7)
    want_cfg = jconfig.EncoderConfig(width=64, height=48, gop_n=3,
                                     base_qp=27, **kw)
    want = io.BytesIO()
    jencoder.encode_clip(want_cfg, clip, want, 7)
    got = io.BytesIO()
    summary = encoder.encode_clip(
        config_from_dict(dataclasses.asdict(want_cfg)), clip, got, 7,
        engine=encoder.GoldenEngine())
    assert got.getvalue() == want.getvalue()
    assert summary.frames == 7


@pytest.mark.parametrize("fmt", [1, 4])
@pytest.mark.parametrize("search,rc", [("full", "none"), ("diamond", "mb")])
def test_golden_stream_equals_the_gop_engine(fmt, search, rc):
    """The port's golden model and its GOP engine (plain versions on the
    CPU) write the same packets."""
    clip = make_clip(np.random.default_rng(5), 64, 48, 4)
    cfg = _ref_cfg(fmt, search, rc, 64, 48)
    cfg = config_from_dict(dict(dataclasses.asdict(cfg), gop_n=4,
                                chroma_qp_offset=0, quant_matrix=False,
                                intra_slice_mbrows=0))
    frames = [Frame.from_planes(*p) for p in clip]
    want, _ = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
    got, stats = encoder.GoldenGopAdapter(cfg).encode_gop(frames, 0)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]
    assert [s.index for s in stats] == [0, 1, 2, 3]


@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_golden_decode_engine_equals_the_native_decode(fmt):
    clip = make_clip(np.random.default_rng(9), 80, 48, 7)
    cfg = config_from_dict(dataclasses.asdict(_ref_cfg(fmt, "full", "none",
                                                       80, 48)))
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, 7)
    for first in (0, 3, 6):
        packets, _ = encoder.GoldenGopAdapter(cfg).encode_gop(
            [Frame.from_planes(*p) for p in clip[first:first + 3]], first)
        for p in packets:
            mux.push(p)
    mux.close()
    streams = []
    for run in (lambda f: decoder.decode_clip(f, decoder.GoldenDecodeEngine()),
                decoder.decode_clip_native):
        info, frames = run(io.BytesIO(buf.getvalue()))
        streams.append(b"".join(p.tobytes() for f in frames for p in f))
    assert info.version == fmt
    assert streams[0] == streams[1]
    assert len(streams[0]) == 7 * 80 * 48 * 3 // 2
