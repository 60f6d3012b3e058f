"""The port's decoders on corrupt streams, counterpart of
tests/test_fuzz_decode.py: on the bit-flip, truncation and garbage
corpora every port decoder (native, GOP-parallel, and the gop and
device engines on "cpu") raises ValueError or returns frames; it never
crashes or hangs. Formats 1 and 4 (half-pel motion, the quant matrix,
intra slices: the row recon and the parity planes)."""

import io

import numpy as np
import pytest
import torch

from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.pipeline import encoder
from video_encoder_tpu_torch.pipeline import decoder

torch.set_num_threads(1)

_FORMATS = {1: dict(), 4: dict(format_version=4, quant_matrix=True,
                               chroma_qp_offset=2, intra_slice_mbrows=1)}


def _make_stream(rng, fmt, w=64, h=48, n=4):
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    raw = []
    for t in range(n):
        y = base[t:t + h, 2 * t:2 * t + w].astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        cr = np.full((h // 2, w // 2), 130, np.uint8)
        raw.append((y, cb, cr))
    cfg = EncoderConfig(width=w, height=h, gop_n=2, base_qp=18, search="full",
                        **_FORMATS[fmt])
    out = io.BytesIO()
    encoder.encode_clip(cfg, iter(raw), out, n)
    return out.getvalue()


_DECODERS = {
    "native": decoder.decode_clip_native,
    "parallel": lambda f: decoder.decode_clip_parallel(f, 2),
    "gop": lambda f: decoder.decode_clip_gop(
        f, decoder.GopDecodeEngine(device="cpu")),
    "device": lambda f: decoder.decode_clip(
        f, decoder.DeviceDecodeEngine(device="cpu")),
}


def _try_decode_all(data):
    """Every port decoder on possibly corrupt data: (name, outcome); any
    exception other than ValueError fails the test."""
    outcomes = []
    for name, run in _DECODERS.items():
        try:
            _, frames = run(io.BytesIO(data))
            outcomes.append((name, "ok", len(list(frames))))
        except ValueError as e:
            outcomes.append((name, "rejected", str(e)[:60]))
    return outcomes


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_fuzz_bitflips(rng, fmt):
    data = bytearray(_make_stream(rng, fmt))
    hdr = 64  # keep the stream header mostly intact so frames are attempted
    for _ in range(24):
        buf = bytearray(data)
        for _ in range(rng.integers(1, 6)):
            pos = int(rng.integers(hdr, len(buf)))
            buf[pos] ^= 1 << int(rng.integers(0, 8))
        _try_decode_all(bytes(buf))


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_fuzz_truncation(rng, fmt):
    data = _make_stream(rng, fmt)
    for frac in (0.1, 0.35, 0.6, 0.9, 0.99):
        outs = _try_decode_all(data[:int(len(data) * frac)])
        assert all(o[1] == "rejected" for o in outs), outs


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_fuzz_garbage_payload(rng, fmt):
    data = _make_stream(rng, fmt)
    buf = data[:80] + bytes(rng.integers(0, 256, len(data) - 80,
                                         dtype=np.uint8))
    _try_decode_all(buf)


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_valid_stream_still_decodes(rng, fmt):
    outs = _try_decode_all(_make_stream(rng, fmt))
    assert outs == [(name, "ok", 4) for name in _DECODERS]
