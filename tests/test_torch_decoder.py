"""The port's decoders (`video_encoder_tpu_torch/pipeline/decoder.py`) on
the CPU, exact equality (the codec is integer-only):

- `decode_clip_gop` and `decode_clip` on device "cpu" (every kernel
  wrapper on its plain version) against the reference's
  `decode_clip_gop` (jnp on the CPU) and the C++ decode, frame for frame,
  over formats 1-4 with intra slices, the quant matrix, a chroma qp offset
  and an odd MB grid, on streams of the reference's `encode_clip`;
- the plain `intra_rows_recon_plane` and `recon_plane` against the
  reference's jnp functions and `codec/spec.py`, also at the int16
  extremes;
- `decode_clip_parallel` against `decode_clip_native` at 0-3 workers, and
  that it streams: at most N + 1 GOPs read and not yet yielded, the first
  frame yielded before the last GOP is read; `decode_clip_native` decodes
  GOP by GOP;
- the device decoders without CUDA raise unless asked for the CPU.
"""

import io
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clip
from video_encoder_tpu.codec import spec as jspec
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.ops import transform as jtx
from video_encoder_tpu.pipeline import decoder as jdec
from video_encoder_tpu.pipeline.encoder import encode_clip
from video_encoder_tpu_torch.codec import native
from video_encoder_tpu_torch.ops import transform as tx
from video_encoder_tpu_torch.pipeline import decoder

torch.set_num_threads(1)


def _stream(rng, w, h, n, gop_n, **kw):
    cfg = EncoderConfig(width=w, height=h, gop_n=gop_n, base_qp=24, **kw)
    buf = io.BytesIO()
    encode_clip(cfg, make_clip(rng, w, h, n), buf, n)
    return buf.getvalue()


def _frames(run, data):
    _, frames = run(io.BytesIO(data))
    return [tuple(np.asarray(p) for p in f) for f in frames]


def _same(got, want):
    return len(got) == len(want) and all(
        all(a.dtype == np.uint8 and np.array_equal(a, b) for a, b in zip(x, y))
        for x, y in zip(got, want))


_CASES = {
    "f1": (80, 48, 7, 3, dict()),                         # 5 x 3 MBs: odd grid
    "f2-cqpo": (64, 48, 6, 3, dict(format_version=2, chroma_qp_offset=3)),
    "f3-qmat-islice": (96, 80, 5, 4, dict(format_version=3, quant_matrix=True,
                                          intra_slice_mbrows=2)),
    "f3-cqpo": (64, 48, 6, 6, dict(format_version=3, chroma_qp_offset=-4)),
    "f4-qmat-cqpo": (80, 48, 8, 4, dict(format_version=4, quant_matrix=True,
                                        chroma_qp_offset=2)),
    "f4-islice": (64, 64, 6, 3, dict(format_version=4, intra_slice_mbrows=1,
                                     search="diamond")),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_device_decoders_equal_reference_and_native(rng, case):
    w, h, n, gop_n, kw = _CASES[case]
    data = _stream(rng, w, h, n, gop_n, **kw)
    want = _frames(jdec.decode_clip_gop, data)
    assert len(want) == n
    assert _same(_frames(jdec.decode_clip_native, data), want)
    assert _same(_frames(lambda f: decoder.decode_clip_gop(
        f, decoder.GopDecodeEngine(device="cpu")), data), want)
    assert _same(_frames(lambda f: decoder.decode_clip(
        f, decoder.DeviceDecodeEngine(device="cpu")), data), want)
    assert _same(_frames(decoder.decode_clip_native, data), want)
    # one GOP through decode_gop: the reference engine's padded frames
    from video_encoder_tpu_torch.codec import bitstream

    info, packets = bitstream.demux(io.BytesIO(data))
    gop = [next(packets) for _ in range(min(gop_n, n))]
    eng = decoder.GopDecodeEngine(info.version, info.chroma_qp_offset,
                                  info.quant_matrix, info.intra_slice_mbrows,
                                  device="cpu")
    ref_eng = jdec.GopDecodeEngine(info.version, info.chroma_qp_offset,
                                   info.quant_matrix, info.intra_slice_mbrows)
    for a, b in zip(eng.decode_gop(w, h, gop), ref_eng.decode_gop(w, h, gop)):
        for pa, pb in zip((a.y, a.cb, a.cr), (b.y, b.cb, b.cr)):
            assert pa.dtype == pb.dtype == np.int32 and np.array_equal(pa, pb)


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("reset_rows", [0, 2])
def test_intra_rows_recon_plane_equals_reference(rng, reset_rows, qmat):
    nby, nbx = 7, 10
    lv = np.where(rng.random((nby, nbx, 64)) < 0.7, 0,
                  rng.integers(-50, 51, (nby, nbx, 64))).astype(np.int16)
    q = rng.choice(jspec.QSTEP, (nby, nbx)).astype(np.int32)
    got = tx.intra_rows_recon_plane(torch.from_numpy(lv), torch.from_numpy(q),
                                    reset_rows, qmat).numpy()
    want = np.asarray(jtx.intra_rows_recon_plane(
        jtx.unzigzag(jnp.asarray(lv, jnp.int32)),
        jtx.qsteps_pos(jnp.asarray(q), qmat), reset_rows))
    raster = lv.astype(np.int64)[..., jspec.UNZIGZAG].reshape(nby, nbx, 8, 8)
    golden = jspec.intra_rows_recon_plane(raster, jspec.qsteps_pos(q, qmat),
                                          reset_rows)
    assert got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, golden)
    # B planes in lockstep: each its own plane's recon
    both = tx.intra_rows_recon_plane(torch.from_numpy(np.stack([lv, -lv])),
                                     torch.from_numpy(np.stack([q, q])),
                                     reset_rows, qmat)
    assert torch.equal(both[0], torch.from_numpy(got))
    assert torch.equal(both[1], tx.intra_rows_recon_plane(
        torch.from_numpy(-lv), torch.from_numpy(q), reset_rows, qmat))


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "int16-extremes", "flat-128"])
def test_recon_plane_equals_reference(rng, kind, qmat):
    """The reference decoders' recon_plane composition; at the int16
    extremes with the largest step its int32 sums wrap, and so must the
    port's."""
    nby, nbx = 6, 9
    if kind == "int16-extremes":
        lv = rng.choice([-32768, -32767, 32767, 0], (nby, nbx, 64))
        q = np.full((nby, nbx), jspec.QSTEP[63], np.int32)
    else:
        lv = np.where(rng.random((nby, nbx, 64)) < 0.7, 0,
                      rng.integers(-50, 51, (nby, nbx, 64)))
        q = rng.choice(jspec.QSTEP, (nby, nbx)).astype(np.int32)
    lv = lv.astype(np.int16)
    pred = (np.full((8 * nby, 8 * nbx), 128, np.int32) if kind == "flat-128"
            else rng.integers(0, 256, (8 * nby, 8 * nbx)).astype(np.int32))
    got = tx.recon_plane(torch.from_numpy(lv),
                         None if kind == "flat-128" else torch.from_numpy(pred),
                         torch.from_numpy(q), qmat).numpy()
    deq = jtx.dequantize(jtx.unzigzag(jnp.asarray(lv).astype(jnp.int32)),
                         jtx.qsteps_pos(jnp.asarray(q), qmat))
    want = np.clip(np.asarray(jtx.unblockify(jtx.inverse_transform(deq)))
                   + pred, 0, 255)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.fixture(scope="module")
def gop_stream():
    """Ten GOPs of 2 frames and a short one: 21 frames at 64x48."""
    return _stream(np.random.default_rng(77), 64, 48, 21, 2)


@pytest.mark.parametrize("workers", [0, 1, 2, 3])
def test_parallel_equals_native(gop_stream, workers):
    want = _frames(decoder.decode_clip_native, gop_stream)
    assert len(want) == 21
    assert _same(_frames(lambda f: decoder.decode_clip_parallel(f, workers),
                         gop_stream), want)
    assert _same(_frames(jdec.decode_clip_native, gop_stream), want)


class _Reads(io.BytesIO):
    """A stream that records how far it has been read."""

    def read(self, n=-1):
        out = super().read(n)
        self.high = max(getattr(self, "high", 0), self.tell())
        return out


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_parallel_decode_streams(gop_stream, monkeypatch, workers):
    """A counting stand-in for native.decode_stream: when a frame of GOP g
    is yielded at most g + N + 1 GOPs have been handed to the decoder, at
    most N run at once, and the first frame comes before the last GOP is
    read."""
    real = native.decode_stream
    lock = threading.Lock()
    seen = dict(calls=0, active=0, most=0)

    def counting(data, width, height, nframes):
        with lock:
            seen["calls"] += 1
            seen["active"] += 1
            seen["most"] = max(seen["most"], seen["active"])
        try:
            return real(data, width, height, nframes)
        finally:
            with lock:
                seen["active"] -= 1

    monkeypatch.setattr(native, "decode_stream", counting)
    f = _Reads(gop_stream)
    _, frames = decoder.decode_clip_parallel(f, workers)
    first_read = None
    for i, _frame in enumerate(frames):
        if first_read is None:
            first_read = f.high
        assert seen["calls"] <= i // 2 + workers + 1, (i, seen)
    assert i == 20 and seen["calls"] == 11
    assert seen["most"] <= workers
    assert first_read < len(gop_stream)


def test_native_decode_goes_gop_by_gop(gop_stream, monkeypatch):
    calls = []
    real = native.decode_stream

    def counting(data, width, height, nframes):
        calls.append(nframes)
        return real(data, width, height, nframes)

    monkeypatch.setattr(native, "decode_stream", counting)
    f = _Reads(gop_stream)
    _, frames = decoder.decode_clip_native(f)
    next(frames)
    assert calls == [2] and f.high < len(gop_stream)
    assert len(list(frames)) == 20 and calls == [2] * 10 + [1]


def test_device_decoders_without_cuda_raise(gop_stream, monkeypatch):
    """The default device is cuda: without CUDA the device decoders fail
    and decode nothing on the CPU unless the caller passes "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (decoder.GopDecodeEngine, decoder.DeviceDecodeEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for run in (decoder.decode_clip_gop, decoder.decode_clip):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _frames(run, gop_stream)
    assert len(_frames(lambda f: decoder.decode_clip(
        f, decoder.DeviceDecodeEngine(device="cpu")), gop_stream)) == 21


def test_parallel_decode_rejects_negative_workers(gop_stream):
    with pytest.raises(ValueError, match="workers"):
        decoder.decode_clip_parallel(io.BytesIO(gop_stream), -1)
