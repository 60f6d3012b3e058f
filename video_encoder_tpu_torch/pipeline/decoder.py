"""Clip decoders of the port: the counterpart of
`video_encoder_tpu/pipeline/decoder.py`, under the same names.

- `GopDecodeEngine` / `decode_clip_gop`: the C++ parser of a whole GOP on
  the host (threaded over its frames), then the GOP's frames rebuilt on
  the device with no host read between them and one download per GOP;
  GOP k + 1 is parsed and uploaded while GOP k runs.
- `DeviceDecodeEngine` / `decode_clip`: the same frame step, one frame per
  call (parse, upload, recon, download).
- `GoldenDecodeEngine`: the numpy golden model's `decode_frame` on the
  host, one frame per call through `decode_clip` (slow: the referee, and
  the fallback of `decode --engine native` where the C++ library cannot
  be loaded).
- `decode_clip_native`: the whole decode in C++, GOP by GOP;
  `decode_clip_parallel`: the same on worker threads, streaming, with at
  most N + 1 GOPs read and not yet yielded.

On CUDA both device decoders rebuild through one captured CUDA graph per
key (`gop_engine.GraphCache`, a cache per engine): `GopDecodeEngine.run`
per `DecodeKey`, the counterpart of the reference's jitted
`_decode_gop_jit`, and `DeviceDecodeEngine.decode` per `DecodeFrameKey`,
the counterpart of its jitted `DeviceDecodeEngine._recon`. A key's first
call runs eagerly (the warm-up), its second captures, every later one
copies the parsed tensors into the graph's static inputs, replays and
clones the decoded bytes out, so a GOP in flight keeps its own. A
one-GOP stream never replays; in a stream of GOPs of T frames and a
tail, the third full GOP is the first replay (the tail is a key of its
own). The per-frame decoder runs a stream's first P frame eagerly,
captures at its second and replays every later one; its I frames replay
from the third GOP on. A capture that fails raises; nothing falls back
to the eager loop. The parse, the uploads and the downloads stay on the
host, outside the graph.

Every decoder reads the stream through the lazy `bitstream.demux` and
yields cropped (y, cb, cr) uint8 planes in frame order. The device
decoders run on `device` ("cuda" by default) and raise without CUDA
unless the caller passes "cpu", where every kernel wrapper takes its
plain version.
"""

from __future__ import annotations

import collections
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Iterator

import numpy as np
import torch

from ..codec import bitstream, native, spec
from ..codec.frame import Frame
from ..codec.golden import decode_frame
from ..io import yuv
from ..ops import dispatch, motion
from .gop_engine import GraphCache, resolve_device

# what a captured GOP decode bakes in (GopDecodeEngine.key): the reference
# jit's static arguments but the chroma qp offset, which plane_qsteps
# applies on the host, the GOP's frame count and padded size, its I/P
# pattern and the route the wrappers read at every call
DecodeKey = collections.namedtuple(
    "DecodeKey", "fmt qmat islice t_frames hp wp is_p force")
# what a captured frame decode bakes in (DeviceDecodeEngine.key)
DecodeFrameKey = collections.namedtuple(
    "DecodeFrameKey", "is_p has_ref fmt qmat islice hp wp force")
# the parsed tensors a GOP's graph reads, in its input order
GOP_INPUTS = ("ly", "lcb", "lcr", "qy", "qc", "dy", "dx", "inter")


def plane_qsteps(qps: np.ndarray, fmt: int, cqpo: int):
    """Per-8x8-block quantizer steps on the host from per-MB qps [...,
    nby, nbx]: (luma [..., 2 nby, 2 nbx], chroma [..., nby, nbx]) int32,
    chroma at clip(qp + cqpo) from format 2 on (SPEC.md §12.2)."""
    qs = spec.QSTEP[qps]
    qy = qs.repeat(2, -2).repeat(2, -1)
    qc = qs
    if fmt >= 2 and cqpo:
        qc = spec.QSTEP[np.clip(qps + cqpo, spec.QP_MIN, spec.QP_MAX)]
    return qy.astype(np.int32), qc.astype(np.int32)


def recon_frame(levels, qsteps, mv, refs, is_p: bool, fmt: int,
                qmat: bool = False, islice: int = 0,
                outs=(None, None, None)):
    """One frame rebuilt on the device, the step both engines share.

    levels: (ly [H/8, W/8, 64], lcb, lcr [H/16, W/16, 64]) int16 zigzag
    levels; qsteps: (luma [H/8, W/8], cb, cr [H/16, W/16]) int32 steps;
    mv: (dy, dx, is_inter) [H/16, W/16] per MB (format 4: half-pels);
    refs: the previous frame's recon (y [H, W], cb, cr [H/2, W/2] int32),
    or None. A P frame predicts its three planes in one `mc_predict`
    launch (format 4 from the parity stacks, as the encoder builds them;
    intra MBs predict 128) and adds each plane's residual with
    `recon_plane`; an I frame adds it to a flat 128 or, from format 3 on,
    runs the vertical-intra row recon of each plane, resetting every
    islice MB rows. outs: uint8 planes (or None) that receive the recon
    as bytes. Returns the recon planes, int32: the next frame's refs."""
    if is_p:
        if refs is None:     # a stream whose first frame is P: zero refs
            h, w = levels[0].shape[0] * 8, levels[0].shape[1] * 8
            refs = tuple(torch.zeros(s, dtype=torch.int32,
                                     device=levels[0].device)
                         for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        if fmt >= 4:
            stacks = tuple(motion.hpel_stack(p) for p in refs)
        else:
            stacks = tuple(p.unsqueeze(-3) for p in refs)
        preds = dispatch.mc_predict(stacks, *mv)
    elif fmt >= 3:
        return tuple(
            dispatch.intra_rows_recon_plane(lv, q, reset, qmat, o)
            for lv, q, reset, o in zip(levels, qsteps,
                                       (2 * islice, islice, islice), outs))
    else:
        preds = (None, None, None)
    return tuple(dispatch.recon_plane(lv, p, q, qmat, o)
                 for lv, p, q, o in zip(levels, preds, qsteps, outs))


def _padded(width: int, height: int):
    return spec.ceil_to(height, spec.MB), spec.ceil_to(width, spec.MB)


def _frame_views(buf: torch.Tensor, hp: int, wp: int):
    """The (y, cb, cr) views of one padded I420 frame buffer [Hp*Wp*3/2]."""
    ny, nc = hp * wp, hp * wp // 4
    return (buf[:ny].view(hp, wp), buf[ny:ny + nc].view(hp // 2, wp // 2),
            buf[ny + nc:].view(hp // 2, wp // 2))


def _take_stream_fields(engine, info: bitstream.StreamInfo):
    engine.version = info.version
    engine.chroma_qp_offset = info.chroma_qp_offset
    engine.quant_matrix = info.quant_matrix
    engine.intra_slice = info.intra_slice_mbrows
    return engine


def _gops(packets) -> Iterator[list]:
    """The packets in GOPs (a GOP starts at each I frame), read lazily:
    GOP k is complete once GOP k + 1's first packet has been read."""
    gop: list = []
    for pkt in packets:
        if pkt.frame_type == 0 and gop:
            yield gop
            gop = []
        gop.append(pkt)
    if gop:
        yield gop


class GopDecodeEngine:
    """Whole-GOP decode on one device: the C++ parser of a GOP on the
    host (int16 per-plane layout), one upload, then every frame of the
    GOP rebuilt on the device (`recon_frame`) with no host read in
    between, the decoded bytes of all its frames in one buffer, and one
    download. `decode_gop_start` returns once the GOP's work is launched,
    so the next GOP's parse overlaps it; `decode_gop_finish` waits.

    On CUDA `run` replays one CUDA graph per `key` from a key's second
    call on (the module docstring); `graphs` holds them, in the engine's
    GraphCache `cache`: replays run on the current stream, which must stay
    the one of the first replay."""

    def __init__(self, version: int = 1, chroma_qp_offset: int = 0,
                 quant_matrix: bool = False, intra_slice: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        native._load()
        self.version = version
        self.chroma_qp_offset = chroma_qp_offset
        self.quant_matrix = quant_matrix
        self.intra_slice = intra_slice
        self.cache = GraphCache("GopDecodeEngine")
        self.graphs = self.cache.graphs     # DecodeKey -> its GopGraph

    def parse(self, width: int, height: int, packets) -> dict:
        """One GOP's packets parsed on the host: numpy arrays ly, lcb, lcr
        [T, ..., 64] int16, dy, dx, inter [T, nby, nbx], the steps qy, qc,
        and is_p, a list of T bools."""
        hp, wp = _padded(width, height)
        ly, lcb, lcr, dy, dx, inter, qps = native.parse_gop_planes(
            [p.payload for p in packets], [p.payload_bits for p in packets],
            [p.frame_type == 1 for p in packets],
            [p.base_qp for p in packets], hp // spec.MB, wp // spec.MB,
            version=self.version)
        qy, qc = plane_qsteps(qps, self.version, self.chroma_qp_offset)
        return dict(ly=ly, lcb=lcb, lcr=lcr, dy=dy, dx=dx, inter=inter,
                    qy=qy, qc=qc, is_p=[p.frame_type == 1 for p in packets])

    def upload(self, host: dict) -> dict:
        """The parsed arrays as tensors on the engine's device."""
        return {k: v if k == "is_p" else torch.from_numpy(v).to(self.device)
                for k, v in host.items()}

    def key(self, levels_shape, is_p) -> DecodeKey:
        """The key of a GOP's graph: the reference jit's static arguments
        (format, quant matrix, intra slice; the chroma qp offset does not
        reach the device, plane_qsteps applies it on the host), the frame
        count and padded size from the luma levels' shape [T, Hp/8, Wp/8,
        64], the tuple of is_p (the I/P pattern, and with it a first P
        frame's zero references) and the route the wrappers read at every
        call (dispatch.force). The parsed tensors are inputs."""
        t_frames, by8, bx8 = levels_shape[:3]
        return DecodeKey(self.version, self.quant_matrix, self.intra_slice,
                         t_frames, 8 * by8, 8 * bx8, tuple(is_p),
                         dispatch._FORCE)

    def _recon_gop(self, is_p, ly, lcb, lcr, qy, qc, dy, dx, inter):
        """Every frame of a GOP rebuilt in order, each into its row of one
        uint8 [T, Hp * Wp * 3 / 2] buffer: the body a graph captures."""
        t_frames, by8, bx8, _ = ly.shape
        hp, wp = by8 * 8, bx8 * 8
        out = torch.empty((t_frames, hp * wp * 3 // 2), dtype=torch.uint8,
                          device=ly.device)
        refs = None
        for t in range(t_frames):
            refs = recon_frame(
                (ly[t], lcb[t], lcr[t]), (qy[t], qc[t], qc[t]),
                (dy[t], dx[t], inter[t]), refs, is_p[t], self.version,
                self.quant_matrix, self.intra_slice,
                _frame_views(out[t], hp, wp))
        return dict(out=out)

    def run(self, dev: dict) -> torch.Tensor:
        """Rebuild an uploaded GOP's frames; launches only, no host wait.
        Eager on the CPU and at a key's first call, else the key's graph.
        Returns the decoded bytes, uint8 [T, Hp * Wp * 3 / 2], a tensor of
        the call's own: each row one frame's padded y, cb and cr planes."""
        is_p = tuple(bool(p) for p in dev["is_p"])
        return self.cache.launch(
            self.key(dev["ly"].shape, is_p),
            lambda *xs: self._recon_gop(is_p, *xs),
            tuple(dev[k] for k in GOP_INPUTS))["out"]

    def decode_gop_start(self, width: int, height: int, packets):
        """Parse, upload and launch one GOP (its first packet the I frame)
        without waiting for the device."""
        out = self.run(self.upload(self.parse(width, height, packets)))
        return dict(out=out, width=width, height=height)

    def _download(self, handle):
        """The GOP's decoded bytes on the host and its padded size."""
        hp, wp = _padded(handle["width"], handle["height"])
        return handle["out"].cpu(), hp, wp

    def decode_gop_finish(self, handle) -> list[tuple]:
        """The GOP's frames as cropped (y, cb, cr) uint8 numpy planes."""
        flat, hp, wp = self._download(handle)
        w, h = handle["width"], handle["height"]
        return [(y[:h, :w].numpy(), cb[:h // 2, :w // 2].numpy(),
                 cr[:h // 2, :w // 2].numpy())
                for y, cb, cr in (_frame_views(row, hp, wp) for row in flat)]

    def decode_gop(self, width: int, height: int, packets) -> list[Frame]:
        """One GOP decoded synchronously, as the reference's: its frames'
        padded planes, int32."""
        flat, hp, wp = self._download(
            self.decode_gop_start(width, height, packets))
        return [Frame(*(p.numpy().astype(np.int32)
                        for p in _frame_views(row, hp, wp))) for row in flat]


def decode_clip_gop(
    f: BinaryIO, engine: GopDecodeEngine | None = None
) -> tuple[bitstream.StreamInfo, Iterator[tuple[np.ndarray, np.ndarray,
                                                np.ndarray]]]:
    """Decode a TVC1 stream GOP by GOP on the device: (info, iterator of
    cropped (y, cb, cr)). One GOP stays pending: GOP k + 1 is read,
    parsed and launched before GOP k's frames are downloaded and
    yielded. Without an engine it takes a GopDecodeEngine on cuda."""
    info, packets = bitstream.demux(f)
    engine = _take_stream_fields(engine or GopDecodeEngine(), info)

    def frames():
        pending = None
        for gop in _gops(packets):
            handle = engine.decode_gop_start(info.width, info.height, gop)
            if pending is not None:
                yield from engine.decode_gop_finish(pending)
            pending = handle
        if pending is not None:
            yield from engine.decode_gop_finish(pending)

    return info, frames()


class DeviceDecodeEngine:
    """Per-frame decode on one device: the C++ parser of one frame on the
    host (`native.parse_frame_planes`), then `recon_frame` on the device
    and one download. The recon of the frame it returned last stays on
    the device: a P frame whose ref is that Frame reads it from there.

    On CUDA each frame replays its key's graph from the key's second call
    on (the module docstring); `graphs` holds them. A P frame's reference
    planes are graph inputs, copied into its static inputs like the
    parsed tensors, and the recon it keeps is a replay's own copy."""

    def __init__(self, version: int = 1, chroma_qp_offset: int = 0,
                 quant_matrix: bool = False, intra_slice: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        native._load()
        self.version = version
        self.chroma_qp_offset = chroma_qp_offset
        self.quant_matrix = quant_matrix
        self.intra_slice = intra_slice
        self._last = None   # (the Frame returned last, its device planes)
        self.cache = GraphCache("DeviceDecodeEngine")
        self.graphs = self.cache.graphs     # DecodeFrameKey -> its GopGraph

    def key(self, is_p: bool, has_ref: bool, hp: int,
            wp: int) -> DecodeFrameKey:
        """The key of a frame's graph: the reference's static arguments
        (is_p, format, quant matrix, intra slice; the chroma qp offset is
        applied on the host), whether a P frame reads reference planes or
        the zero planes, the padded size and the route the wrappers read
        at every call (dispatch.force)."""
        return DecodeFrameKey(is_p, has_ref, self.version, self.quant_matrix,
                              self.intra_slice, hp, wp, dispatch._FORCE)

    def decode(self, width: int, height: int, pkt: bitstream.FramePacket,
               ref: Frame | None) -> Frame:
        """One frame: its padded planes, int32, as the reference's."""
        hp, wp = _padded(width, height)
        is_p = pkt.frame_type == 1
        ly, lcb, lcr, dy, dx, inter, qps = native.parse_frame_planes(
            pkt.payload, pkt.payload_bits, is_p, pkt.base_qp, hp // spec.MB,
            wp // spec.MB, version=self.version)
        qy, qc = plane_qsteps(qps, self.version, self.chroma_qp_offset)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        refs = ()
        if is_p and ref is not None:
            if self._last is not None and self._last[0] is ref:
                refs = self._last[1]
            else:
                refs = tuple(up(np.asarray(p, np.int32))
                             for p in (ref.y, ref.cb, ref.cr))

        def body(ly, lcb, lcr, qy, qc, dy, dx, inter, *refs):
            out = torch.empty(hp * wp * 3 // 2, dtype=torch.uint8,
                              device=ly.device)
            recs = recon_frame(
                (ly, lcb, lcr), (qy, qc, qc), (dy, dx, inter), refs or None,
                is_p, self.version, self.quant_matrix, self.intra_slice,
                _frame_views(out, hp, wp))
            return dict(out=out, rec=recs)

        res = self.cache.launch(
            self.key(is_p, bool(refs), hp, wp), body,
            (*(up(a) for a in (ly, lcb, lcr, qy, qc, dy, dx, inter)), *refs))
        frame = Frame(*(p.numpy().astype(np.int32)
                        for p in _frame_views(res["out"].cpu(), hp, wp)))
        self._last = (frame, res["rec"])
        return frame


class GoldenDecodeEngine:
    """Per-frame decode by the numpy golden model on the host: the
    stream's whole syntax in Python, no library and no device."""

    def __init__(self, version: int = 1, chroma_qp_offset: int = 0,
                 quant_matrix: bool = False, intra_slice: int = 0):
        self.version = version
        self.chroma_qp_offset = chroma_qp_offset
        self.quant_matrix = quant_matrix
        self.intra_slice = intra_slice

    def decode(self, width: int, height: int, pkt: bitstream.FramePacket,
               ref: Frame | None) -> Frame:
        return decode_frame(
            width, height, pkt.frame_type, pkt.base_qp, pkt.payload,
            pkt.payload_bits, ref, self.version, self.chroma_qp_offset,
            self.quant_matrix, self.intra_slice)


def decode_clip(
    f: BinaryIO, engine=None
) -> tuple[bitstream.StreamInfo, Iterator[tuple[np.ndarray, np.ndarray,
                                                np.ndarray]]]:
    """Decode a TVC1 stream frame by frame: (info, iterator of cropped
    (y, cb, cr)) through a per-frame engine (DeviceDecodeEngine or
    GoldenDecodeEngine). Without an engine it takes a DeviceDecodeEngine
    on cuda."""
    info, packets = bitstream.demux(f)
    engine = _take_stream_fields(engine or DeviceDecodeEngine(), info)

    def frames():
        ref: Frame | None = None
        for pkt in packets:
            if pkt.frame_type == 0:
                ref = None  # GOP boundary: I frames never reference
            rec = engine.decode(info.width, info.height, pkt, ref)
            ref = rec
            yield rec.crop(info.width, info.height)

    return info, frames()


def _substream_header(info: bitstream.StreamInfo, n_frames: int) -> bytes:
    """Stream header bytes for a GOP sub-stream: the clip's header with the
    frame count replaced (GOPs are closed under prediction, so a GOP's
    packets form a valid standalone stream)."""
    hdr = struct.pack(
        bitstream.STREAM_HEADER_FMT, bitstream.MAGIC, info.version,
        info.flags, info.width, info.height, info.gop_n, info.base_qp,
        info.search_mode, n_frames, info.config_hash,
    )
    if info.version >= 3:
        hdr += struct.pack("<I", info.intra_slice_mbrows & 0xFFFF)
    return hdr


def _decode_gop_native(info: bitstream.StreamInfo, gop) -> np.ndarray:
    """One GOP through the C++ decoder: uint8 [T, w * h * 3 / 2]."""
    sub = _substream_header(info, len(gop)) + b"".join(
        p.to_bytes() for p in gop)
    return native.decode_stream(sub, info.width, info.height, len(gop))


def _split_rows(info: bitstream.StreamInfo, flat: np.ndarray):
    for row in flat:
        yield yuv.split_i420(row.tobytes(), info.width, info.height)


def _native_frames(info: bitstream.StreamInfo, packets):
    for gop in _gops(packets):
        yield from _split_rows(info, _decode_gop_native(info, gop))


def decode_clip_native(f: BinaryIO):
    """Decode in C++, GOP by GOP: (info, iterator of (y, cb, cr)). The
    stream is read one GOP ahead, never whole."""
    native._load()
    info, packets = bitstream.demux(f)
    return info, _native_frames(info, packets)


def decode_clip_parallel(f: BinaryIO, workers: int = 0):
    """GOP-parallel native decode: the GOPs are independent sub-streams,
    each decoded whole by the C++ decoder on a worker thread (ctypes
    releases the GIL for the native call). Streaming: GOPs are read from
    the lazy demux as workers need them, at most workers + 1 GOPs are
    read and not yet yielded, and frames are yielded strictly in order.

    workers=0 takes min(os.cpu_count(), the GOP count from the header);
    workers=1 is decode_clip_native."""
    if workers < 0:
        raise ValueError(f"workers must be >= 0, got {workers}")
    native._load()   # before the pool: dlopen is not re-entrant
    info, packets = bitstream.demux(f)
    n_gops = -(-info.frame_count // max(info.gop_n, 1))
    nw = workers or min(os.cpu_count() or 1, max(n_gops, 1))

    def frames():
        pool = ThreadPoolExecutor(max_workers=nw)
        inflight: collections.deque = collections.deque()
        try:
            for gop in _gops(packets):
                inflight.append(pool.submit(_decode_gop_native, info, gop))
                if len(inflight) > nw:
                    yield from _split_rows(info, inflight.popleft().result())
            while inflight:
                yield from _split_rows(info, inflight.popleft().result())
        finally:
            for fut in inflight:
                fut.cancel()
            pool.shutdown(wait=True)

    return info, (_native_frames(info, packets) if nw == 1
                  else frames())
