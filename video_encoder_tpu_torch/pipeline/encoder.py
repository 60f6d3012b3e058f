"""Clip-level encode loops.

Twin of `video_encoder_tpu/pipeline/encoder.py`: the per-frame GOP loop
(`gop_schedule`, `encode_gop`, `encode_clip`) around a per-frame engine
(`pipeline/device_engine.py` `DeviceEngine` on a device, or
`GoldenEngine`, the numpy golden model on the host), the killable
`encode_clip_resumable` around any engine with `encode_gop(frames,
first_index)` (the GOP engine, or a per-frame engine through
`PerFrameGopAdapter`; `GoldenGopAdapter` for the golden model), and
two-pass (`allocate_gop_qps`, `encode_clip_twopass`) on either kind.
GOPs are closed under prediction, so the rate-control state starts fresh
at every GOP (SPEC.md §10) and a GOP is the unit of checkpoint and
resume. The frame-level rc carry of the per-frame loop is the
reference's host integer program (`spec.bitrate_next_qp`,
`spec.vbv_next`); the two-pass allocation is host float math, copied
letter for letter so both packages pick the same qps; the encoding
itself stays exact-integer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections.abc import Callable, Iterable
from typing import BinaryIO

import numpy as np

from ..codec import spec
from ..codec.bitstream import FramePacket, OrderedMux
from ..codec.config import EncoderConfig
from ..codec.frame import Frame
from ..codec.golden import encode_frame
from ..utils.metrics import FrameStats, RunSummary, psnr
from . import checkpoint as ckpt
from .bitstream_writer import open_stream_for_resume
from .device_engine import DeviceEngine


class GoldenEngine:
    """Per-frame encode engine backed by the numpy golden model: every
    format, search (full, diamond, hier) and rc mode, on the host's CPU."""

    def encode(self, cfg, cur: Frame, ref: Frame | None, frame_type: int,
               base_qp: int):
        return encode_frame(cfg, cur, ref, frame_type, base_qp)


def gop_schedule(n_frames: int, gop_n: int):
    """Yield (frame_index, gop_index, frame_type) per frame."""
    for i in range(n_frames):
        pos = i % gop_n
        yield i, i // gop_n, 0 if pos == 0 else 1


def encode_gop(
    cfg: EncoderConfig,
    engine,
    frames: list[Frame],
    gop_index: int,
    first_frame_index: int,
    collect_stats: bool = True,
) -> tuple[list[FramePacket], list[FrameStats]]:
    """Encode one GOP through a per-frame engine (a serial P chain). The
    rate-control state starts fresh at the GOP boundary, which makes GOPs
    the unit of checkpoint and resume."""
    packets, stats = [], []
    base_qp = cfg.base_qp
    target_bits = cfg.target_bits_per_frame()
    vbv_bits = cfg.vbv_bits()
    fullness = spec.vbv_init(vbv_bits)
    ref: Frame | None = None
    for k, cur in enumerate(frames):
        ftype = 0 if k == 0 else 1
        t0 = time.perf_counter()
        res = engine.encode(cfg, cur, ref, ftype, base_qp)
        ms = (time.perf_counter() - t0) * 1e3
        idx = first_frame_index + k
        packets.append(FramePacket(idx, ftype, base_qp, res.payload_bits,
                                   res.payload))
        if collect_stats:
            stats.append(FrameStats(
                index=idx,
                frame_type=ftype,
                base_qp=base_qp,
                bits=res.payload_bits,
                psnr_y=psnr(res.recon.y, cur.y),
                psnr_cb=psnr(res.recon.cb, cur.cb),
                psnr_cr=psnr(res.recon.cr, cur.cr),
                ms=ms,
                n_intra_mb=res.n_intra,
                n_inter_mb=res.n_inter,
            ))
        if cfg.rc in ("bitrate", "mb") and target_bits > 0:
            base_qp = spec.bitrate_next_qp(base_qp, res.payload_bits,
                                           target_bits)
        elif cfg.rc == "vbv" and target_bits > 0:
            base_qp, fullness = spec.vbv_next(
                base_qp, fullness, res.payload_bits, target_bits, vbv_bits)
        ref = res.recon
    return packets, stats


class PerFrameGopAdapter:
    """GOP-level interface over a per-frame engine: encode_gop(frames,
    first_index) through `encode_gop` under one config."""

    def __init__(self, cfg: EncoderConfig, engine):
        self.cfg = cfg
        self.engine = engine

    def encode_gop(self, frames: list[Frame], first_index: int):
        return encode_gop(self.cfg, self.engine, frames, 0, first_index)


class GoldenGopAdapter(PerFrameGopAdapter):
    """GOP-level interface over the golden engine (checkpointed encodes,
    tests, CPU runs)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__(cfg, GoldenEngine())


def encode_clip_resumable(
    cfg: EncoderConfig,
    raw_frames: Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]],
    out_path: str,
    n_frames: int,
    engine,
    checkpoint_path: str,
    timer=None,
    log=None,
) -> RunSummary:
    """Killable clip encode: resumes losslessly at the last GOP boundary,
    and the resumed stream is byte-identical to an uninterrupted encode.
    `engine` exposes encode_gop(frames, first_index) like
    `GopEngine` or `PerFrameGopAdapter`. After each GOP its packets are
    written and flushed, then the checkpoint is saved; a kill between the
    two leaves bytes past the checkpoint's offset, which the resume cuts
    off (`open_stream_for_resume`). timer (utils.trace.StageTimer) splits
    encode from write+checkpoint wall time; log (utils.trace.EventLog)
    emits one 'gop' event per flush."""

    def stage(name):
        return timer.stage(name) if timer else contextlib.nullcontext()

    state = ckpt.load(checkpoint_path, cfg)
    start_frame = state.next_frame if state else 0
    summary = state.to_summary() if state else RunSummary()

    f = open_stream_for_resume(out_path, cfg, n_frames, state)
    try:
        it = iter(raw_frames)
        for _ in range(start_frame):  # skip already-encoded input frames
            next(it)
        gop: list[Frame] = []
        idx = start_frame
        count = start_frame

        def flush(gop, idx):
            t0 = time.perf_counter()
            with stage("encode_gop"):
                packets, stats = engine.encode_gop(gop, idx)
            with stage("write+checkpoint"):
                for p in packets:
                    f.write(p.to_bytes())
                f.flush()
                for s in stats:
                    summary.add(s)
                ckpt.save(
                    checkpoint_path,
                    ckpt.EncodeState(
                        config_hash=cfg.config_hash(),
                        next_frame=idx + len(gop),
                        byte_offset=f.tell(),
                        frames_done=summary.frames,
                        total_bits=summary.total_bits,
                        total_ms=summary.total_ms,
                        sum_psnr_y=summary.sum_psnr_y,
                    ),
                )
            if log:
                log.emit("gop", first=idx, frames=len(gop),
                         ms=round((time.perf_counter() - t0) * 1e3, 1))

        for planes in it:
            if count >= n_frames:
                break
            gop.append(Frame.from_planes(*planes))
            count += 1
            if len(gop) == cfg.gop_n:
                flush(gop, idx)
                idx += len(gop)
                gop = []
        if gop:
            flush(gop, idx)
    finally:
        f.close()
    ckpt.clear(checkpoint_path)
    return summary


def encode_clip(
    cfg: EncoderConfig,
    raw_frames: Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]],
    out: BinaryIO,
    n_frames: int,
    engine=None,
    on_frame: Callable[[FrameStats], None] | None = None,
) -> RunSummary:
    """Single-process clip encode through a per-frame engine (default
    DeviceEngine() on cuda), GOP by GOP, with the in-order mux."""
    engine = engine or DeviceEngine()
    mux = OrderedMux(out, cfg, n_frames)
    summary = RunSummary()
    gop: list[Frame] = []
    gop_start = 0
    gop_idx = 0

    def flush():
        nonlocal gop, gop_start, gop_idx
        if not gop:
            return
        packets, stats = encode_gop(cfg, engine, gop, gop_idx, gop_start)
        for p in packets:
            mux.push(p)
        for s in stats:
            summary.add(s)
            if on_frame:
                on_frame(s)
        gop_start += len(gop)
        gop_idx += 1
        gop = []

    count = 0
    for y, cb, cr in raw_frames:
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(y, cb, cr))
        count += 1
        if len(gop) == cfg.gop_n:
            flush()
    flush()
    mux.close()
    return summary


def allocate_gop_qps(
    base_qp: int,
    gop_bits: list[int],
    gop_lens: list[int],
    target_bits_per_frame: int,
    alpha: float = 0.6,
) -> list[int]:
    """Two-pass GOP-level allocation.

    gop_bits are pass-1 sizes at constant base_qp (the complexity measure).
    Each GOP's budget is proportional to complexity**alpha (alpha < 1
    flattens quality across easy/hard content; alpha = 1 reproduces
    constant qp). QSTEP doubles every 6 qp (SPEC.md §4), so rate roughly
    halves per +6 qp: qp_g = base_qp + round(6*log2(bits_g / budget_g)).
    Host-side floats only — pass-2 encoding stays exact-integer.
    """
    total_target = target_bits_per_frame * sum(gop_lens)
    c = [max(float(b), 1.0) ** alpha for b in gop_bits]
    csum = sum(c)
    qps = []
    for b, ci in zip(gop_bits, c):
        budget = max(total_target * ci / csum, 1.0)
        qp = base_qp + int(round(6 * math.log2(max(float(b), 1.0) / budget)))
        qps.append(max(spec.QP_MIN, min(spec.QP_MAX, qp)))
    return qps


def encode_clip_twopass(
    cfg: EncoderConfig,
    open_frames: Callable[[], Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]]],
    out: BinaryIO,
    n_frames: int,
    engine,
    alpha: float = 0.6,
    on_frame: Callable[[FrameStats], None] | None = None,
) -> RunSummary:
    """Two-pass clip encode: pass 1 measures per-GOP complexity at constant
    cfg.base_qp, pass 2 re-encodes each GOP at its allocated qp so the clip
    lands on cfg.target_kbps. cfg.rc names the target only: within a GOP
    both passes run at a constant qp (rc none), so GOPs stay closed.

    open_frames: zero-arg callable returning a fresh frame iterable (the
    clip is read twice — files, not generators). `engine` is a GOP-level
    engine (`GopEngine`: both passes run on a new engine of its type,
    device and emit under the constant-qp config) or a per-frame engine
    (`DeviceEngine`, `GoldenEngine`: each GOP goes through `encode_gop`
    at its qp). Every
    packet of a GOP carries the qp allocated to it.
    """
    target = cfg.target_bits_per_frame()
    if target <= 0:
        raise ValueError("two-pass needs target_kbps > 0 (rc='bitrate'|'vbv')")
    cfg_cq = dataclasses.replace(cfg, rc="none", target_kbps=0, vbv_kbits=0)
    gop_level = hasattr(engine, "encode_gop")
    if gop_level:
        engine = type(engine)(cfg_cq, device=engine.device, emit=engine.emit)

    def run_gop(g, gi, start, qp, collect_stats=True):
        if gop_level:
            return engine.encode_gop(g, start, base_qp=qp)
        return encode_gop(dataclasses.replace(cfg_cq, base_qp=qp), engine,
                          g, gi, start, collect_stats=collect_stats)

    def gops():
        gop: list[Frame] = []
        count = 0
        for y, cb, cr in open_frames():
            if count >= n_frames:
                break
            gop.append(Frame.from_planes(y, cb, cr))
            count += 1
            if len(gop) == cfg.gop_n:
                yield gop
                gop = []
        if gop:
            yield gop

    # pass 1: constant-qp sizes per GOP; the bits come from the packets
    gop_bits: list[int] = []
    gop_lens: list[int] = []
    start = 0
    for g in gops():
        packets, _ = run_gop(g, len(gop_bits), start, cfg.base_qp,
                             collect_stats=False)
        gop_bits.append(sum(p.payload_bits for p in packets))
        gop_lens.append(len(g))
        start += len(g)

    qps = allocate_gop_qps(cfg.base_qp, gop_bits, gop_lens, target, alpha)

    # pass 2: allocated qp per GOP, in-order mux under the ORIGINAL config
    # (the stream header hash reflects what the user asked for)
    mux = OrderedMux(out, cfg, n_frames)
    summary = RunSummary()
    start = 0
    for gi, g in enumerate(gops()):
        packets, stats = run_gop(g, gi, start, qps[gi])
        for p in packets:
            mux.push(p)
        for s in stats:
            summary.add(s)
            if on_frame:
                on_frame(s)
        start += len(g)
    mux.close()
    return summary
