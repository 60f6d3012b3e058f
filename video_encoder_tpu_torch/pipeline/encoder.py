"""Two-pass clip encode on the GOP-resident engine.

Twin of `video_encoder_tpu/pipeline/encoder.py` for `allocate_gop_qps`
and the GOP-level branch of `encode_clip_twopass` (an engine with
`encode_gop(frames, first_index, base_qp)`); the per-frame engines of the
reference are not ported. Pass 1 encodes every GOP at the constant base
qp and keeps only its size; pass 2 encodes each GOP at the qp allocated
to it. The allocation is host float math, copied letter for letter so
both packages pick the same qps; the encoding itself stays exact-integer.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable
from typing import BinaryIO

import numpy as np

from ..codec import spec
from ..codec.bitstream import OrderedMux
from ..codec.config import EncoderConfig
from ..codec.frame import Frame
from ..utils.metrics import FrameStats, RunSummary
from .gop_engine import GopEngine


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
    engine: GopEngine,
    alpha: float = 0.6,
    on_frame: Callable[[FrameStats], None] | None = None,
) -> RunSummary:
    """Two-pass clip encode: pass 1 measures per-GOP complexity at constant
    cfg.base_qp, pass 2 re-encodes each GOP at its allocated qp so the clip
    lands on cfg.target_kbps. cfg.rc names the target only: within a GOP
    both passes run at a constant qp (rc none), so GOPs stay closed.

    open_frames: zero-arg callable returning a fresh frame iterable (the
    clip is read twice — files, not generators). `engine` gives the
    device and the emit; both passes run on a new engine of its type
    under the constant-qp config. Every packet of a GOP carries the qp
    allocated to it.
    """
    target = cfg.target_bits_per_frame()
    if target <= 0:
        raise ValueError("two-pass needs target_kbps > 0 (rc='bitrate'|'vbv')")
    cfg_cq = dataclasses.replace(cfg, rc="none", target_kbps=0, vbv_kbits=0)
    engine = type(engine)(cfg_cq, device=engine.device, emit=engine.emit)

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
        packets, _ = engine.encode_gop(g, start, base_qp=cfg.base_qp)
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
        packets, stats = engine.encode_gop(g, start, base_qp=qps[gi])
        for p in packets:
            mux.push(p)
        for s in stats:
            summary.add(s)
            if on_frame:
                on_frame(s)
        start += len(g)
    mux.close()
    return summary
