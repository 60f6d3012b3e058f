"""Command line of the port: encode on one device or over ranks, decode on
one device, or decode, info and psnr on the host.

    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 -o out.tvc
    python -m video_encoder_tpu_torch.cli decode -i out.tvc -o dec.yuv
    python -m video_encoder_tpu_torch.cli info   -i out.tvc
    python -m video_encoder_tpu_torch.cli psnr   -a ref.yuv -b dec.yuv -W 1920 -H 1080

`encode` runs the GOP-resident engine (`--engine gop`, the default: full
or diamond search, formats 1 to 4, every rc mode) or the per-frame
engine (`--engine device`: format 1, rc none, adaptive, bitrate or vbv)
on `--device` (default cuda), or the numpy golden model on the host's CPU
(`--engine golden`: every format, search and rc mode, one frame at a
time; it ignores `--device`). `--search hier` is golden-only, as in the
reference, which retired it from its device engines:

    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --search diamond --rc mb --kbps 12000
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --format 4 --quant-matrix --chroma-qp-offset 2
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --gop-batch 4
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --two-pass --kbps 12000
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --tile 4 --gop-batch 2
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --engine device --search diamond --rc bitrate --kbps 12000
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --engine golden --search hier --format 2
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --checkpoint out.ckpt
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --trace traces/ --stage-timers

`--gop-batch G` encodes G full GOPs in lockstep, every kernel launching
once for G frames; `--two-pass` allocates one qp per GOP from a first
pass at constant qp; `--tile S` encodes every frame as S row shards with
a halo exchange between them (full search only; with `--gop-batch G`, G
GOPs of S shards per step), all on the one device. `--devices N` spreads
batches of N / S full GOPs over N ranks, one process each (with `--tile
S`, each GOP's frames in S row shards over S of them), `--multiprocess
N` gives N ranks a contiguous share of the full GOPs each, and
`--failover` re-encodes a failed GOP or batch on a survivor engine
(`parallel/`; the ranks run on the cards, sharing them over gloo where
there are fewer cards than ranks):

    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --gop 10 --devices 4 --tile 2 --failover

`--checkpoint PATH` saves the encode's state after every GOP and resumes
a killed encode at its last GOP, byte-identical to an uninterrupted one
(any engine; single pass, no `--gop-batch` or `--tile`). `--trace DIR` writes a
torch.profiler trace of the encode, the program's spans on the host's
row, into DIR; `--stage-timers` adds the host stages' wall times and the
program's spans and counters (utils/trace.py RECORDER) to the summary.
Its streams are byte-identical to the reference CLI's. `decode` takes
the reference's engines (`pipeline/decoder.py`): `--engine native` (the
default) decodes with the C++ decoder of `oracle/oracle.cpp` through
ctypes (`codec/native.py`),
GOP-parallel on `--workers` threads, or, where that library cannot be
loaded, warns and decodes with the golden model, as the reference does;
`--engine gop|device` parse with it and rebuild the frames on `--device`
(default cuda); `--engine golden` decodes with the numpy golden model on
the host:

    python -m video_encoder_tpu_torch.cli decode -i out.tvc -o dec.yuv --workers 4
    python -m video_encoder_tpu_torch.cli decode -i out.tvc -o dec.yuv --engine gop
    python -m video_encoder_tpu_torch.cli decode -i out.tvc -o dec.yuv --engine golden
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .codec import native
from .codec.bitstream import OrderedMux, read_stream_header
from .codec.config import EncoderConfig
from .codec.frame import Frame
from .io import yuv
from .ops.kernels import build
from .parallel import multiprocess as mp
from .parallel.failover import (RECOVERABLE, FaultInjector, GopFailure,
                                encode_gops_with_recovery, redispatched,
                                survivor_device)
from .parallel.gop_parallel import ShardedGopEncoder
from .parallel.mesh import make_codec_mesh
from .pipeline import decoder
from .pipeline.device_engine import DeviceEngine
from .pipeline.encoder import (GoldenEngine, PerFrameGopAdapter, encode_clip,
                               encode_clip_resumable, encode_clip_twopass)
from .pipeline.gop_engine import GopEngine
from .utils.metrics import RunSummary, psnr
from .utils.trace import RECORDER, EventLog, StageTimer, trace

def _add_dims(p):
    p.add_argument("-W", "--width", type=int, default=0)
    p.add_argument("-H", "--height", type=int, default=0)


class _Mux:
    """OrderedMux and the run's summary: each GOP's packets and stats."""

    def __init__(self, fo, cfg: EncoderConfig, n_frames: int, verbose: bool):
        self.mux = OrderedMux(fo, cfg, n_frames)
        self.summary = RunSummary()
        self.verbose = verbose
        self.muxed: set[int] = set()    # first frames of the GOPs muxed

    def emit(self, packets, stats):
        for p in packets:
            self.mux.push(p)
        if packets:
            self.muxed.add(packets[0].index)
        for st in stats:
            self.summary.add(st)
            if self.verbose:
                print(st.to_json(), file=sys.stderr)

    def recover(self, survivor, gops, firsts, err):
        """A failed batch's GOPs, encoded again on the survivor."""
        redispatched(firsts, err, survivor)
        stats: list = []
        self.emit(encode_gops_with_recovery(survivor, gops, firsts,
                                            stats=stats), stats)


def encode_gop_resident(cfg: EncoderConfig, eng: GopEngine, frames, fo,
                        n_frames: int, verbose: bool = False,
                        gop_batch: int = 1, timer=None) -> RunSummary:
    """GOP-resident encode + ordered mux: GOP k+1 is read and uploaded while
    GOP k runs on the device.

    gop_batch = G > 1 groups G full GOPs into one lockstep encode
    (`GopEngine.start` of G GOPs), byte-identical to G = 1. Of the tail,
    leftover full GOPs are batched if there is more than one of them, and
    a single one or a short last GOP goes through the single-GOP encode.
    timer (utils.trace.StageTimer, `--stage-timers`) splits the wall time
    into upload+dispatch and drain+mux."""

    def stage(name):
        return timer.stage(name) if timer else contextlib.nullcontext()

    out = _Mux(fo, cfg, n_frames, verbose)
    pending = None   # double buffer: batch k runs while k+1 is read

    def drain(handle):
        with stage("drain+mux"):
            for packets, stats in eng.finish(handle):
                out.emit(packets, stats)

    def launch(gops, firsts):
        nonlocal pending
        with stage("upload+dispatch"):
            handle = eng.start(gops, firsts)
        if pending is not None:
            drain(pending)
        pending = handle

    gop: list[Frame] = []
    batch: list[list[Frame]] = []
    batch_firsts: list[int] = []
    start = 0
    for count, planes in enumerate(frames):
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        if len(gop) == cfg.gop_n:
            if gop_batch > 1:
                batch.append(gop)
                batch_firsts.append(start)
                if len(batch) == gop_batch:
                    launch(batch, batch_firsts)
                    batch, batch_firsts = [], []
            else:
                launch([gop], [start])
            start += len(gop)
            gop = []
    # the tail: leftover full GOPs (one alone is a single-GOP encode), then
    # the short GOP
    if batch:
        launch(batch, batch_firsts)
    if gop:
        launch([gop], [start])
    if pending is not None:
        drain(pending)
    out.mux.close()
    return out.summary


def encode_tiled(cfg: EncoderConfig, senc: ShardedGopEncoder, eng: GopEngine,
                 frames, fo, n_frames: int, verbose: bool = False,
                 survivor=None, fault: FaultInjector | None = None
                 ) -> RunSummary:
    """Tile-sharded encode + ordered mux: every batch of as many full GOPs
    as the mesh's 'gop' axis goes through `senc`, batch k + 1 read and
    launched while batch k runs (`senc.start`, `GopEngine.finish`);
    full GOPs short of a batch and the clip's short last GOP go through
    the single-device engine. Same bytes as the unsharded encode. With a
    survivor (`--failover`), a batch whose injected fault fires (checked
    before it is launched) or whose encode raises a recoverable error is
    encoded again GOP by GOP on the survivor."""
    out = _Mux(fo, cfg, n_frames, verbose)
    pending = None

    def drain(handle, gops, firsts):
        try:
            results = eng.finish(handle)
        except RECOVERABLE as e:
            if survivor is None:
                raise
            out.recover(survivor, gops, firsts, e)
            return
        for packets, stats in results:
            out.emit(packets, stats)

    def launch(batched, gops, firsts):
        nonlocal pending
        try:
            if batched and fault is not None:
                for first in firsts:
                    fault.check(first)
            handle = (senc if batched else eng).start(gops, firsts)
        except RECOVERABLE as e:
            if survivor is None:
                raise
            out.recover(survivor, gops, firsts, e)
            return
        if pending is not None:
            drain(*pending)
        pending = (handle, gops, firsts)

    gop: list[Frame] = []
    batch: list[list[Frame]] = []
    firsts: list[int] = []
    start = 0
    for count, planes in enumerate(frames):
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        if len(gop) == cfg.gop_n:
            batch.append(gop)
            firsts.append(start)
            start += len(gop)
            gop = []
            if len(batch) == senc.n_gop_devices:
                launch(True, batch, firsts)
                batch, firsts = [], []
    for g, first in zip(batch, firsts):   # full GOPs short of a batch
        launch(False, [g], [first])
    if gop:
        launch(False, [gop], [start])
    if pending is not None:
        drain(*pending)
    out.mux.close()
    return out.summary


def encode_failover(cfg: EncoderConfig, eng: GopEngine, survivor, frames, fo,
                    n_frames: int, fault: FaultInjector | None = None,
                    verbose: bool = False) -> RunSummary:
    """`--failover` on one engine: each GOP through
    encode_gops_with_recovery, retried on `eng` and then re-dispatched on
    the survivor (the reference's `_encode_failover`)."""
    out = _Mux(fo, cfg, n_frames, verbose)
    gop: list[Frame] = []
    start = 0

    def flush():
        stats: list = []
        out.emit(encode_gops_with_recovery(eng, [gop], [start],
                                           fallback=survivor, fault=fault,
                                           stats=stats), stats)

    for count, planes in enumerate(frames):
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        if len(gop) == cfg.gop_n:
            flush()
            start += len(gop)
            gop = []
    if gop:
        flush()
    out.mux.close()
    return out.summary


def encode_ranks(cfg: EncoderConfig, a, eng: GopEngine, fo, n_frames: int,
                 survivor=None, fault: FaultInjector | None = None,
                 timeout_s: float = mp.DEFAULT_TIMEOUT_S):
    """`--devices N [--tile S]`: batch k of N / S full GOPs goes to the
    ranks, 'gop' rank g (with its S tile ranks) encoding GOP k N / S + g;
    each rank reads its own GOPs from the input, and this process muxes
    the packets as they arrive. The full GOPs short of a batch and the
    short last GOP are encoded here on `eng` while the ranks run. With a
    survivor (`--failover`), a batch whose injected fault fires is never
    dispatched and is encoded here on the survivor, and if a rank fails,
    every rank is stopped and every GOP not yet received is encoded on the
    survivor. Returns (summary, each rank's row)."""
    n_gop = a.devices // a.tile
    n_full = n_frames // cfg.gop_n
    batches = [[(k * n_gop + g) * cfg.gop_n for g in range(n_gop)]
               for k in range(n_full // n_gop)]
    ranked, on_survivor = [], []
    for firsts in batches:
        try:
            for first in firsts if fault is not None else ():
                fault.check(first)
            ranked.append(firsts)
        except GopFailure as e:   # before dispatch: no rank skips a collective
            redispatched(firsts, e, survivor)
            on_survivor += firsts
    tail = list(range(len(batches) * n_gop * cfg.gop_n, n_frames, cfg.gop_n))
    out = _Mux(fo, cfg, n_frames, a.verbose)

    def encode_here(firsts, engine):
        for first, gop in mp.read_gops(a.input, cfg.width, cfg.height,
                                       cfg.gop_n, firsts, n_frames):
            if engine is eng:
                out.emit(*eng.encode_gop(gop, first))
            else:   # the survivor retries, as the reference's does
                stats: list = []
                out.emit(encode_gops_with_recovery(engine, [gop], [first],
                                                   stats=stats), stats)

    rows: list = []
    job = dict(kind="gops", cfg=dataclasses.asdict(cfg),
               clip=os.path.abspath(a.input), width=cfg.width,
               height=cfg.height, mesh=[n_gop, a.tile], schedule=ranked)
    with contextlib.ExitStack() as stack:
        group = (stack.enter_context(mp.RankGroup(
            a.devices, [job], device=a.device, timeout_s=timeout_s))
            if ranked else None)
        encode_here(sorted(on_survivor), survivor)
        encode_here(tail, eng)
        if group is not None:
            try:
                for ev in group.events():
                    for packets, stats in ev["result"]:
                        out.emit(packets, stats)
                rows = [r for rank_rows in group.rows for r in rank_rows]
            except mp.RankFailure as e:
                if survivor is None:
                    raise
                lost = [f for b in ranked for f in b if f not in out.muxed]
                redispatched(lost, e, survivor)
                encode_here(lost, survivor)
    out.mux.close()
    return out.summary, rows


def encode_multiprocess(cfg: EncoderConfig, a, eng: GopEngine, fo,
                        n_frames: int,
                        timeout_s: float = mp.DEFAULT_TIMEOUT_S):
    """`--multiprocess N`: N ranks encode contiguous shares of the clip's
    full GOPs (`multiprocess.spawn_clip_encode`); this process muxes their
    packets and then encodes the rest on `eng`, as the reference's
    `_encode_multiprocess`. Returns (summary, each rank's row)."""
    rows, packets, stats = mp.spawn_clip_encode(
        cfg, a.input, cfg.width, cfg.height, n_frames, a.multiprocess,
        device=a.device, timeout_s=timeout_s)
    out = _Mux(fo, cfg, n_frames, a.verbose)
    out.emit(packets, stats)
    for first, gop in mp.read_gops(a.input, cfg.width, cfg.height, cfg.gop_n,
                                   range(len(packets), n_frames, cfg.gop_n),
                                   n_frames):
        out.emit(*eng.encode_gop(gop, first))
    out.mux.close()
    return out.summary, rows


def _encode_refusal(a, cfg: EncoderConfig) -> str | None:
    """Why an encode's flags cannot run together, or None. Checked before
    the output file is truncated."""
    if cfg.search == "hier" and a.engine != "golden":
        return ("--search hier is golden/oracle-only (retired from the "
                "device engines: slower AND worse RD than full on TPU - "
                "BASELINE.md); use --search full, or --engine golden to "
                "reproduce hier streams")
    if a.gop_batch < 1:
        return "--gop-batch must be >= 1"
    if a.two_pass:
        if a.kbps <= 0:
            return "--two-pass requires --kbps"
        if cfg.rc == "adaptive":
            return ("--two-pass allocates qp at the GOP level; use --rc "
                    "none|bitrate|vbv")
    if a.tile < 1:
        return "--tile must be >= 1"
    if a.tile > 1 and (a.two_pass or cfg.search != "full"):
        return ("--tile needs a single pass and --search full (the "
                "pre-haloed full search)")
    if a.engine == "device":
        if a.format != 1:
            return ("--engine device is the format-1 per-frame engine; use "
                    "--engine gop for formats 2-4")
        if cfg.rc == "mb" and not a.two_pass:
            return ("--engine device does not code --rc mb: the reference's "
                    "per-frame engine ignores it (every MB at the frame qp, "
                    "the rc bitrate stream); use --engine gop")
    if a.engine != "gop" and (a.gop_batch > 1 or a.tile > 1):
        return (f"--engine {a.engine} encodes one frame at a time; "
                "--gop-batch and --tile need --engine gop")
    if a.devices < 0 or a.multiprocess < 0:
        return "--devices and --multiprocess take N >= 1 ranks"
    if a.devices % a.tile:
        return f"--devices {a.devices} not divisible by --tile {a.tile}"
    if (a.devices or a.tile > 1) and (a.engine != "gop" or a.two_pass
                                      or a.multiprocess):
        return ("--devices/--tile need the gop engine, single pass, no "
                "--multiprocess")
    if a.multiprocess and (a.two_pass or a.engine != "gop"):
        return "--multiprocess needs the gop engine, single pass"
    if (a.devices or a.multiprocess) and a.gop_batch > 1:
        return ("--gop-batch batches GOPs on one device; --devices and "
                "--multiprocess spread them over ranks, one GOP per rank")
    if a.checkpoint and a.failover:
        return ("--checkpoint resumes the single-engine serial path; "
                "--failover re-dispatches GOPs on a survivor: pick one")
    if a.checkpoint and (a.two_pass or a.gop_batch > 1 or a.tile > 1
                         or a.devices or a.multiprocess):
        return ("--checkpoint is the single-engine serial path (no "
                "--two-pass, --gop-batch, --tile, --devices or "
                "--multiprocess); GOPs are the resume unit")
    if a.failover and (a.two_pass or a.multiprocess or a.engine != "gop"):
        return "--failover wraps the gop/sharded engines, single pass"
    if a.failover and a.gop_batch > 1:
        return ("--failover re-encodes GOP by GOP; it does not take "
                "--gop-batch")
    return None


def _fault_injector() -> FaultInjector | None:
    """TVC_FAULT_GOPS=i,j (first-frame indices) and TVC_FAULT_TIMES inject
    faults into --failover runs, as the reference CLI's."""
    if not os.environ.get("TVC_FAULT_GOPS"):
        return None
    return FaultInjector(
        {int(x) for x in os.environ["TVC_FAULT_GOPS"].split(",")},
        times=int(os.environ.get("TVC_FAULT_TIMES", "1")))


def cmd_encode(a) -> int:
    w, h, fps, frames = yuv.open_clip(a.input, a.width, a.height)
    cfg = EncoderConfig(
        width=w, height=h, gop_n=a.gop, base_qp=a.qp, search=a.search,
        rc=a.rc, target_kbps=a.kbps, fps_num=fps[0], fps_den=fps[1],
        format_version=a.format, chroma_qp_offset=a.chroma_qp_offset,
        quant_bias=a.quant_bias, vbv_kbits=a.vbv_kbits,
        quant_matrix=a.quant_matrix, intra_slice_mbrows=a.intra_slice,
    )
    why = _encode_refusal(a, cfg)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    if a.two_pass and cfg.rc == "none":
        cfg = dataclasses.replace(cfg, rc="bitrate")
    senc = None
    if a.tile > 1 or a.devices:
        # on ranks, the layout is checked here, before the file is opened
        n_gop = a.devices // a.tile if a.devices else a.gop_batch
        try:
            senc = ShardedGopEncoder(
                cfg, make_codec_mesh(n_gop, a.tile, a.device))
        except ValueError as e:   # the frame or its slices do not divide
            print(f"error: --tile {a.tile}: {e}", file=sys.stderr)
            return 2
    if a.engine == "golden":
        eng = GoldenEngine()      # on the host; --device is not read
    elif a.engine == "device":
        eng = DeviceEngine(device=a.device)
    else:
        eng = senc.engine if senc else GopEngine(cfg, device=a.device)
    survivor = fault = None
    if a.failover:
        survivor = GopEngine(cfg, device=survivor_device(eng.device),
                             emit=eng.emit)
        fault = _fault_injector()
    ranks = a.devices or a.multiprocess
    if ranks and eng.device.type == "cuda":
        build.lib()     # once, before the ranks load it
        cards = torch.cuda.device_count()
        if ranks > cards:
            print(f"note: {ranks} ranks on {cards} card(s): the ranks share "
                  "cards over gloo", file=sys.stderr)
    n_frames = a.frames
    if n_frames == 0:
        if a.input.endswith(".y4m"):
            print("error: --frames required for y4m input", file=sys.stderr)
            return 2
        n_frames = yuv.count_yuv_frames(a.input, w, h)

    timer = StageTimer() if a.stage_timers else None
    if timer is not None:
        RECORDER.reset()    # the summary's spans and counters: this encode's
    rows = None
    t0 = time.perf_counter()
    on_frame = ((lambda st: print(st.to_json(), file=sys.stderr))
                if a.verbose else None)
    with trace(a.trace):
        if a.checkpoint:
            # the resume path must not truncate the output: the writer
            # cuts it back to the checkpoint's byte offset
            summary = encode_clip_resumable(
                cfg, frames, a.output, n_frames,
                eng if a.engine == "gop" else PerFrameGopAdapter(cfg, eng),
                a.checkpoint, timer=timer,
                log=EventLog(sys.stderr) if a.verbose else None)
        else:
            with open(a.output, "wb") as fo:
                if a.two_pass:   # both passes; takes no --gop-batch
                    summary = encode_clip_twopass(
                        cfg, lambda: yuv.open_clip(a.input, a.width,
                                                   a.height)[3],
                        fo, n_frames, engine=eng, on_frame=on_frame)
                elif a.devices:
                    summary, rows = encode_ranks(cfg, a, eng, fo, n_frames,
                                                 survivor, fault)
                elif a.multiprocess:
                    summary, rows = encode_multiprocess(cfg, a, eng, fo,
                                                        n_frames)
                elif senc is not None:
                    summary = encode_tiled(cfg, senc, eng, frames, fo,
                                           n_frames, a.verbose, survivor,
                                           fault)
                elif a.failover:
                    summary = encode_failover(cfg, eng, survivor, frames, fo,
                                              n_frames, fault, a.verbose)
                elif a.engine != "gop":   # the per-frame engines
                    summary = encode_clip(cfg, frames, fo, n_frames,
                                          engine=eng, on_frame=on_frame)
                else:
                    summary = encode_gop_resident(
                        cfg, eng, frames, fo, n_frames, a.verbose,
                        a.gop_batch, timer=timer)
    wall = time.perf_counter() - t0
    out = json.loads(summary.to_json())
    out["device"] = "cpu" if a.engine == "golden" else str(eng.device)
    out["engine"] = a.engine
    out["wall_s"] = round(wall, 3)
    out["wall_fps"] = round(summary.frames / wall, 2) if wall else 0
    if rows is not None:
        out["backend"] = rows[0]["backend"] if rows else None
        out["ranks"] = rows
    if fault is not None:
        out["faults_injected"] = fault.injected
    if timer is not None:
        out["stages"] = timer.report()
        out["spans"] = RECORDER.report()
        out["counters"] = dict(sorted(RECORDER.counters.items()))
    print(json.dumps(out))
    return 0


def cmd_decode(a) -> int:
    """The reference's cmd_decode: `--engine native` (the default) decodes
    in C++, GOP-parallel on `--workers` threads (0: one per core, up to
    the GOP count; 1: serial), or warns and decodes with the golden model
    where the C++ library cannot be loaded; `gop` and `device` rebuild
    the frames on `--device`; `golden` decodes with the golden model on
    the host. Frames are written as the decoder yields them."""
    if a.workers < 0:
        print("error: --workers must be >= 0", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    n = 0
    if a.engine == "native" and not native.available():
        print("warning: native lib unavailable, using golden", file=sys.stderr)
        a.engine = "golden"
    with open(a.input, "rb") as fi:
        if a.engine == "native" and a.workers != 1:
            info, frames = decoder.decode_clip_parallel(fi, a.workers)
        elif a.engine == "native":
            info, frames = decoder.decode_clip_native(fi)
        elif a.engine == "gop":
            info, frames = decoder.decode_clip_gop(
                fi, decoder.GopDecodeEngine(device=a.device))
        elif a.engine == "device":
            info, frames = decoder.decode_clip(
                fi, decoder.DeviceDecodeEngine(device=a.device))
        else:
            info, frames = decoder.decode_clip(fi,
                                               decoder.GoldenDecodeEngine())
        with open(a.output, "wb") as fo:
            for y, cb, cr in frames:
                yuv.write_yuv_frame(fo, y, cb, cr)
                n += 1
    wall = time.perf_counter() - t0
    print(json.dumps({"frames": n, "width": info.width, "height": info.height,
                      "engine": a.engine, "wall_s": round(wall, 3),
                      "fps": round(n / wall, 2) if wall else 0}))
    return 0


def cmd_info(a) -> int:
    with open(a.input, "rb") as f:
        info = read_stream_header(f)
    print(json.dumps(info.__dict__))
    return 0


def cmd_psnr(a) -> int:
    with open(a.a, "rb") as fa, open(a.b, "rb") as fb:
        stats = [
            (psnr(ya, yb), psnr(cba, cbb), psnr(cra, crb))
            for (ya, cba, cra), (yb, cbb, crb) in zip(
                yuv.read_yuv_frames(fa, a.width, a.height),
                yuv.read_yuv_frames(fb, a.width, a.height),
            )
        ]
    if not stats:
        print("error: no frames", file=sys.stderr)
        return 1
    arr = np.minimum(np.array(stats), 999.0)  # lossless planes -> cap
    print(json.dumps({
        "frames": len(stats),
        "psnr_y": round(float(arr[:, 0].mean()), 3),
        "psnr_cb": round(float(arr[:, 1].mean()), 3),
        "psnr_cr": round(float(arr[:, 2].mean()), 3),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="video_encoder_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="raw YUV/Y4M -> TVC1 on one device "
                       "or over ranks")
    e.add_argument("-i", "--input", required=True)
    e.add_argument("-o", "--output", required=True)
    _add_dims(e)
    e.add_argument("--gop", type=int, default=30)
    e.add_argument("--qp", type=int, default=28)
    e.add_argument("--frames", type=int, default=0, help="0 = all")
    e.add_argument("--search", choices=["full", "diamond", "hier"],
                   default="full",
                   help="ME mode; hier (a coarse search on 4x-downsampled "
                        "planes, then a refine) only with --engine golden, "
                        "as in the reference")
    e.add_argument("--rc", choices=["none", "adaptive", "bitrate", "vbv", "mb"],
                   default="none", help="rate control")
    e.add_argument("--kbps", type=int, default=0,
                   help="target rate of --rc bitrate/vbv/mb")
    e.add_argument("--vbv-kbits", type=int, default=0,
                   help="rc=vbv buffer size (0 = 8x per-frame target)")
    e.add_argument("--format", type=int, choices=[1, 2, 3, 4], default=1,
                   help="bitstream format: 1=TVC1, 2=v2 (mv pred, DC DPCM), "
                        "3=v3 (I-frame intra pred, quant matrix), "
                        "4=v4 (half-pel motion)")
    e.add_argument("--quant-matrix", action="store_true",
                   help="v3: per-frequency quant matrix (SPEC.md 13.2)")
    e.add_argument("--intra-slice", type=int, default=0,
                   help="v3: reset the I-frame vertical-intra predictor "
                        "every N MB rows (SPEC.md 13.3)")
    e.add_argument("--quant-bias", type=int, default=8,
                   help="AC quantizer rounding bias /16; 8=midpoint, "
                        "lower=deadzone (fewer bits, encoder-side only)")
    e.add_argument("--chroma-qp-offset", type=int, default=0,
                   help="v2+: chroma QP offset in [-12, 12]")
    e.add_argument("--gop-batch", type=int, default=1,
                   help="encode G full GOPs in lockstep, each kernel "
                        "launching once for G frames; byte-identical to 1")
    e.add_argument("--tile", type=int, default=1,
                   help="encode every frame as S row shards with a halo "
                        "exchange (needs --search full, MB rows divisible "
                        "by S; format >= 3 also --intra-slice dividing a "
                        "shard's MB rows); byte-identical to 1")
    e.add_argument("--devices", type=int, default=0,
                   help="spread batches of N / S full GOPs over N ranks, one "
                        "process each (S = --tile: each GOP's frames in S "
                        "row shards over S ranks); rank r runs on cuda:(r "
                        "%% cards), over NCCL when every rank has a card, "
                        "else over gloo")
    e.add_argument("--multiprocess", type=int, default=0,
                   help="N ranks, each encoding a contiguous share of the "
                        "full GOPs; this process encodes the rest")
    e.add_argument("--failover", action="store_true",
                   help="per-GOP retry and a survivor engine (the next card, "
                        "else this one); with --devices/--tile a failed "
                        "batch or rank is re-encoded on the survivor. "
                        "TVC_FAULT_GOPS=i,j injects faults for testing")
    e.add_argument("--two-pass", action="store_true",
                   help="GOP-level two-pass rate allocation toward --kbps "
                        "(constant qp within a GOP)")
    e.add_argument("--engine", choices=["gop", "device", "golden"],
                   default="gop",
                   help="gop: GOP-resident on --device; device: per-frame "
                        "on --device (format 1; rc none|adaptive|bitrate|"
                        "vbv); golden: the numpy golden model, per frame on "
                        "the host's CPU (every format, search and rc mode; "
                        "slow)")
    e.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="save the encode's state after every GOP and "
                        "resume from PATH if it exists (single pass, no "
                        "--gop-batch/--tile)")
    e.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the encode, with "
                        "the program's spans, into DIR")
    e.add_argument("--stage-timers", action="store_true",
                   help="add the host stages' wall times, and the program's "
                        "spans and counters, to the summary")
    e.add_argument("--device", default="cuda",
                   help="torch device to encode on (cuda, cuda:N or cpu)")
    e.add_argument("-v", "--verbose", action="store_true",
                   help="per-frame stats on stderr (with --checkpoint, one "
                        "JSON event per GOP)")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="TVC1 -> raw YUV")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--engine", choices=["native", "gop", "device", "golden"],
                   default="native",
                   help="native: C++ decode on the host (the golden model "
                        "where the library cannot be loaded); gop: "
                        "GOP-resident recon on --device; device: per-frame "
                        "recon on --device; golden: the numpy golden model "
                        "on the host (slow)")
    d.add_argument("--workers", type=int, default=0,
                   help="native: GOP-parallel decode threads (0 = one per "
                        "core up to the GOP count, 1 = serial); at most "
                        "N + 1 GOPs are read and not yet written")
    d.add_argument("--device", default="cuda",
                   help="torch device of --engine gop|device (cuda, cuda:N "
                        "or cpu)")
    d.set_defaults(fn=cmd_decode)

    inf = sub.add_parser("info", help="dump stream header")
    inf.add_argument("-i", "--input", required=True)
    inf.set_defaults(fn=cmd_info)

    p = sub.add_parser("psnr", help="PSNR between two raw YUV files")
    p.add_argument("-a", required=True)
    p.add_argument("-b", required=True)
    _add_dims(p)
    p.set_defaults(fn=cmd_psnr)

    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except (ValueError, FileNotFoundError, OSError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
