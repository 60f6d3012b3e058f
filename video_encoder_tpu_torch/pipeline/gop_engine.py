"""GOP-resident encoder on one device: the port's production path.

Twin of `video_encoder_tpu/pipeline/gop_engine.py` for full and diamond
search, formats 1 to 4 (chroma qp offset, quant matrix, intra slices,
half-pel vectors), every rc mode (none, adaptive, bitrate, vbv, mb) and
both emits (frame and chunks). A Python loop over the GOP's frames
(`GopEngine._run`) replaces `lax.scan`; the reconstruction, the frame qp
and the vbv fullness stay on the device as the next frame's reference and
rate-control carry, and the kernels launch asynchronously on the current
stream. The host waits once per GOP, for the overflow flag: payload
capacity is budgeted, and a GOP whose pack overflows any budget is
encoded again at the exact worst-case capacities (the bytes are the same
either way, SPEC.md §11 invariant 2).

On CUDA that loop is captured as one CUDA graph per key (`GopGraph`), the
counterpart of the reference's one jitted XLA program per GOP
(`encode_gop_jit`): the key is the jit's static arguments, the input
shapes and the routes read at each call (`TVC_SEA`, `dispatch.force`).
The first call of a key runs the loop eagerly (the warm-up: the kernel
library, its function attributes and the device tables are made there,
outside any capture); the second captures it on static input buffers;
every call from then on copies its planes and base qps into those
buffers, replays the graph and copies the outputs out into tensors of
its own, all on the caller's current stream. A capture that fails
raises; nothing falls back to the eager loop. The eager loop runs on the
CPU, for a key's first call, and for a hop given as a function (the
temporal ring over ranks, parallel/ring.py, whose hop is a collective); a
hop given by name ("roll", `roll_hop`: the ring on one device) joins the
key and is captured with the loop. The key -> first-call-eager -> capture ->
replay logic is `GraphCache`, which the tile loop
(parallel/gop_parallel.py `ShardedGopEncoder`, on its GopEngine's cache),
the 2-D tile grid (parallel/tiles.py `encode_gop_tiled2d`, a cache per
device of its own), the per-frame engine (pipeline/device_engine.py
`DeviceEngine`) and the two device decoders (pipeline/decoder.py
`GopDecodeEngine`, `DeviceDecodeEngine`, with no qp input) use too.

The batched path (`run_batch`; twin of
`encode_gop_batch_jit`) encodes G GOPs of equal length in lockstep: the
same loop over frames, every tensor with a G axis before its plane axes
([G, H, W] planes, [G] qp and fullness), so that each kernel launches
once for G frames. The I/P decision is the loop index; the host waits
once per batch, and any frame's overflow reruns the whole batch. The
packets are byte-identical to G single-GOP encodes.

The host side of an encode of 1 to G GOPs is `GopEngine.start`, which
returns a `Launch`, and `GopEngine.finish`: the one wait (`overflowed`),
the worst-case rerun, the download, the packets. The tile encoder
(parallel/gop_parallel.py) makes a `Launch` of its own.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from collections.abc import Callable

import numpy as np
import torch

from ..codec import entropy, spec, tables
from ..codec.bitstream import FramePacket
from ..codec.config import EncoderConfig
from ..codec.frame import Frame
from ..codec.mux import bit_concat
from ..ops import dispatch, motion
from ..ops import transform as tx
from ..ops.kernels import build
from ..ops.kernels import sad as ksad
from ..utils.metrics import FrameStats
from ..utils.trace import RECORDER


def block_words_for_qp(qp: int) -> int:
    """Per-8x8-block word budget; finer quantizers keep more coefficients.
    An overflow re-encodes the GOP at the exact worst case."""
    if qp >= 28:
        return 16
    if qp >= 20:
        return entropy.BLOCK_WORDS_DEFAULT
    if qp >= 14:
        return 48
    return entropy.BLOCK_WORDS_MAX


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(pass device='cpu' to run the plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def mb_rc_offsets(est: torch.Tensor) -> torch.Tensor:
    """rc=mb per-MB qp offsets (SPEC.md §10.4) from pass-1 per-MB bits
    [..., nby, nbx]: the integer program of spec.mb_rc_offsets, in int64,
    with floor division and the arithmetic >> 7 (floor by 128 for either
    sign). Returns int32 in [-2, 2]."""
    est = est.long()
    nbx = est.shape[-1]
    row_tot = est.sum(-1, keepdim=True).clamp(min=1)
    share = torch.div(est * 1024, row_tot, rounding_mode="floor")
    spent = torch.cumsum(share, -1) - share
    plan = torch.div(torch.arange(nbx, device=est.device) * 1024, nbx,
                     rounding_mode="floor")
    return ((spent - plan) >> 7).clamp(-2, 2).int()


def rc_carry_step(rc: str, target_bits: int, vbv_bits: int,
                  qp: torch.Tensor, fullness: torch.Tensor,
                  bits: torch.Tensor):
    """Frame-level rate-control carry (SPEC.md §10): the next frame's qp
    and vbv fullness from this frame's payload bits, on the device (0-dim
    tensors or, elementwise, [G] vectors; int32 qp and int64 fullness),
    so the GOP loop never waits on the host. rc=bitrate and rc=mb share
    the proportional term; rc=vbv is spec.vbv_next, adding the
    buffer-pressure term. All in int64: (bits - target) * 4 passes int32
    at high rates."""
    if rc not in ("bitrate", "mb", "vbv") or target_bits <= 0:
        return qp, fullness
    bits = bits.long()
    delta = torch.div((bits - target_bits) * 4, target_bits,
                      rounding_mode="floor").clamp(-2, 2)
    if rc == "vbv":
        fullness = (fullness + target_bits - bits).clamp(0, vbv_bits)
        delta = (delta + (fullness < vbv_bits // 4).long()
                 - (fullness > (3 * vbv_bits) // 4).long())
    return (qp + delta).clamp(tables.QP_MIN, tables.QP_MAX).int(), fullness


def predict_p_traced(cur_y, ref_y, ref_cb, ref_cr, icost, search: str,
                     fmt: int = 1):
    """P-frame prediction: motion search (full or diamond, plus the
    half-pel refine of format 4), mode decision (sad <= intra cost), and
    the three predictors in one MC launch (dispatch.mc_predict; intra MBs
    predict flat 128). Returns (dy, dx, is_inter, pred_y, pred_cb,
    pred_cr); for fmt >= 4 the vectors are in half-pels (SPEC.md §14),
    the chroma vector dy >> 1 in chroma half-pels, and MC reads the
    parity planes the refine searched. Planes [H, W] or, for G GOPs,
    [G, H, W]."""
    search_fn = {"full": dispatch.full_search,
                 "diamond": dispatch.diamond_search}[search]
    dy, dx, best_sad = search_fn(cur_y, ref_y)
    if fmt >= 4:
        refs = tuple(motion.hpel_stack(p) for p in (ref_y, ref_cb, ref_cr))
        dy, dx, best_sad = dispatch.hpel_refine(cur_y, ref_y, dy, dx, refs[0])
    else:
        refs = tuple(p.unsqueeze(-3) for p in (ref_y, ref_cb, ref_cr))
    is_inter = best_sad <= icost
    return (dy, dx, is_inter, *dispatch.mc_predict(refs, dy, dx, is_inter))


def predict_i_traced(cur_y, cur_cb, cur_cr):
    """I-frame 'prediction': flat 128 planes, zero vectors, all intra."""
    *lead, h, w = cur_y.shape
    z = torch.zeros((*lead, h // tables.MB, w // tables.MB),
                    dtype=torch.int32, device=cur_y.device)
    return (z, z.clone(), z.bool(), torch.full_like(cur_y, 128),
            torch.full_like(cur_cb, 128), torch.full_like(cur_cr, 128))


def _sse(a, b):
    """Sum of squared differences over the plane axes, int64 [...]."""
    d = (a - b).long()
    return (d * d).sum((-2, -1))


def _plane_qsteps(qp_mb, cqpo: int):
    """Per-8x8-block quantizer steps of the three planes from per-MB qps:
    luma on its [2 nby, 2 nbx] grid, chroma at clip(qp + cqpo) (SPEC.md
    §12.2; cqpo 0 is format 1's)."""
    qs = tx.qstep(qp_mb)
    qy = qs.repeat_interleave(2, -2).repeat_interleave(2, -1).contiguous()
    qc = qs if cqpo == 0 else tx.qstep(
        (qp_mb + cqpo).clamp(tables.QP_MIN, tables.QP_MAX))
    return qy, qc.contiguous(), qc.contiguous()


def _code_frame(cur, pred, qp_mb, cqpo: int = 0, qbias: int = 8,
                qmat: bool = False):
    """Transform/quant/recon of the three planes at per-MB qps:
    ((levels_y8, levels_cb, levels_cr), (rec_y, rec_cb, rec_cr))."""
    coded = [dispatch.code_plane(c, p, q, qbias, qmat)
             for c, p, q in zip(cur, pred, _plane_qsteps(qp_mb, cqpo))]
    return tuple(lv for lv, _ in coded), tuple(rec for _, rec in coded)


def _code_intra3(cur, qp_mb, cqpo: int, qbias: int, qmat: bool, islice: int):
    """I frame of format >= 3 (SPEC.md §13.1): the vertical-intra row scan
    of each plane; the predictor resets every islice MB rows (2 * islice
    luma block rows, islice chroma block rows; 0 = never)."""
    coded = [dispatch.intra_rows_code_plane(c, q, qbias, reset, qmat)
             for c, q, reset in zip(cur, _plane_qsteps(qp_mb, cqpo),
                                    (2 * islice, islice, islice))]
    return tuple(lv for lv, _ in coded), tuple(rec for _, rec in coded)


def code_pack_traced(cur, pred, dy, dx, is_inter, is_p: bool,
                     qp: torch.Tensor, icost=None, *, rc: str, emit: str,
                     block_words: int, cap_words: int, fmt: int = 1,
                     cqpo: int = 0, qbias: int = 8, qmat: bool = False,
                     islice: int = 0):
    """Transform/quant/recon of the three planes and the entropy pack at
    the frame qp (a 0-dim int32 device tensor). rc="adaptive" sets per-MB
    qps from the intra cost icost; rc="mb" first codes the frame at the
    flat qp for its per-MB bit counts only, whose row pace offsets set
    the per-MB qps of the real pass (SPEC.md §10.4); headers code qp_mb -
    qp. From format 2 on chroma quantizes at qp + cqpo; I frames of
    format >= 3 go through the row scan in place of the flat-128
    prediction. emit="frame" assembles the payload (words [cap_words]);
    emit="chunks" stops at span strings (words [C, cw], cbits [C]).
    Returns a dict of device tensors: words, (cbits,) bits, ovf, n_inter,
    rec (three planes) and sse [3] int64.

    For G GOPs in lockstep every plane and MB array leads with G, qp is
    [G], and so do the results (words [G, ...], bits, n_inter [G], sse
    [G, 3]); ovf stays one flag, set by any frame of the batch."""
    nby, nbx = dy.shape[-2:]
    cqpo = cqpo if fmt >= 2 else 0
    qp_mbs = qp[..., None, None]          # [(G,) 1, 1] against MB grids

    def code(qps):
        if fmt >= 3 and not is_p:
            return _code_intra3(cur, qps, cqpo, qbias, qmat, islice)
        return _code_frame(cur, pred, qps, cqpo, qbias, qmat)

    flat = qp_mbs.expand(*qp.shape, nby, nbx)
    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(qp, icost)
    elif rc == "mb":
        levels, _ = code(flat)
        est = entropy.frame_mb_bits(*levels, flat - qp_mbs, is_p, is_inter,
                                    dy, dx, block_words, fmt)
        qp_mb = (qp_mbs + mb_rc_offsets(est)).clamp(tables.QP_MIN,
                                                    tables.QP_MAX)
    else:
        qp_mb = flat
    levels, rec = code(qp_mb)
    args = (*levels, qp_mb - qp_mbs, is_p, is_inter, dy, dx, block_words)
    if emit == "chunks":
        words, cbits, _, ovf = entropy.pack_frame_chunks(*args, fmt=fmt)
        out = dict(words=words, cbits=cbits,
                   bits=cbits.sum(-1, dtype=torch.int64))
    else:
        words, bits, _, ovf = entropy.pack_frame_planes(*args, cap_words,
                                                        fmt=fmt)
        out = dict(words=words, bits=bits)
    out.update(ovf=ovf, n_inter=is_inter.sum((-2, -1)), rec=rec,
               sse=torch.stack([_sse(c, r) for c, r in zip(cur, rec)], -1))
    return out


# what a captured GOP loop bakes in (GopEngine.graph_key)
GraphKey = collections.namedtuple(
    "GraphKey", "search rc block_words cap_words target_bits fmt cqpo qbias "
    "vbv_bits qmat islice emit y_shape c_shape sea force hop")


def roll_hop(carry):
    """The temporal ring's hop on one device, which _run takes by the name
    "roll": each column's carry moves to the next column (d -> d + 1 mod
    D), a roll of the leading axis (the reference's ppermute over the
    'ring' axis). Device ops only, so a capture takes it."""
    return tuple(torch.roll(t, 1, 0) for t in carry)


# the devices whose loops run as graphs (a test may add "cpu" beside a fake
# _capture); read at every call
_GRAPH_DEVICE_TYPES = ("cuda",)


def _pool_bytes(pool) -> int:
    """The bytes the caching allocator has reserved in the private memory
    pool `pool` (a graph's pool id), by its own accounting: the sizes of
    the segments of that pool in its snapshot. (torch.cuda.memory_stats
    counts every pool of the device together.)"""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _capture(body, pool):
    """(graph, outputs) of body() captured as one CUDA graph on a side
    stream, sharing the memory pool `pool` (None: a pool of its own).
    Raises where the capture fails: a host sync or a pageable copy inside
    body, or a CUDA call from another thread while it runs. The one seam
    between the engines and torch.cuda.CUDAGraph."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outs = body()
    return graph, outs


# the devices whose downloads stage the words in pinned host memory (a test
# may add "cpu" beside a fake _pinned); read at every download
_STAGING_DEVICE_TYPES = ("cuda",)


def _pinned(n: int, dtype) -> torch.Tensor:
    """n elements of page-locked host memory, cacheable (torch's pinned
    allocator: cudaHostAlloc with the default flags, not write-combined,
    so numpy reads it at the host's memory rate). A device-to-host copy
    lands there by DMA at the link's rate; into pageable memory CUDA
    stages it through a bounce buffer of its own. The one seam
    between the download and pinned memory."""
    return torch.empty(n, dtype=dtype, pin_memory=True)


def _clone(v):
    """A graph output copied out: a tensor, or a tuple of them."""
    return tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()


class GopGraph:
    """One body captured once and replayed: the static inputs the graph
    reads (tensors, and the base qp as a 0-dim or [G] int32 buffer, or no
    qp where qp_shape is None: a body whose every input is a tensor), the
    static outputs it writes (a dict of tensors or tuples of them), and
    the launch counts of `build.LAUNCHES` recorded while it was captured
    (the wrappers count where they launch, which under capture is once; a
    replay adds them). `replays` counts its replays; `capture_ns` and
    `capture_s` are its capture's host time."""

    def __init__(self, body, inputs, qp_shape, pool):
        # zero-filled, not empty: a capture through the test seam runs the
        # body on them, and a decoder's vectors must index inside a plane
        self.inputs = tuple(torch.zeros_like(p) for p in inputs)
        self.qp = None if qp_shape is None else torch.zeros(
            qp_shape, dtype=torch.int32, device=inputs[0].device)
        args = self.inputs if self.qp is None else (*self.inputs, self.qp)
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter_ns()
        try:
            with RECORDER.span("engine.capture"):
                self.graph, self.outs = _capture(lambda: body(*args), pool)
        finally:
            self.launches = {k: v - before[k]
                             for k, v in build.LAUNCHES.items()
                             if v != before[k]}
            build.LAUNCHES.update(before)
        self.capture_ns = time.perf_counter_ns() - t0
        self.capture_s = self.capture_ns / 1e9
        self.replays = 0
        self.pool_bytes = None     # set by GraphCache on CUDA
        RECORDER.count("engine.captures")
        RECORDER.count("engine.capture_ns", self.capture_ns)

    def __call__(self, inputs, qps):
        """Replay on the current stream: inputs copied in, outputs copied
        out into fresh tensors before anything can replay again, so that
        a call in flight keeps its own outputs."""
        with RECORDER.span("engine.copy_in"):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            if self.qp is not None and self.qp.ndim == 0:
                self.qp.fill_(qps)
            elif self.qp is not None:
                for g, q in enumerate(qps):
                    self.qp[g].fill_(q)
        with RECORDER.span("engine.replay"):
            self.graph.replay()
        self.replays += 1
        RECORDER.count("engine.replays")
        for k, v in self.launches.items():
            build.LAUNCHES[k] += v
        with RECORDER.span("engine.copy_out"):
            return {k: _clone(v) for k, v in self.outs.items()}


class GraphCache:
    """The graphs of one engine, one per key: `graphs` maps a key to its
    GopGraph, or to None after the key's first call, which runs eagerly
    (the warm-up: the kernel library, its function attributes and the
    device tables are made there, outside any capture); the second call
    captures, every later one replays. The graphs share one memory pool,
    safe only while no two replay at once, and replay on one stream: the
    merges' overflow ticket is one per device (csrc/span_merge.cu), so a
    call from another stream raises. Engines that run on one device share
    a cache (ShardedGopEncoder and its GopEngine). Each decoder engine
    has a cache of its own (pipeline/decoder.py), so an encoder's graphs
    and a decoder's never share a pool: graphs that share one must not
    replay at once. So do the temporal ring's engine (parallel/ring.py,
    a GopEngine of its own under frame emit) and the 2-D tile grid
    (parallel/tiles.py, one cache per device): neither runs a span merge,
    so neither touches the merges' ticket. A capture that fails raises;
    nothing falls back to the eager call.

    Each call records into utils.trace.RECORDER: an eager call the span
    `engine.eager` and the count `engine.eager_calls`, a key's eager first
    call its host time in `engine.capture_ns`; a capture the span
    `engine.capture` and `engine.captures`, `engine.capture_ns`, and on
    CUDA the change of the pool's reserved bytes in
    `engine.graph_pool_bytes` (so its total is the pool's size); a replay
    the span `engine.launch` (GopGraph's copies in, replay and copies out
    within it) and `engine.replays`. stats() gives them per key."""

    def __init__(self, owner: str):
        self.owner = owner
        self.graphs: dict = {}
        self.eager_ns: dict = {}   # key -> its eager first call's host ns
        self.pool = None       # the memory pool the graphs share
        self.pool_bytes = 0    # its reserved bytes after the last capture
        self.stream = None     # the stream the graphs replay on

    def launch(self, key, body, inputs, qps=None):
        """body(*inputs, qp) on the inputs' device, qp the int32 device
        tensor of qps (an int: 0-dim; a list: [G]), or body(*inputs)
        where qps is None (the decoders: every input a tensor). Eager
        where the device runs no graphs, where key is None (a caller whose
        body a capture cannot take: collectives over ranks), and at a
        key's first call; else the key's graph. Returns body's outputs,
        or a replay's copies of them."""
        dev = inputs[0].device
        if dev.type not in _GRAPH_DEVICE_TYPES:
            key = None
        if key is None or key not in self.graphs:
            if key is not None:
                self.graphs[key] = None
            t0 = time.perf_counter_ns()
            with RECORDER.span("engine.eager"):
                if qps is None:
                    out = body(*inputs)
                else:
                    qp = (torch.full((), qps, dtype=torch.int32, device=dev)
                          if isinstance(qps, int)
                          else torch.tensor(qps, dtype=torch.int32).to(dev))
                    out = body(*inputs, qp)
            RECORDER.count("engine.eager_calls")
            if key is not None:
                self.eager_ns[key] = time.perf_counter_ns() - t0
                RECORDER.count("engine.capture_ns", self.eager_ns[key])
            return out
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        if self.stream is None:
            self.stream = stream
        elif stream != self.stream:
            raise RuntimeError(
                f"{self.owner}: its graphs replay on one stream (the merges' "
                "overflow ticket is one per device); this call is on another")
        graph = self.graphs[key]
        if graph is None:
            graph = self.graphs[key] = GopGraph(
                body, inputs, None if qps is None
                else () if isinstance(qps, int) else (len(qps),), self.pool)
            if self.pool is None:
                self.pool = graph.graph.pool()
            if dev.type == "cuda":
                graph.pool_bytes = _pool_bytes(self.pool)
                RECORDER.count("engine.graph_pool_bytes",
                               graph.pool_bytes - self.pool_bytes)
                self.pool_bytes = graph.pool_bytes
        with RECORDER.span("engine.launch"):
            return graph(inputs, qps)

    def stats(self) -> dict:
        """Per key: its eager first call (`eager_calls` 1, `eager_ns` its
        host time), its capture (`captures` 0 or 1, `capture_ns`), its
        `replays`, the kernel launches each replay makes (`launches`, the
        counts of build.LAUNCHES captured with it, which a replay adds) and,
        on CUDA, the pool's reserved bytes after its capture
        (`pool_bytes`)."""
        out = {}
        for key, graph in self.graphs.items():
            s = dict(eager_calls=1, eager_ns=self.eager_ns.get(key),
                     captures=0, capture_ns=None, replays=0, launches={},
                     pool_bytes=None)
            if graph is not None:
                s.update(captures=1, capture_ns=graph.capture_ns,
                         replays=graph.replays, launches=dict(graph.launches),
                         pool_bytes=graph.pool_bytes)
            out[key] = s
        return out


def overflowed(ovf: torch.Tensor, group_max=None) -> bool:
    """An encode's one wait on the device: is any overflow flag set? Over
    a process group, group_max (parallel/mesh.py `group_max`) takes the
    flag to the group's maximum, so that every rank of it decides the
    same and they rerun together."""
    flag = ovf.any()
    if group_max is not None:
        flag = group_max(flag.to(torch.int32))
    return bool(flag)


@dataclasses.dataclass
class Launch:
    """A started encode of 1 to G equal-length GOPs, all GopEngine.finish
    needs: the device planes ([T, H, W] for one GOP on the engine, else
    [T, G, H, W]) and the base qps as `run` takes them, the launch's
    outputs; run(y, cb, cr, qps, xl=True) reruns at the worst case,
    fetch(outs) gives the host arrays (None on a rank that returns no
    packets), group_max is `overflowed`'s over a process group."""

    gops: list
    first_indices: list
    y: torch.Tensor
    cb: torch.Tensor
    cr: torch.Tensor
    qps: int | list
    outs: dict
    t0: float
    run: Callable
    fetch: Callable
    group_max: Callable | None = None


class GopEngine:
    """Host driver of the GOP-resident path on one device.

    encode_gop(frames, first_index) -> (packets, stats);
    finish(start(gops, first_indices, base_qps)) -> one such pair per GOP,
    from one encode of G >= 1 equal-length GOPs. `device` is
    explicit and defaults to "cuda"; nothing moves to the CPU on its own.
    `emit` is "frame" (the device assembles each payload) or "chunks"
    (span strings glued on the host); both give the same bytes. The
    default is the one measured faster on the card (PERF.md).

    On CUDA, `run` and `run_batch` (with no hop, or a hop by name) replay
    one CUDA graph per `graph_key` from a key's second call on (the module
    docstring); `graphs` holds them, and they go with the engine. They
    live in its GraphCache, `cache`: replays run on the current stream,
    which must stay the one of the first replay, and share one memory
    pool.
    """

    emit = "frame"

    def __init__(self, cfg: EncoderConfig, device="cuda",
                 emit: str | None = None):
        if cfg.search not in ("full", "diamond"):
            raise ValueError(
                f"search={cfg.search!r} is not a device-engine mode (full, "
                "diamond); hier is golden/oracle-only")
        if cfg.gop_devices != 1 or cfg.tile_devices != 1:
            raise NotImplementedError(
                "GopEngine encodes on one device; an encode over several "
                "devices is parallel.gop_parallel.ShardedGopEncoder on a "
                "CodecMesh, over ranks or on one device (ROADMAP.md A13b)")
        if emit not in (None, "frame", "chunks"):
            raise ValueError(f"unknown emit {emit!r} (frame, chunks)")
        self.cfg = cfg
        self.emit = emit or self.emit
        self.device = resolve_device(device)
        self.cache = GraphCache("GopEngine")
        # graph_key -> its GopGraph, or None after the key's eager first
        # call; a ShardedGopEncoder over this engine adds its TileKeys
        self.graphs: dict[GraphKey, GopGraph | None] = self.cache.graphs
        # the most words a budgeted (not xl) launch has returned, and the
        # pinned host buffer the downloads of such words land in
        self._budget_words = 0
        self._staging: torch.Tensor | None = None

    def budgeted(self, outs, xl: bool):
        """outs as given; the words of a launch without xl raise the most
        words that `download` stages (`_budget_words`). Called by every
        launch whose outputs reach download: run, run_batch and
        ShardedGopEncoder.run."""
        if not xl:
            self._budget_words = max(self._budget_words,
                                     outs["words"].numel())
        return outs

    def _capacities(self, n_mbs: int, base_qp: int, xl: bool):
        """(block words, frame capacity words): budgeted for base_qp, or
        with xl the exact worst case."""
        if xl:
            return entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs)
        return block_words_for_qp(base_qp), entropy.capacity_words(n_mbs)

    def _run(self, y, cb, cr, qp, bw: int, cap: int, hop=None):
        """The loop over a GOP's frames: y [T, H, W] with a 0-dim qp, or
        for G GOPs in lockstep y [T, G, H, W] with qp [G]. Launches only,
        no host wait; the frame qp and the vbv fullness are device
        tensors carried from frame to frame, and each frame's results go
        into [T, ...] tensors made at the first frame's shapes. hop, if
        given, maps each step's carry (the three recon planes, qp,
        fullness) to the next step's: the temporal ring's shift
        (parallel/ring.py): "roll" (roll_hop) or a function. The body that
        a GopGraph captures."""
        cfg = self.cfg
        hop = roll_hop if hop == "roll" else hop
        target_bits, vbv_bits = cfg.target_bits_per_frame(), cfg.vbv_bits()
        fullness = torch.full_like(qp, spec.vbv_init(vbv_bits),
                                   dtype=torch.int64)
        keys = ["words", "bits", "ovf", "n_inter", "qp", "sse"]
        if self.emit == "chunks":
            keys.append("cbits")
        if cfg.format_version >= 4:
            keys.append("n_hpel")
        n = y.shape[0]
        ref = res = None
        for t in range(n):
            cur = (y[t].to(torch.int32), cb[t].to(torch.int32),
                   cr[t].to(torch.int32))
            icost = None
            if ref is not None or cfg.rc == "adaptive":
                _, icost = motion.intra_cost_and_dc(cur[0])
            if ref is None:
                pred = predict_i_traced(*cur)
            else:
                pred = predict_p_traced(cur[0], *ref, icost, cfg.search,
                                        cfg.format_version)
            dy, dx, is_inter = pred[:3]
            out = code_pack_traced(
                cur, pred[3:], dy, dx, is_inter, t > 0, qp, icost, rc=cfg.rc,
                emit=self.emit, block_words=bw, cap_words=cap,
                fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
                qbias=cfg.quant_bias, qmat=cfg.quant_matrix,
                islice=cfg.intra_slice_mbrows,
            )
            out["qp"] = qp
            if "n_hpel" in keys:     # inter MBs on a half-pel vector
                out["n_hpel"] = (is_inter & (((dy | dx) & 1) != 0)).sum(
                    (-2, -1))
            if res is None:
                res = {k: out[k].new_empty((n, *out[k].shape)) for k in keys}
            for k in keys:
                res[k][t] = out[k]
            qp, fullness = rc_carry_step(cfg.rc, target_bits, vbv_bits, qp,
                                         fullness, out["bits"])
            ref = out["rec"]
            if hop is not None:
                *ref, qp, fullness = hop((*ref, qp, fullness))
        return res

    def graph_key(self, y_shape, c_shape, bw: int, cap: int,
                  hop: str | None = None) -> GraphKey:
        """The key of a GOP's graph: the reference's static arguments of
        encode_gop(_batch)_jit (search, rc, block_words, cap_words,
        target_bits, fmt, cqpo, qbias, vbv_bits, qmat, islice, emit), the
        luma and chroma shapes ([T, H, W], or [T, G, H, W] in lockstep),
        the routes that the wrappers read at every call and a capture
        bakes in (TVC_SEA and dispatch.force), and the hop's name (None
        for a plain batch; "roll" for the ring on one device, the
        counterpart of encode_ring_jit). The base qp is an input."""
        cfg = self.cfg
        return GraphKey(cfg.search, cfg.rc, bw, cap, cfg.target_bits_per_frame(),
                        cfg.format_version, cfg.chroma_qp_offset,
                        cfg.quant_bias, cfg.vbv_bits(), cfg.quant_matrix,
                        cfg.intra_slice_mbrows, self.emit, tuple(y_shape),
                        tuple(c_shape), ksad._sea_enabled(), dispatch._FORCE,
                        hop)

    def _launch(self, y, cb, cr, qps, bw: int, cap: int, hop=None):
        """The GOP loop on y's device through the engine's GraphCache:
        eager on the CPU, for a key's first call and for a hop given as a
        function (no key), else the key's graph (captured at its second
        call). qps: the base qp (int) or the G base qps (list)."""
        key = None if callable(hop) else self.graph_key(y.shape, cb.shape,
                                                         bw, cap, hop)
        return self.cache.launch(
            key, lambda *planes_qp: self._run(*planes_qp, bw, cap, hop),
            (y, cb, cr), qps)

    def run(self, y, cb, cr, base_qp: int, xl: bool = False):
        """Encode one GOP of [T, H, W] / [T, H/2, W/2] uint8 planes already
        on the engine's device; launches only, no host wait. xl selects the
        worst-case block and frame capacities. Returns [T, ...] per-frame
        device tensors of the call's own: words, bits, ovf, n_inter, qp,
        sse, cbits [T, C] under chunk emit, and from format 4 on n_hpel
        (the inter MBs whose vector has an odd component). A call with xl
        is counted in RECORDER's `engine.overflow_reruns`."""
        n_mbs = (y.shape[-2] // tables.MB) * (y.shape[-1] // tables.MB)
        if xl:
            RECORDER.count("engine.overflow_reruns")
        return self.budgeted(self._launch(
            y, cb, cr, int(base_qp), *self._capacities(n_mbs, base_qp, xl)),
            xl)

    def run_batch(self, y, cb, cr, base_qps, xl: bool = False, hop=None):
        """Encode G GOPs of T frames in lockstep: [T, G, H, W] /
        [T, G, H/2, W/2] uint8 planes on the engine's device (the frame
        axis leads, so each step's [G, H, W] planes are contiguous), one
        base qp per GOP. The block budget is that of the smallest qp of
        the batch. Returns run()'s tensors with the axes [T, G, ...]; ovf
        stays [T], a frame step's flag being any GOP's. hop: as _run's;
        "roll" joins the key and is replayed with the loop, a function (a
        collective over ranks, which a capture cannot take) runs eagerly
        at every call. A call with xl is counted as run()'s."""
        n_mbs = (y.shape[-2] // tables.MB) * (y.shape[-1] // tables.MB)
        if xl:
            RECORDER.count("engine.overflow_reruns")
        qps = [int(q) for q in base_qps]
        bw, cap = self._capacities(n_mbs, min(qps), xl)
        return self.budgeted(self._launch(y, cb, cr, qps, bw, cap, hop), xl)

    @staticmethod
    def _stack(planes, lead: tuple) -> np.ndarray:
        """uint8 host array [*lead, H, W] of equal-shaped planes given in
        row-major order of `lead`; one pass over them."""
        out = np.empty((len(planes), *planes[0].shape), np.uint8)
        for i, p in enumerate(planes):
            out[i] = p
        return out.reshape(*lead, *planes[0].shape)

    def upload(self, planes, lead: tuple) -> list[torch.Tensor]:
        """The y, cb and cr uint8 device tensors [*lead, H, W] of an
        upload, planes(name) listing the equal-shaped planes of y, cb or
        cr in row-major order of `lead`, in RECORDER's span
        `engine.upload`: the numpy assembly, one pass over them
        (`engine.upload.stack`), then the pageable copies
        (`engine.upload.copy`). An upload that finds the stream still
        busy with earlier work, whose end a pageable copy waits for, is
        counted in `engine.upload_busy` (a query, not a wait)."""
        with RECORDER.span("engine.upload"):
            with RECORDER.span("engine.upload.stack"):
                host = [self._stack(planes(p), lead)
                        for p in ("y", "cb", "cr")]
            if (self.device.type == "cuda"
                    and not torch.cuda.current_stream(self.device).query()):
                RECORDER.count("engine.upload_busy")
            with RECORDER.span("engine.upload.copy"):
                return [torch.from_numpy(h).to(self.device) for h in host]

    def download(self, outs):
        """The host's copy of an encode's results, as numpy arrays with
        the device tensors' leading axes ([T] or [T, G]): bits, n_inter,
        qp, sse [..., 3], n_hpel where the encode gave it (format 4), under
        chunk emit cbits [..., C], and words (the device's int32, viewed
        as uint32) cut to the longest payload (frame emit) or span string
        (chunk emit).

        On the card the words of a budgeted launch (no more words than a
        launch of this engine without xl returned) land in a page-locked
        host buffer that the engine owns and reuses (`_staging`: made at
        the first such download, made again only when a later one needs
        more than it holds): one copy on the current stream, on which the
        engine's launches made outs, waited for before download returns.
        host["words"] is then a view of that buffer and stays valid until
        the engine's next download; the small columns are the caller's
        own. The CPU's words and a worst-case rerun's (xl: about 15 MB a
        1080p frame) keep the plain copy into memory of their own.

        In RECORDER's span `finish.copy`: the small columns' cat and copy
        (`finish.copy.meta`), the words' copy and view
        (`finish.copy.words`), the bytes of the two host arrays that the
        copies bring, counted in `finish.copy_bytes` (the same count on
        the CPU, where .cpu() copies nothing), and `finish.copy_staged`, 1
        where the words went through the buffer and 0 where not. Each
        making of the buffer counts its bytes in `finish.staging_bytes`.
        Where the encode gave n_hpel, the P frames' half-pel MBs and inter
        MBs are counted in `motion.hpel_mbs` and `motion.inter_mbs`."""
        chunked = "cbits" in outs
        hpel = "n_hpel" in outs
        with RECORDER.span("finish.copy"):
            with RECORDER.span("finish.copy.meta"):
                cols = [outs["bits"][..., None], outs["n_inter"][..., None],
                        outs["qp"][..., None], outs["sse"]]
                if hpel:
                    cols.append(outs["n_hpel"][..., None])
                if chunked:
                    cols.append(outs["cbits"])
                small = torch.cat(cols, -1).cpu().numpy()
            host = dict(bits=small[..., 0], n_inter=small[..., 1],
                        qp=small[..., 2], sse=small[..., 3:6], cbits=None)
            if hpel:
                host["n_hpel"] = small[..., 6]
                RECORDER.count("motion.hpel_mbs", int(host["n_hpel"][1:].sum()))
                RECORDER.count("motion.inter_mbs",
                               int(host["n_inter"][1:].sum()))
            if chunked:
                host["cbits"] = small[..., 6 + hpel:]
                maxw = max(int(host["cbits"].max() + 31) // 32, 1)
            else:
                maxw = int(host["bits"].max() + 31) // 32
            with RECORDER.span("finish.copy.words"):
                words = self._stage(outs["words"], maxw)
                staged = words is not None
                if not staged:
                    words = outs["words"][..., :maxw].cpu()
                host["words"] = words.numpy().view(np.uint32)
            RECORDER.count("finish.copy_staged", int(staged))
            RECORDER.count("finish.copy_bytes",
                           small.nbytes + host["words"].nbytes)
        return host

    def _stage(self, words, maxw: int):
        """words[..., :maxw] copied into the staging buffer, as a view of
        its first elements shaped [..., maxw], once the copy has landed;
        None where the words take the plain copy: off the card, or more
        words than a budgeted launch returned (the xl rerun's)."""
        if (words.device.type not in _STAGING_DEVICE_TYPES
                or words.numel() > self._budget_words):
            return None
        if self._staging is None or self._staging.numel() < words.numel():
            self._staging = None      # the old buffer goes before the new
            self._staging = _pinned(words.numel(), words.dtype)
            RECORDER.count("finish.staging_bytes",
                           self._staging.numel() * words.element_size())
        part = words[..., :maxw]
        dst = self._staging[:part.numel()].view(part.shape)
        dst.copy_(part, non_blocking=True)
        if words.is_cuda:
            torch.cuda.current_stream(words.device).synchronize()
        return dst

    @staticmethod
    def gop_packets(frames, first_index: int, host, ms_per_frame: float):
        """(packets, stats) of one GOP from its [T, ...] host arrays, in
        RECORDER's span `finish.packets`."""
        with RECORDER.span("finish.packets"):
            bits, cbits, words = host["bits"], host["cbits"], host["words"]
            n_mbs = ((frames[0].y.shape[0] // tables.MB)
                     * (frames[0].y.shape[1] // tables.MB))
            npix_y, npix_c = frames[0].y.size, frames[0].cb.size

            def psnr(s, n):
                return (10 * math.log10(255.0**2 * n / s) if s > 0
                        else math.inf)

            packets, stats = [], []
            for t in range(len(frames)):
                if cbits is not None:
                    payload, nbits = bit_concat(
                        [(words[t, c], int(b))
                         for c, b in enumerate(cbits[t]) if b])
                    if nbits != int(bits[t]):
                        raise RuntimeError(f"frame {first_index + t}: span "
                                           f"strings hold {nbits} bits, the "
                                           f"pack counted {int(bits[t])}")
                else:
                    nw = (int(bits[t]) + 31) // 32
                    payload = words[t, :nw].astype(">u4").tobytes()
                ftype = 0 if t == 0 else 1
                qp = int(host["qp"][t])
                n_inter = int(host["n_inter"][t])
                sse = host["sse"][t]
                packets.append(FramePacket(first_index + t, ftype, qp,
                                           int(bits[t]), payload))
                stats.append(FrameStats(
                    index=first_index + t, frame_type=ftype, base_qp=qp,
                    bits=int(bits[t]),
                    psnr_y=psnr(sse[0], npix_y),
                    psnr_cb=psnr(sse[1], npix_c),
                    psnr_cr=psnr(sse[2], npix_c),
                    ms=ms_per_frame,
                    n_intra_mb=n_mbs - n_inter if ftype else n_mbs,
                    n_inter_mb=n_inter if ftype else 0,
                ))
            return packets, stats

    def start(self, gops: list[list[Frame]], first_indices: list[int],
              base_qps: list[int] | None = None) -> Launch:
        """Upload G >= 1 equal-length GOPs and launch their encode without
        waiting for it: one GOP through `run` on [T, H, W] planes, several
        in lockstep through `run_batch` on [T, G, H, W] planes (the frame
        axis leads). base_qps: one per GOP, by default the config's."""
        n = len(gops[0])
        if any(len(g) != n for g in gops):
            raise ValueError("batched GOPs must be of equal length")
        if base_qps is None:
            base_qps = [self.cfg.base_qp] * len(gops)
        one = len(gops) == 1
        t0 = time.perf_counter()
        y, cb, cr = self.upload(
            lambda p: [getattr(g[t], p) for t in range(n) for g in gops],
            (n,) if one else (n, len(gops)))
        run, qps = ((self.run, base_qps[0]) if one
                    else (self.run_batch, list(base_qps)))
        return Launch(gops, first_indices, y, cb, cr, qps,
                      run(y, cb, cr, qps), t0, run, self.download)

    @staticmethod
    def finish(launch: Launch) -> list[tuple[list[FramePacket],
                                            list[FrameStats]]]:
        """(packets, stats) of each GOP of a started encode, in the order
        given to start: the encode's one wait on the device, for the
        overflow flag, and where it is set the rerun at the worst-case
        capacities (RECORDER's span `finish.wait`), then the download
        (`launch.fetch`) and each GOP's packets. [] where fetch gives no
        host arrays (a tile rank other than 0)."""
        outs = launch.outs
        with RECORDER.span("finish.wait"):
            if overflowed(outs["ovf"], launch.group_max):
                outs = launch.run(launch.y, launch.cb, launch.cr, launch.qps,
                                  xl=True)
        host = launch.fetch(outs)
        if host is None:
            return []
        ms = ((time.perf_counter() - launch.t0) * 1e3
              / sum(map(len, launch.gops)))

        def gop_host(gi):     # a lockstep encode's arrays are [T, G, ...]
            if launch.y.ndim == 3:
                return host
            return {k: v if v is None else v[:, gi] for k, v in host.items()}

        return [GopEngine.gop_packets(frames, first, gop_host(gi), ms)
                for gi, (frames, first)
                in enumerate(zip(launch.gops, launch.first_indices))]

    def encode_gop(self, frames: list[Frame], first_index: int,
                   base_qp: int | None = None):
        """Synchronous upload, encode and download of one GOP: (packets,
        stats)."""
        qps = None if base_qp is None else [base_qp]
        return self.finish(self.start([frames], [first_index], qps))[0]
