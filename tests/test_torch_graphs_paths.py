"""The tile loop and the per-frame engine as one captured CUDA graph per
key (`parallel/gop_parallel.py` ShardedGopEncoder.run,
`pipeline/device_engine.py` DeviceEngine.encode, both through
`pipeline/gop_engine.py` GraphCache): the port's counterparts of the
reference's jitted encode_gop_batch_2d / encode_gop_tiled and of its
jitted per-frame function.

On the CPU: each key changes with every static argument, with the
shapes and with TVC_SEA; a CPU encoder or engine, and a mesh over ranks,
build no graph; through the seam of tests/test_torch_graphs.py (a fake
`_capture` and "cpu" in `_GRAPH_DEVICE_TYPES`) two tile batches in flight
keep their own outputs, a tile overflow rerun reads its own planes, and
`build.LAUNCHES` rises per replay by the counts recorded at capture; the
tile loop with its [T, ...] outputs gives the reference's
encode_gop_tiled / encode_gop_batch_2d outputs, and a GOP through the
fake-graphed DeviceEngine the reference DeviceEngine's stream.

On the card (tests that take the `cuda` fixture skip without one):
replay equals the eager loop at S = 2 and 4, at G = 2 and at format 4
with intra slices of 17 MB rows; a forced worst-case rerun replays; the
CLI's `--gop 10 --tile 2` file equals `--device cpu`'s; `--engine
device` equals the C++ oracle's stream; a host sync in either body makes
the capture raise. The card host has no JAX: there run

    python -m pytest tests/test_torch_graphs_paths.py --noconftest -q

where the JAX comparisons skip. Tolerance 0: the codec is integer-only.
"""

import dataclasses
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.ops.kernels import build
from video_encoder_tpu_torch.parallel import mesh as dmesh
from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder
from video_encoder_tpu_torch.parallel.mesh import make_codec_mesh
from video_encoder_tpu_torch.pipeline import device_engine, gop_engine
from video_encoder_tpu_torch.pipeline.device_engine import DeviceEngine
from video_encoder_tpu_torch.pipeline.encoder import encode_clip
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda", 0)


def _clip(seed, w, h, n):
    """A texture smoothed four times, panning 2 px down and 3 px right
    per frame, a moving bright block, and moving chroma."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 4 * n + 8, w + 6 * n + 8)).astype(np.int64)
    for _ in range(4):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    big = big.astype(np.uint8)
    cbig = (96 + big // 4).astype(np.uint8)
    clip = []
    for t in range(n):
        y = big[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        y[(5 * t) % (h - 16):(5 * t) % (h - 16) + 16, 8:24] = 230
        clip.append((y, cbig[t:t + h // 2, 2 * t:2 * t + w // 2].copy(),
                     cbig[2 * t:2 * t + h // 2, t:t + w // 2][::-1].copy()))
    return clip


def _bw_noise(seed, w, h, n):
    """Black-and-white luma noise: at 128x128 its P frame overflows the
    16-word block budget at qp 28, so the batch reruns at the worst
    case."""
    rng = np.random.default_rng(seed)
    return [((rng.integers(0, 2, (h, w)) * 255).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _frames(clip):
    return [Frame.from_planes(*p) for p in clip]


def _bytes(packets):
    return [p.to_bytes() for p in packets]


def _planes(clip, device="cpu"):
    """[T, 1, H, W] uint8 planes of one GOP (the batch order of run)."""
    return tuple(torch.from_numpy(np.stack([p[i] for p in clip]))[:, None]
                 .to(device) for i in range(3))


def _counted(fn):
    """(fn(), the rise of build.LAUNCHES over the call)."""
    before = dict(build.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in build.LAUNCHES.items()
                 if v != before[k]}


def _eager_tiled(cfg, frames, n_tile=2, device="cpu"):
    """The packets of a fresh sharded encoder's first call: the eager
    tile loop (and its worst-case rerun's)."""
    senc = ShardedGopEncoder(cfg, make_codec_mesh(1, n_tile, device))
    return _bytes(senc.finish(senc.start([frames], [0]))[0][0])


# ---- (a) the keys --------------------------------------------------------

_TBASE = dict(width=64, height=64, gop_n=3, base_qp=28, search="full",
              rc="vbv", target_kbps=300, vbv_kbits=200, format_version=3,
              chroma_qp_offset=2, quant_bias=8, quant_matrix=False,
              intra_slice_mbrows=1)
_TY, _TC = (3, 1, 64, 64), (3, 1, 32, 32)


def _tile_key(cfg=None, s=2, g=1, y=_TY, c=_TC, bw=16, cap=100, emit=None):
    senc = ShardedGopEncoder(EncoderConfig(**{**_TBASE, **(cfg or {})}),
                             make_codec_mesh(g, s, "cpu"))
    if emit is not None:
        senc.emit = emit
    return senc.graph_key(y, c, bw, cap)


def _with_routes(change, monkeypatch, fn):
    """fn() under TVC_SEA=1 or dispatch.force("plain") as `change` says."""
    if change == "TVC_SEA":
        monkeypatch.setenv("TVC_SEA", "1")
        return fn()
    dispatch.force("plain")
    try:
        return fn()
    finally:
        dispatch.force(None)


@pytest.mark.parametrize("change", [
    "equal", "S", "G", "rc", "block_words", "cap_words", "target_bits",
    "fmt", "cqpo", "qbias", "vbv_bits", "qmat", "islice", "emit", "T", "H",
    "W", "TVC_SEA", "force"])
def test_tile_key_changes_with_each_static_argument(monkeypatch, change):
    """Equal inputs give equal keys; each argument encode_gop_batch_2d
    passes as static, S and G, each shape and both routes change it (a
    capture bakes every one of them in)."""
    monkeypatch.delenv("TVC_SEA", raising=False)
    base = _tile_key()
    other = {
        "equal": lambda: _tile_key(),
        "S": lambda: _tile_key(s=4),
        "G": lambda: _tile_key(g=2, y=(3, 2, 64, 64), c=(3, 2, 32, 32)),
        "rc": lambda: _tile_key(dict(rc="mb")),
        "block_words": lambda: _tile_key(bw=24),
        "cap_words": lambda: _tile_key(cap=101),
        "target_bits": lambda: _tile_key(dict(target_kbps=301)),
        "fmt": lambda: _tile_key(dict(format_version=4)),
        "cqpo": lambda: _tile_key(dict(chroma_qp_offset=3)),
        "qbias": lambda: _tile_key(dict(quant_bias=5)),
        "vbv_bits": lambda: _tile_key(dict(vbv_kbits=201)),
        "qmat": lambda: _tile_key(dict(quant_matrix=True)),
        "islice": lambda: _tile_key(dict(intra_slice_mbrows=2)),
        "emit": lambda: _tile_key(emit="frame"),
        "T": lambda: _tile_key(y=(4, 1, 64, 64), c=(4, 1, 32, 32)),
        "H": lambda: _tile_key(dict(height=96), y=(3, 1, 96, 64),
                               c=(3, 1, 48, 32)),
        "W": lambda: _tile_key(y=(3, 1, 64, 80), c=(3, 1, 32, 40)),
    }
    got = (_with_routes(change, monkeypatch, _tile_key)
           if change in ("TVC_SEA", "force") else other[change]())
    assert (got == base) == (change == "equal")
    assert got.ref_mode == "halo"


_FBASE = dict(width=64, height=48, gop_n=4, base_qp=28, search="full",
              rc="bitrate", target_kbps=300, quant_bias=8)


def _frame_key(cfg=None, is_p=True, n_words=200, y=(48, 64), c=(24, 32)):
    return DeviceEngine.key(EncoderConfig(**{**_FBASE, **(cfg or {})}),
                            is_p, n_words, y, c)


@pytest.mark.parametrize("change", [
    "equal", "is_p", "search", "rc", "n_words", "qbias", "H", "W",
    "TVC_SEA", "force"])
def test_frame_key_changes_with_each_argument(monkeypatch, change):
    """The per-frame engine's key: the reference's static arguments, the
    plane shapes and both routes; the base qp is not in it."""
    monkeypatch.delenv("TVC_SEA", raising=False)
    base = _frame_key()
    other = {
        "equal": lambda: _frame_key(dict(base_qp=20)),
        "is_p": lambda: _frame_key(is_p=False),
        "search": lambda: _frame_key(dict(search="diamond")),
        "rc": lambda: _frame_key(dict(rc="adaptive")),
        "n_words": lambda: _frame_key(n_words=201),
        "qbias": lambda: _frame_key(dict(quant_bias=5)),
        "H": lambda: _frame_key(y=(64, 64), c=(32, 32)),
        "W": lambda: _frame_key(y=(48, 80), c=(24, 40)),
    }
    got = (_with_routes(change, monkeypatch, _frame_key)
           if change in ("TVC_SEA", "force") else other[change]())
    assert (got == base) == (change == "equal")


# ---- (b) no graph on the CPU, none over ranks ----------------------------

def test_cpu_encoder_and_engine_never_build_a_graph(monkeypatch):
    def refuse(body, pool):
        raise AssertionError("a CPU path captured a graph")

    monkeypatch.setattr(gop_engine, "_capture", refuse)
    clip = _clip(1, 32, 64, 3)
    cfg = EncoderConfig(width=32, height=64, gop_n=3, base_qp=26)
    senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 2, "cpu"))
    first = senc.finish(senc.start([_frames(clip)], [0]))[0][0]
    for _ in range(2):
        assert _bytes(senc.finish(senc.start([_frames(clip)], [0]))[0][0]) == \
            _bytes(first)
    eng = DeviceEngine("cpu")
    for _ in range(2):
        encode_clip(cfg, clip, io.BytesIO(), 3, engine=eng)
    assert senc.cache.graphs == {} and eng.graphs == {}


# ---- (c) the seam: a fake graph on the CPU ------------------------------

class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: replay reruns the captured body
    and writes its results into the static outputs of the capture (a
    tensor, or a tuple of them), as a replay writes the same buffers; a
    replay runs no Python wrapper, so the launch counts it would move are
    put back."""

    def __init__(self, body, outs):
        self.body, self.outs, self.replays = body, outs, 0

    def replay(self):
        saved = dict(build.LAUNCHES)
        new = self.body()
        build.LAUNCHES.update(saved)
        for k, v in new.items():
            for dst, src in zip(*((self.outs[k], v) if isinstance(v, tuple)
                                  else ((self.outs[k],), (v,)))):
                dst.copy_(src)
        self.replays += 1

    def pool(self):
        return None


@pytest.fixture
def fake_graphs(monkeypatch):
    """Graphs on the CPU through the seam, and code_plane counted in
    build.LAUNCHES as its kernel wrapper counts it on the card."""
    made = []

    def capture(body, pool):
        outs = body()
        made.append(_FakeGraph(body, outs))
        return made[-1], outs

    plain = dispatch.code_plane

    def code_plane(*args):
        build.LAUNCHES["code_plane"] += 1
        return plain(*args)

    monkeypatch.setattr(gop_engine, "_capture", capture)
    monkeypatch.setattr(gop_engine, "_GRAPH_DEVICE_TYPES", ("cpu",))
    monkeypatch.setattr(dispatch, "code_plane", code_plane)
    return made


def test_mesh_over_ranks_never_builds_a_graph(fake_graphs, tmp_path):
    """A mesh over ranks runs the tile loop eagerly at every call, even
    where a one-device mesh would replay (its exchange and sums are
    collectives a capture cannot take); its results are the one-device
    loop's. One gloo rank in this process."""
    clip = _clip(2, 32, 64, 3)
    cfg = EncoderConfig(width=32, height=64, gop_n=3, base_qp=26)
    planes = _planes(clip)
    want = ShardedGopEncoder(cfg, make_codec_mesh(1, 1, "cpu")).run(
        *planes, 26)
    ranks = dmesh.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                                   device="cpu")
    try:
        senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 1, "cpu",
                                                      ranks=ranks))
        assert senc.mesh.group("tile") is not None
        for _ in range(3):
            got = senc.run(*planes, 26)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    finally:
        dist.destroy_process_group()
    assert senc.cache.graphs == {} and fake_graphs == []


def test_two_tile_batches_in_flight_keep_their_own_outputs(fake_graphs):
    """Batch k + 1 is launched before batch k is drained (the CLI's double
    buffer): each handle's outputs are its own copies, not the graph's
    static outputs, which the next replay overwrites. Each call raises
    LAUNCHES by the eager loop's counts (three planes, three frames)."""
    cfg = EncoderConfig(width=32, height=64, gop_n=3, base_qp=26)
    clips = [_frames(_clip(s, 32, 64, 3)) for s in (1, 2, 3)]
    want = [_bytes(GopEngine(cfg, device="cpu").encode_gop(c, 0)[0])
            for c in clips]
    assert len({tuple(w) for w in want}) == 3
    senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 2, "cpu"))
    handles, rises = [], []
    for i in (0, 1, 2, 0, 1):          # eager, capture, then replays
        h, rise = _counted(lambda i=i: senc.start([clips[i]], [0]))
        handles.append((i, h))
        rises.append(rise)
        if len(handles) > 1:           # drain the one before, as the CLI does
            j, prev = handles[-2]
            assert _bytes(senc.finish(prev)[0][0]) == want[j]
    j, last = handles[-1]
    assert _bytes(senc.finish(last)[0][0]) == want[j]
    assert rises == [{"code_plane": 9}] * 5
    (graph,) = [g for g in senc.cache.graphs.values()]
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 4
    assert graph.launches == {"code_plane": 9} and graph.capture_s >= 0
    assert senc.cache is senc.engine.cache
    static = {v.data_ptr() for v in graph.outs.values()}
    assert not static & {v.data_ptr() for _, h in handles
                         for v in h.outs.values()}


def test_tile_overflow_rerun_reads_its_own_planes(fake_graphs):
    """Black-and-white noise at qp 28 overflows every batch's budget.
    Batch k's worst-case rerun runs after batch k + 1 was launched, so it
    must read batch k's planes from its handle, not the static inputs
    that batch k + 1 filled; from its second call on the rerun is a graph
    of its own key."""
    cfg = EncoderConfig(width=128, height=128, gop_n=2, base_qp=28)
    clips = [_frames(_bw_noise(s, 128, 128, 2)) for s in (5, 6, 7, 8)]
    want = [_eager_tiled(cfg, c) for c in clips]
    senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 2, "cpu"))

    def start(i):
        return senc.start([clips[i]], [0])

    def finish(h):
        return _bytes(senc.finish(h)[0][0])

    h = [start(0), start(1)]
    got = [finish(h[0])]               # the rerun's eager call
    h.append(start(2))                 # static inputs: batch 2's
    got.append(finish(h[1]))           # rerun captured: batch 1
    h.append(start(3))
    got += [finish(h[2]), finish(h[3])]
    assert got == want
    assert all(bool(x.outs["ovf"].any()) for x in h)
    xl = [g for k, g in senc.cache.graphs.items()
          if k.cap_words == entropy.max_words(32)]
    assert len(xl) == 1 and xl[0] is not None
    assert [g.replays for g in fake_graphs] == [3, 3]


def test_device_engine_replays_from_frame_two(fake_graphs):
    """A GOP of 6 frames: frame 0 (I) and frame 1 (P) run eagerly, frame 2
    captures the P key, frames 3-5 replay; every frame raises LAUNCHES by
    its three code_plane calls, and the stream is the eager engine's. The
    recon the engine keeps is a replay's own copy."""
    clip = _clip(3, 64, 48, 6)
    cfg = EncoderConfig(width=64, height=48, gop_n=6, base_qp=27)
    want = io.BytesIO()
    types = gop_engine._GRAPH_DEVICE_TYPES
    gop_engine._GRAPH_DEVICE_TYPES = ()          # the eager engine
    try:
        encode_clip(cfg, clip, want, 6, engine=DeviceEngine("cpu"))
    finally:
        gop_engine._GRAPH_DEVICE_TYPES = types
    eng = DeviceEngine("cpu")
    rises = []
    real = eng.encode

    def encode(*args):
        out, rise = _counted(lambda: real(*args))
        rises.append(rise)
        return out

    eng.encode = encode
    got = io.BytesIO()
    encode_clip(cfg, clip, got, 6, engine=eng)
    assert got.getvalue() == want.getvalue()
    assert rises == [{"code_plane": 3}] * 6
    keys = {k.is_p: v for k, v in eng.graphs.items()}
    assert keys[False] is None and keys[True] is not None
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 4
    static = {t.data_ptr() for t in keys[True].outs["rec"]}
    assert not static & {t.data_ptr() for t in eng._last[1]}


# ---- (d) against the JAX package -----------------------------------------

# name -> config fields: the rc carry on the shards' summed bits (vbv), and
# format 4 (parity-then-pad exchange, quant matrix, intra slices)
_REF_TILED = {
    "v1-vbv": dict(base_qp=26, rc="vbv", target_kbps=60, vbv_kbits=20),
    "v4-islice": dict(base_qp=26, format_version=4, chroma_qp_offset=2,
                      quant_matrix=True, intra_slice_mbrows=1),
}


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("case,emit", [
    ("v1-vbv", "frame"), ("v1-vbv", "chunks"), ("v4-islice", "chunks")])
def test_tile_loop_matches_reference(fake_graphs, case, emit, g):
    """G GOPs of 3 frames at 32x64 in S = 2 row shards: the port's tile
    loop, through ShardedGopEncoder.run's eager call, capture and replay
    (the fake graph), writing each frame into [T, ...] outputs, gives the
    reference's encode_gop_tiled (G = 1) or encode_gop_batch_2d (G = 2)
    outputs on a fake-device CPU mesh: words, bits (span bits under chunk
    emit), inter MBs, frame qps and overflow flags."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh

    from video_encoder_tpu.codec.config import EncoderConfig as JConfig
    from video_encoder_tpu.ops import dispatch as jdispatch
    from video_encoder_tpu.parallel import tiles as jtiles
    from video_encoder_tpu_torch.codec.config import config_from_dict

    if len(jax.devices()) < 2 * g:
        pytest.skip(f"needs {2 * g} (fake) devices")
    w, h, t, s = 32, 64, 3, 2
    rcfg = JConfig(width=w, height=h, gop_n=t, search="full",
                   **_REF_TILED[case])
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    clips = [_clip(40 + i, w, h, t) for i in range(g)]
    n_mbs = (h // 16) * (w // 16) // s
    bw, cap = gop_engine.block_words_for_qp(cfg.base_qp), \
        entropy.capacity_words(n_mbs)
    kw = dict(rc=cfg.rc, block_words=bw, cap_words=cap,
              target_bits=cfg.target_bits_per_frame(),
              fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
              qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(),
              qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows, emit=emit)
    # the reference: [G, T, H, W] planes, results [G, S, T, ...]
    ref_planes = [np.stack([np.stack([f[i] for f in c]) for c in clips])
                  for i in range(3)]
    jdispatch.force("jnp")
    try:
        if g == 1:
            mesh = Mesh(np.array(jax.devices()[:s]), ("tile",))
            ref = jtiles.encode_gop_tiled(*(p[0] for p in ref_planes),
                                          cfg.base_qp, mesh=mesh, **kw)
            ref = {k: np.asarray(v)[None] for k, v in ref.items()}
        else:
            mesh = Mesh(np.array(jax.devices()[:g * s]).reshape(g, s),
                        ("gop", "tile"))
            ref = jtiles.encode_gop_batch_2d(*ref_planes, cfg.base_qp,
                                             mesh=mesh, **kw)
            ref = {k: np.asarray(v) for k, v in ref.items()}
    finally:
        jdispatch.force(None)
    senc = ShardedGopEncoder(cfg, make_codec_mesh(g, s, "cpu"))
    senc.emit = emit
    planes = tuple(torch.from_numpy(np.ascontiguousarray(p.swapaxes(0, 1)))
                   for p in ref_planes)      # [T, G, H, W]
    for _ in range(3):                  # eager, capture, replay
        got = senc.run(*planes, cfg.base_qp)

        def gst(x):                     # [T, G, S, ...] -> [G, S, T, ...]
            return np.moveaxis(x.numpy(), 0, 2)

        assert got["words"].dtype == torch.int32
        assert np.array_equal(gst(got["words"]).view(np.uint32),
                              ref["words"].astype(np.uint32))
        bits = got["cbits"] if emit == "chunks" else got["bits"]
        assert np.array_equal(gst(bits), ref["bits"])
        assert np.array_equal(gst(got["n_inter"]), ref["n_inter"])
        qp = np.broadcast_to(got["qp"].numpy().T[:, None], ref["qp"].shape)
        assert np.array_equal(qp, ref["qp"])
        assert np.array_equal(got["ovf"].numpy(), ref["ovf"].any((0, 1)))
        assert got["words"].shape[:3] == (t, g, s) and got["sse"].shape == (
            t, g, s, 3)
    assert [f.replays for f in fake_graphs] == [2]
    if cfg.rc == "vbv":                 # the carry moved the frame qp
        assert len(np.unique(ref["qp"])) > 1


@pytest.mark.parametrize("rc", ["none", "adaptive", "bitrate"])
def test_graphed_device_engine_matches_reference(rc):
    """A GOP of 5 frames through the fake-graphed DeviceEngine (frames 0-1
    eager, 2 the capture and its replay, 3-4 replays) gives the reference DeviceEngine's
    stream byte for byte."""
    pytest.importorskip("jax")
    from video_encoder_tpu.codec.config import EncoderConfig as JConfig
    from video_encoder_tpu.pipeline import device_engine as jdev
    from video_encoder_tpu.pipeline import encoder as jenc
    from video_encoder_tpu_torch.codec.config import config_from_dict

    made = []

    def capture(body, pool):
        outs = body()
        made.append(_FakeGraph(body, outs))
        return made[-1], outs

    kw = dict(none=dict(), adaptive=dict(search="diamond"),
              bitrate=dict(target_kbps=150))[rc]
    jcfg = JConfig(width=64, height=48, gop_n=5, base_qp=27, rc=rc, **kw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    clip = _clip(7, 64, 48, 5)
    want = io.BytesIO()
    jenc.encode_clip(jcfg, clip, want, 5, engine=jdev.DeviceEngine())
    saved = gop_engine._capture, gop_engine._GRAPH_DEVICE_TYPES
    gop_engine._capture, gop_engine._GRAPH_DEVICE_TYPES = capture, ("cpu",)
    try:
        got = io.BytesIO()
        eng = DeviceEngine("cpu")
        encode_clip(cfg, clip, got, 5, engine=eng)
    finally:
        gop_engine._capture, gop_engine._GRAPH_DEVICE_TYPES = saved
    assert got.getvalue() == want.getvalue()
    assert len(made) == 1 and made[0].replays == 3
    assert sum(v is not None for v in eng.graphs.values()) == 1


# ---- on the card ---------------------------------------------------------

def _card_tile_cfg(fmt4=False, **kw):
    if fmt4:        # two shards of 34 MB rows, each two intra slices
        return EncoderConfig(**{**dict(
            width=96, height=1088, gop_n=4, base_qp=26, format_version=4,
            quant_matrix=True, chroma_qp_offset=2, intra_slice_mbrows=17),
            **kw})
    return EncoderConfig(**{**dict(width=192, height=128, gop_n=4,
                                   base_qp=26), **kw})


@pytest.mark.parametrize("s,g,fmt4", [(2, 1, False), (4, 1, False),
                                      (2, 2, False), (2, 1, True)])
def test_tile_replay_equals_eager_on_card(cuda, s, g, fmt4):
    """Calls 1-3 of one key (the eager loop, the capture and its replay, a
    replay) give every output tensor of the eager loop (`_run`) on the
    same planes, with its launch counts, each a tensor of the call's own;
    and the packets equal the CPU's."""
    cfg = _card_tile_cfg(fmt4)
    w, h, t = cfg.width, cfg.height, cfg.gop_n
    clips = [_clip(20 + i, w, h, t) for i in range(g)]
    planes = tuple(torch.from_numpy(np.stack(
        [np.stack([c[k][i] for c in clips]) for k in range(t)])).to(cuda)
        for i in range(3))
    senc = ShardedGopEncoder(cfg, make_codec_mesh(g, s, cuda))
    bw, cap = senc._capacities(planes[0], [cfg.base_qp] * g, False)
    qp = torch.full((g,), cfg.base_qp, dtype=torch.int32, device=cuda)
    eager, eager_rise = _counted(lambda: senc._run(*planes, qp, bw, cap))
    for _ in range(3):
        got, rise = _counted(lambda: senc.run(*planes, cfg.base_qp))
        assert rise == eager_rise
        for k in eager:
            assert torch.equal(got[k], eager[k]), k
    (graph,) = [v for v in senc.cache.graphs.values() if v is not None]
    assert graph.capture_s > 0
    assert all(got[k].data_ptr() != graph.outs[k].data_ptr() for k in got)
    if g == 1 and not fmt4:
        cpu = ShardedGopEncoder(cfg, make_codec_mesh(1, s, "cpu"))
        frames = _frames(clips[0])
        assert _bytes(senc.finish(senc.start([frames], [0]))[0][0]) == \
            _bytes(cpu.finish(cpu.start([frames], [0]))[0][0])


def test_tile_forced_rerun_replays_on_card(cuda):
    """Black-and-white noise at qp 28 overflows: the worst-case rerun is a
    key of its own, captured at its second call; with two batches in
    flight each rerun reads its own batch's planes, and every batch gives
    its eager packets."""
    cfg = EncoderConfig(width=128, height=128, gop_n=2, base_qp=28)
    clips = [_frames(_bw_noise(s, 128, 128, 2)) for s in (5, 6, 7, 8)]
    want = [_eager_tiled(cfg, c, device=cuda) for c in clips]
    senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 2, cuda))

    def start(i):
        return senc.start([clips[i]], [0])

    def finish(h):
        return _bytes(senc.finish(h)[0][0])

    h = [start(0), start(1)]
    got = [finish(h[0])]
    h.append(start(2))
    got.append(finish(h[1]))
    h.append(start(3))
    got += [finish(h[2]), finish(h[3])]
    assert got == want
    assert all(bool(x.outs["ovf"].any()) for x in h)
    xl = [v for k, v in senc.cache.graphs.items()
          if k.cap_words == entropy.max_words(32)]
    assert len(xl) == 1 and xl[0] is not None


@pytest.mark.parametrize("batch", [1, 3])
def test_cli_tiled_gop10_equals_cpu_on_card(cuda, tmp_path, capsys, batch):
    """The CLI's `--gop 10 --tile 2` (GOPs 2-3 replays behind its double
    buffer) and `--gop 5 --gop-batch 3 --tile 2` (two batches: the second
    a replay) on 30 frames give the CPU's file."""
    clip = _clip(61, 96, 64, 30)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    gop = ["--gop", "10"] if batch == 1 else ["--gop", "5", "--gop-batch",
                                               str(batch)]
    files = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.tvc"
        assert cli.main(["encode", "-i", str(path), "-W", "96", "-H", "64",
                         "-o", str(out), *gop, "--tile", "2", "--device",
                         device]) == 0
        files[device] = out.read_bytes()
    capsys.readouterr()
    assert files["cuda"] == files["cpu"]


@pytest.mark.parametrize("search,rc", [("full", "none"),
                                       ("diamond", "bitrate")])
def test_engine_device_equals_oracle_on_card(cuda, tmp_path, capsys, search,
                                             rc):
    """`encode --engine device` on the card (frames 0-1 eager, 2 the
    capture, the rest replays) gives the C++ oracle's stream."""
    oracle = tmp_path / "oracle"
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-o", str(oracle),
                    str(ROOT / "oracle" / "oracle.cpp")], check=True)
    clip = _clip(71, 96, 64, 8)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    kbps = "300" if rc == "bitrate" else "0"
    want = tmp_path / "oracle.tvc"
    # oracle encode in out W H gop qp search rc kbps frames fmt cqpo qbias
    #   vbv_kbits qmat islice
    subprocess.run([str(oracle), "encode", str(path), str(want), "96", "64",
                    "8", "28", search, rc, kbps, "8", "1", "0", "8", "0", "0",
                    "0"], check=True, capture_output=True)
    got = tmp_path / "port.tvc"
    assert cli.main(["encode", "-i", str(path), "-W", "96", "-H", "64",
                     "-o", str(got), "--gop", "8", "--qp", "28", "--search",
                     search, "--rc", rc, "--kbps", kbps, "--engine", "device",
                     "--device", "cuda"]) == 0
    capsys.readouterr()
    assert got.read_bytes() == want.read_bytes()


_SYNC_SCRIPT = r"""
import sys
import numpy as np
import torch
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder
from video_encoder_tpu_torch.parallel.mesh import make_codec_mesh
from video_encoder_tpu_torch.pipeline import device_engine

rng = np.random.default_rng(3)
cfg = EncoderConfig(width=96, height=64, gop_n=3)
clip = [(rng.integers(0, 256, (64, 96), dtype=np.uint8),
         rng.integers(0, 256, (32, 48), dtype=np.uint8),
         rng.integers(0, 256, (32, 48), dtype=np.uint8)) for _ in range(3)]


def attempt(call):
    try:
        call()
    except RuntimeError as e:
        print("RAISED", str(e).splitlines()[0][:200])
    else:
        print("NO RAISE")


if sys.argv[1] == "tile":
    senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 2, "cuda"))
    loop = senc._run

    def synced(*args):
        out = loop(*args)
        bool(out["ovf"].any())
        return out

    senc._run = synced
    y, cb, cr = (torch.from_numpy(np.stack([f[i] for f in clip]))[:, None]
                 .cuda() for i in range(3))
    senc.run(y, cb, cr, 28)        # the eager first call may sync
    for _ in range(2):
        attempt(lambda: senc.run(y, cb, cr, 28))
    print("GRAPHS", sum(v is not None for v in senc.cache.graphs.values()))
else:
    frame = device_engine.encode_frame_device

    def synced(*args, **kw):
        out = frame(*args, **kw)
        bool(out["n_inter"] > 0)
        return out

    device_engine.encode_frame_device = synced
    eng = device_engine.DeviceEngine("cuda")
    frames = [Frame.from_planes(*p) for p in clip]
    eng.encode(cfg, frames[1], frames[0], 1, 28)     # eager: may sync
    for _ in range(2):
        attempt(lambda: eng.encode(cfg, frames[2], frames[1], 1, 28))
    print("GRAPHS", sum(v is not None for v in eng.graphs.values()))
"""


@pytest.mark.parametrize("path", ["tile", "device"])
def test_host_sync_in_the_body_fails_the_capture_on_card(cuda, path):
    """A host read inside the captured tile loop or frame encode raises at
    every capture, and nothing falls back to the eager call: no graph is
    kept, no result is returned (a process of its own)."""
    r = subprocess.run([sys.executable, "-c", _SYNC_SCRIPT, path], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert [ln.split()[0] for ln in out[-3:]] == ["RAISED", "RAISED", "GRAPHS"]
    assert out[-1] == "GRAPHS 0"
