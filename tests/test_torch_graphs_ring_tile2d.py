"""The temporal ring and the 2-D tile grid as one captured CUDA graph per
key on one device (`parallel/ring.py` RingEncoder, through
`GopEngine.run_batch` with the hop "roll"; `parallel/tiles.py`
encode_gop_tiled2d, through its own `GraphCache`): the port's
counterparts of the reference's jitted encode_ring_jit and
encode_gop_tiled2d.

On the CPU, through the seam of tests/test_torch_graphs_paths.py (a fake
`_capture` and "cpu" in `_GRAPH_DEVICE_TYPES`): the ring's first call
(eager), second (the capture and its replay) and third (a replay) give
the reference RingEncoder's packets at D = 2 and 4 (rc none, bitrate,
vbv; format 4 with rc vbv) with equal launches; its key names the hop,
so a plain lockstep batch of the same shapes gets a key of its own; its
worst-case rerun is a key of its own; over ranks it has no key. The 2-D
grid's three calls give the reference's frames and the unsharded stream
(2 x 2 with rc none, vbv and mb; 1 x 4 with rc mb); its key changes with
every static argument, each shape and both routes; two base qps replay
one graph, each giving its own stream; two calls in flight keep their own
outputs; over ranks it has no key.

On the card (tests that take the `cuda` fixture skip without one): each
path's capture and replays equal its eager loop on the same planes with
the same launches, and a host sync inside either body makes every
capture raise. On the card host run

    python -m pytest tests/test_torch_graphs_ring_tile2d.py --noconftest -q

where the JAX comparisons skip (without tests/conftest.py JAX has one
device, or is absent). Tolerance 0: the codec is integer-only.
"""

import dataclasses
import functools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_graphs_paths import (  # noqa: F401 (the fixtures)
    _bw_noise, _clip, _counted, _frames, cuda, fake_graphs)
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.parallel import mesh as dmesh
from video_encoder_tpu_torch.parallel import tiles
from video_encoder_tpu_torch.parallel.mesh import (make_ring_mesh,
                                                   make_tile_mesh_2d)
from video_encoder_tpu_torch.parallel.ring import RingEncoder
from video_encoder_tpu_torch.pipeline import gop_engine
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_tile2d_caches():
    """The 2-D grid's graphs are process-wide (one GraphCache per device,
    as the reference's jit cache): each test starts from none."""
    tiles._TILE2D_CACHES.clear()
    yield
    tiles._TILE2D_CACHES.clear()


def _packets(streams):
    return [[p.to_bytes() for p in s] for s in streams]


def _ring_planes(streams, d):
    """[T, D, H, W] uint8 planes of D equal-length streams in the ring's
    schedule: column d, step m holds frame m of stream (d - m) mod D."""
    t = len(streams[0])
    return tuple(torch.from_numpy(np.stack([
        np.stack([getattr(streams[(c - m) % d][m], p) for c in range(d)])
        for m in range(t)])) for p in ("y", "cb", "cr"))


# ---- the ring ------------------------------------------------------------

# (tests/test_torch_dist.py's ring case, D): its first D streams
_RINGS = [("none", 4), ("none", 2), ("bitrate", 4), ("bitrate", 2),
          ("vbv", 4), ("vbv", 2), ("v4-vbv", 4)]


@functools.lru_cache(maxsize=None)
def _reference_ring(name, d):
    """(config, streams, the reference RingEncoder's packets) of a ring
    case of tests/test_torch_dist.py on D fake CPU devices, jnp path."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh

    import test_torch_dist as td
    from video_encoder_tpu.codec import golden
    from video_encoder_tpu.codec.config import EncoderConfig as RefConfig
    from video_encoder_tpu.ops import dispatch as jdispatch
    from video_encoder_tpu.parallel import ring as jring

    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} (fake) devices")
    cfg, streams = td.RINGS[name]
    streams = streams[:d]
    y, cb, cr = td._planes()
    ref_streams = [[golden.Frame.from_planes(y[t], cb[t], cr[t])
                    for t in range(a, a + n)] for a, n in streams]
    jdispatch.force("jnp")
    try:
        want = jring.RingEncoder(
            RefConfig(**dataclasses.asdict(cfg)),
            Mesh(np.array(jax.devices()[:d]), ("ring",))).encode_streams(
                ref_streams, td._ring_firsts(streams))
    finally:
        jdispatch.force(None)
    return cfg, td._stream_frames(streams), td._ring_firsts(streams), \
        _packets(want)


@pytest.mark.parametrize("name,d", _RINGS)
def test_ring_eager_capture_replay_match_reference(fake_graphs, name, d):
    """D streams on one device: the ring's first call (the eager loop),
    its second (the capture and its replay) and its third (a replay) each
    give the reference RingEncoder's packets, with the same launches;
    every graph is a key of the roll, replayed twice."""
    cfg, streams, firsts, want = _reference_ring(name, d)
    ring = RingEncoder(cfg, make_ring_mesh(d, "cpu"))
    rises = []
    for _ in range(3):
        got, rise = _counted(lambda: ring.encode_streams(streams, firsts))
        assert _packets(got) == want
        rises.append(rise)
    assert rises[0] and rises == [rises[0]] * 3
    graphs = ring.engine.graphs
    assert graphs and all(k.hop == "roll" and g is not None
                          for k, g in graphs.items())
    assert [f.replays for f in fake_graphs] == [2] * len(graphs)


def test_ring_key_names_the_hop(fake_graphs):
    """The ring on one device asks for its hop by name, so its key is a
    plain lockstep batch's of the same shapes but for the hop: a plain
    run_batch on the ring's planes gets a key and a graph of its own, and
    gives the lockstep encode's results, not the ring's."""
    cfg = EncoderConfig(width=32, height=64, gop_n=3, base_qp=26)
    streams = [_frames(_clip(s, 32, 64, 3)) for s in (1, 2)]
    ring = RingEncoder(cfg, make_ring_mesh(2, "cpu"))
    for _ in range(2):
        ring.encode_streams(streams, [0, 10])
    eng = ring.engine
    (ring_key,) = eng.graphs
    assert ring_key.hop == "roll"
    planes = _ring_planes(streams, 2)
    bw, cap = eng._capacities(8, 26, False)
    qp = torch.tensor([26, 26], dtype=torch.int32)
    outs = {hop: [eng.run_batch(*planes, [26, 26], hop=hop) for _ in range(2)]
            for hop in ("roll", None)}
    assert set(eng.graphs) == {ring_key, ring_key._replace(hop=None)}
    assert all(g is not None for g in eng.graphs.values())
    for hop, calls in outs.items():
        want = eng._run(*planes, qp, bw, cap, hop=hop)
        for got in calls:
            assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(outs["roll"][0]["words"], outs[None][0]["words"])


def test_ring_overflow_rerun_is_a_key_of_its_own(fake_graphs):
    """Black-and-white noise at qp 28 overflows the 16-word block budget,
    so every call reruns at the worst case: a key of its own (its block
    and frame capacities), captured at its second call like the budgeted
    one; each call gives the single-device encodes."""
    cfg = EncoderConfig(width=128, height=128, gop_n=2, base_qp=28)
    streams = [_frames(_bw_noise(s, 128, 128, 2)) for s in (5, 6)]
    want = [[p.to_bytes() for p in GopEngine(cfg, device="cpu").encode_gop(
        s, f)[0]] for s, f in zip(streams, (0, 10))]
    ring = RingEncoder(cfg, make_ring_mesh(2, "cpu"))
    for _ in range(3):
        assert _packets(ring.encode_streams(streams, [0, 10])) == want
    graphs = ring.engine.graphs
    assert {k.block_words for k in graphs} == {16, entropy.BLOCK_WORDS_MAX}
    assert all(k.hop == "roll" and g is not None for k, g in graphs.items())
    assert [f.replays for f in fake_graphs] == [2, 2]


def test_ring_over_ranks_has_no_key(fake_graphs, tmp_path):
    """On a mesh over ranks (one gloo rank in this process) the ring's hop
    is the group's exchange, a function: no key, so `graphs` stays empty
    and every call runs eagerly, with the one-device ring's packets."""
    cfg = EncoderConfig(width=32, height=64, gop_n=3, base_qp=26,
                        rc="bitrate", target_kbps=60)
    streams = [_frames(_clip(3, 32, 64, 3))]
    want = _packets(RingEncoder(cfg, make_ring_mesh(1, "cpu")).encode_streams(
        streams, [0]))
    ranks = dmesh.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                                   device="cpu")
    try:
        ring = RingEncoder(cfg, make_ring_mesh(1, "cpu", ranks=ranks))
        assert ring.group is not None
        for _ in range(3):
            assert _packets(ring.encode_streams(streams, [0])) == want
    finally:
        dist.destroy_process_group()
    assert ring.engine.graphs == {} and fake_graphs == []


# ---- the 2-D tile grid ---------------------------------------------------

def _grid_kw(cfg, sc):
    """encode_gop_tiled2d's capacities as the tests take them: the exact
    worst case, so no call overflows."""
    return dict(rc=cfg.rc, block_words=entropy.BLOCK_WORDS_MAX,
                row_words=entropy.max_words(cfg.width // sc // 16),
                target_bits=cfg.target_bits_per_frame(),
                vbv_bits=cfg.vbv_bits())


def _glue(outs):
    """Each frame's (payload, bits) from the grid's outputs."""
    words = outs["words"].cpu().numpy()
    row_bits = outs["row_bits"].cpu().numpy()
    return [tiles.assemble_frame_2d(words, row_bits, k)
            for k in range(row_bits.shape[0])]


def _unsharded(cfg, clip, base_qp=None):
    """The (payload, bits) of a fresh GOP engine's encode (its key's first
    call: the eager loop)."""
    packets, _ = GopEngine(cfg, device="cpu").encode_gop(_frames(clip), 0,
                                                         base_qp)
    return [(p.payload, p.payload_bits) for p in packets]


def _grid_planes(clip, device="cpu"):
    return tuple(torch.from_numpy(np.stack([p[i] for p in clip])).to(device)
                 for i in range(3))


@pytest.mark.parametrize("sr,sc,rc", [(2, 2, "none"), (2, 2, "vbv"),
                                      (2, 2, "mb"), (1, 4, "mb")])
def test_tile2d_eager_capture_replay_match_reference(fake_graphs, sr, sc, rc):
    """A GOP of 3 frames at 128x64 on the grid: the first call (eager), the
    second (the capture and its replay) and the third (a replay) each give
    the reference's encode_gop_tiled2d frames on a fake-device CPU mesh
    (tests/test_torch_tiles.py) and the port's unsharded stream, with the
    same launches; one graph, keyed by the grid, replayed twice."""
    jax = pytest.importorskip("jax")
    import test_torch_tiles as tt
    from video_encoder_tpu_torch.codec.config import config_from_dict

    if len(jax.devices()) < sr * sc:
        pytest.skip(f"needs {sr * sc} (fake) devices")
    rcfg, want = tt._reference_grid(sr, sc, rc)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    clip = tt._smooth_planes(cfg.height, cfg.width, cfg.gop_n, slide=5)
    assert _unsharded(cfg, clip) == want
    planes = _grid_planes(clip)
    mesh = make_tile_mesh_2d(sr, sc, "cpu")
    rises = []
    for _ in range(3):
        outs, rise = _counted(lambda: tiles.encode_gop_tiled2d(
            *planes, 26, mesh=mesh, **_grid_kw(cfg, sc)))
        assert not bool(outs["ovf"].any())
        assert _glue(outs) == want
        assert outs["words"].shape[:3] == (cfg.gop_n, sr, sc)
        rises.append(rise)
    assert rises[0] and rises == [rises[0]] * 3
    (key,) = tiles.tile2d_cache("cpu").graphs
    assert key.grid == (sr, sc) and key.rc == rc
    assert [f.replays for f in fake_graphs] == [2]


def test_tile2d_base_qp_is_a_graph_input(fake_graphs):
    """Calls at base qps 26, 30, 26, 30 run one key (the eager loop, the
    capture, then replays of one graph), each giving the unsharded stream
    at its own qp, whose rc bitrate carry starts from it."""
    cfg = EncoderConfig(width=128, height=64, gop_n=3, base_qp=26,
                        rc="bitrate", target_kbps=80)
    clip = _clip(5, 128, 64, 3)
    want = {q: _unsharded(cfg, clip, q) for q in (26, 30)}
    assert want[26] != want[30]
    planes = _grid_planes(clip)
    mesh = make_tile_mesh_2d(2, 2, "cpu")
    for q in (26, 30, 26, 30):
        outs = tiles.encode_gop_tiled2d(*planes, q, mesh=mesh,
                                        **_grid_kw(cfg, 2))
        assert _glue(outs) == want[q] and int(outs["qp"][0]) == q
    assert len(tiles.tile2d_cache("cpu").graphs) == 1
    assert [f.replays for f in fake_graphs] == [3]


def test_tile2d_two_calls_in_flight_keep_their_own_outputs(fake_graphs):
    """Two GOPs launched before either is read, both replays: each keeps
    its own outputs, copies of the graph's static outputs, which the
    second replay overwrote."""
    cfg = EncoderConfig(width=128, height=64, gop_n=3, base_qp=26)
    clips = [_clip(s, 128, 64, 3) for s in (6, 7)]
    want = [_unsharded(cfg, c) for c in clips]
    assert want[0] != want[1]
    mesh = make_tile_mesh_2d(2, 2, "cpu")

    def launch(i):
        return tiles.encode_gop_tiled2d(*_grid_planes(clips[i]), 26,
                                        mesh=mesh, **_grid_kw(cfg, 2))

    assert [_glue(launch(i)) for i in (0, 1)] == want     # eager, capture
    first, second = launch(0), launch(1)
    assert [_glue(first), _glue(second)] == want
    (graph,) = tiles.tile2d_cache("cpu").graphs.values()
    static = {v.data_ptr() for v in graph.outs.values()}
    assert not static & {v.data_ptr() for o in (first, second)
                         for v in o.values()}
    assert [f.replays for f in fake_graphs] == [3]


def test_tile2d_over_ranks_has_no_key(fake_graphs, tmp_path):
    """On a mesh over ranks (one gloo rank in this process, a 1 x 1 grid)
    the loop's halo and sums are collectives: no key, so every call runs
    eagerly and the grid's cache stays empty, with the one-device grid's
    outputs."""
    cfg = EncoderConfig(width=64, height=64, gop_n=3, base_qp=26, rc="mb",
                        target_kbps=80)
    planes = _grid_planes(_clip(8, 64, 64, 3))
    kw = _grid_kw(cfg, 1)
    want = tiles.encode_gop_tiled2d(*planes, 26,
                                    mesh=make_tile_mesh_2d(1, 1, "cpu"), **kw)
    tiles._TILE2D_CACHES.clear()
    ranks = dmesh.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                                   device="cpu")
    try:
        mesh = make_tile_mesh_2d(1, 1, "cpu", ranks=ranks)
        assert mesh.group("tr") is not None
        assert tiles.tile2d_graph_key(mesh, planes[0].shape, planes[1].shape,
                                      fmt=1, rc="mb") is None
        for _ in range(3):
            got = tiles.encode_gop_tiled2d(*planes, 26, mesh=mesh, **kw)
            assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        dist.destroy_process_group()
    assert tiles.tile2d_cache("cpu").graphs == {} and fake_graphs == []


_KBASE = dict(rc="vbv", block_words=16, row_words=200, target_bits=9000,
              qbias=8, vbv_bits=20000, fmt=1)
_KY, _KC = (3, 64, 128), (3, 32, 64)


def _tile2d_key(grid=(2, 2), y=_KY, c=_KC, **kw):
    return tiles.tile2d_graph_key(make_tile_mesh_2d(*grid, "cpu"), y, c,
                                  **{**_KBASE, **kw})


@pytest.mark.parametrize("change", [
    "equal", "grid", "rc", "block_words", "row_words", "target_bits",
    "qbias", "vbv_bits", "T", "H", "W", "TVC_SEA", "force"])
def test_tile2d_key_changes_with_each_static_argument(monkeypatch, change):
    """Equal arguments give equal keys; each static argument of the
    reference's jitted encode_gop_tiled2d, each shape and both routes the
    wrappers read at every call change it (a capture bakes every one of
    them in). The base qp is not in it."""
    monkeypatch.delenv("TVC_SEA", raising=False)
    base = _tile2d_key()
    if change == "TVC_SEA":
        monkeypatch.setenv("TVC_SEA", "1")
        got = _tile2d_key()
    elif change == "force":
        dispatch.force("plain")
        try:
            got = _tile2d_key()
        finally:
            dispatch.force(None)
    else:
        got = {
            "equal": lambda: _tile2d_key(),
            "grid": lambda: _tile2d_key(grid=(1, 4)),
            "rc": lambda: _tile2d_key(rc="mb"),
            "block_words": lambda: _tile2d_key(block_words=24),
            "row_words": lambda: _tile2d_key(row_words=201),
            "target_bits": lambda: _tile2d_key(target_bits=9001),
            "qbias": lambda: _tile2d_key(qbias=5),
            "vbv_bits": lambda: _tile2d_key(vbv_bits=20001),
            "T": lambda: _tile2d_key(y=(4, 64, 128), c=(4, 32, 64)),
            "H": lambda: _tile2d_key(y=(3, 96, 128), c=(3, 48, 64)),
            "W": lambda: _tile2d_key(y=(3, 64, 160), c=(3, 32, 80)),
        }[change]()
    assert (got == base) == (change == "equal")


# ---- on the card -----------------------------------------------------------

def _eager(fn):
    """fn() with no device running graphs: every GraphCache call eager."""
    saved = gop_engine._GRAPH_DEVICE_TYPES
    gop_engine._GRAPH_DEVICE_TYPES = ()
    try:
        return fn()
    finally:
        gop_engine._GRAPH_DEVICE_TYPES = saved


def test_ring_replay_equals_eager_on_card(cuda):
    """D = 4 streams of 4 frames at 192x128, rc vbv, one of them shorter:
    calls 1-3 (the eager loop, the capture and its replay, a replay) give
    the eager ring's packets on the card, with its launches, and the CPU
    ring's; the graph is a key of the roll."""
    cfg = EncoderConfig(width=192, height=128, gop_n=4, base_qp=26, rc="vbv",
                        target_kbps=400)
    streams = [_frames(_clip(30 + s, 192, 128, 4))[:4 - (s == 3)]
               for s in range(4)]
    firsts = [0, 100, 200, 300]
    want, want_rise = _counted(lambda: _eager(
        lambda: RingEncoder(cfg, make_ring_mesh(4, cuda)).encode_streams(
            streams, firsts)))
    ring = RingEncoder(cfg, make_ring_mesh(4, cuda))
    for _ in range(3):
        got, rise = _counted(lambda: ring.encode_streams(streams, firsts))
        assert _packets(got) == _packets(want) and rise == want_rise
    graphs = [(k, g) for k, g in ring.engine.graphs.items() if g is not None]
    assert graphs and all(k.hop == "roll" and g.capture_s > 0
                          for k, g in graphs)
    cpu = RingEncoder(cfg, make_ring_mesh(4, "cpu")).encode_streams(streams,
                                                                   firsts)
    assert _packets(got) == _packets(cpu)


@pytest.mark.parametrize("rc", ["none", "mb"])
def test_tile2d_replay_equals_eager_on_card(cuda, rc):
    """A 2 x 2 grid over 192x128 frames, GOP 4: calls 1-3 (eager, capture,
    replay) give every output of the eager loop on the same planes, with
    its launches, each a tensor of the call's own; the frames equal the
    CPU's unsharded stream."""
    kw = dict(rc="mb", target_kbps=300) if rc == "mb" else {}
    cfg = EncoderConfig(width=192, height=128, gop_n=4, base_qp=26, **kw)
    clip = _clip(41, 192, 128, 4)
    planes = _grid_planes(clip, cuda)
    mesh = make_tile_mesh_2d(2, 2, cuda)

    def call():
        return tiles.encode_gop_tiled2d(*planes, 26, mesh=mesh,
                                        **_grid_kw(cfg, 2))

    eager, eager_rise = _counted(lambda: _eager(call))
    for _ in range(3):
        got, rise = _counted(call)
        assert rise == eager_rise
        assert all(torch.equal(got[k], eager[k]) for k in eager)
    (graph,) = [g for g in tiles.tile2d_cache(cuda).graphs.values()
                if g is not None]
    assert graph.capture_s > 0
    assert all(got[k].data_ptr() != graph.outs[k].data_ptr() for k in got)
    assert _glue(got) == _unsharded(cfg, clip)


_SYNC_SCRIPT = r"""
import sys
import numpy as np
import torch
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.parallel import tiles
from video_encoder_tpu_torch.parallel.mesh import (make_ring_mesh,
                                                   make_tile_mesh_2d)
from video_encoder_tpu_torch.parallel.ring import RingEncoder

rng = np.random.default_rng(3)
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


if sys.argv[1] == "ring":
    cfg = EncoderConfig(width=96, height=64, gop_n=3)
    ring = RingEncoder(cfg, make_ring_mesh(2, "cuda"))
    loop = ring.engine._run

    def synced(*args, **kw):
        out = loop(*args, **kw)
        bool(out["ovf"].any())
        return out

    ring.engine._run = synced
    streams = [[Frame.from_planes(*p) for p in clip]] * 2
    ring.encode_streams(streams, [0, 10])    # the eager first call may sync
    for _ in range(2):
        attempt(lambda: ring.encode_streams(streams, [0, 10]))
    print("GRAPHS", sum(v is not None for v in ring.engine.graphs.values()))
else:
    scan = tiles.tile2d_gop_scan

    def synced(*args, **kw):
        out = scan(*args, **kw)
        bool(out["ovf"].any())
        return out

    tiles.tile2d_gop_scan = synced
    y, cb, cr = (torch.from_numpy(np.stack([f[i] for f in clip])).cuda()
                 for i in range(3))

    def call():
        return tiles.encode_gop_tiled2d(
            y, cb, cr, 28, mesh=make_tile_mesh_2d(2, 2, "cuda"), rc="none",
            block_words=78, row_words=200, target_bits=0)

    call()                                   # the eager first call may sync
    for _ in range(2):
        attempt(call)
    print("GRAPHS", sum(v is not None
                        for v in tiles.tile2d_cache("cuda").graphs.values()))
"""


@pytest.mark.parametrize("path", ["ring", "tile2d"])
def test_host_sync_in_the_body_fails_the_capture_on_card(cuda, path):
    """A host read inside the ring's loop or the 2-D grid's raises at every
    capture, and nothing falls back to the eager loop: no graph is kept,
    no result is returned (a process of its own)."""
    r = subprocess.run([sys.executable, "-c", _SYNC_SCRIPT, path], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert [ln.split()[0] for ln in out[-3:]] == ["RAISED", "RAISED", "GRAPHS"]
    assert out[-1] == "GRAPHS 0"
