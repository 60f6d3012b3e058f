"""The GOP engine's frame loop as one captured CUDA graph per key
(`pipeline/gop_engine.py` GopGraph), the port's counterpart of the
reference's encode_gop_jit / encode_gop_batch_jit.

On the CPU: the graph key changes with every static argument of the
reference's jit, with the shapes and with TVC_SEA; a CPU engine builds no
graph; through the module's seam (`_capture`, `_GRAPH_DEVICE_TYPES`) a
fake graph, whose replay reruns the captured body into the same static
outputs, shows that two GOPs in flight keep their own outputs, that an
overflow rerun reads its own GOP's planes, and that `build.LAUNCHES`
rises per replay by the counts recorded at capture; and the loop with its
preallocated [T, ...] outputs gives the JAX engine's streams for the three
1080p configurations of chip_smoke.py at a small size.

On the card (tests that take the `cuda` fixture skip without one): the
replayed streams equal the eager loop's (full search, config 3, format
4, G = 1 and 2, a tail GOP, a forced worst-case rerun, TVC_SEA turned on
between calls), the launch counts per GOP equal the eager loop's, the
CLI's double-buffered encode gives the CPU's file, a replay's trace names
the search and code_plane kernels, and a body with a host sync makes the
capture raise. The card host has no JAX: there run

    python -m pytest tests/test_torch_graphs.py --noconftest -q

where the JAX comparisons skip. Tolerance 0: the codec is integer-only.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.ops.kernels import build
from video_encoder_tpu_torch.pipeline import gop_engine
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# chip_smoke.py's three 1080p cells: full search rc none; BASELINE config 3
# (diamond, rc mb); format 4 with the quant matrix and chroma qp offset 2
CELLS = {
    "full": dict(),
    "config3": dict(search="diamond", rc="mb", target_kbps=250),
    "v4": dict(format_version=4, quant_matrix=True, chroma_qp_offset=2),
}


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda", 0)


def _clip(seed, w, h, n):
    """A texture smoothed four times, panning 3 px down and 5 px right per frame (2x2
    means at an odd offset: true half-pel motion), a moving block, and
    moving chroma."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (2 * h + 8 * n, 2 * w + 12 * n)).astype(np.int64)
    for _ in range(4):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    cbig = (96 + big[:h + 4 * n, :w + 4 * n] // 4).astype(np.uint8)
    clip = []
    for t in range(n):
        o = big[3 * t:3 * t + 2 * h, 5 * t:5 * t + 2 * w]
        y = ((o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2]
              + 2) // 4).astype(np.uint8)
        y[(5 * t) % (h - 16):(5 * t) % (h - 16) + 16, 8:24] = 230
        clip.append((y, cbig[t:t + h // 2, 2 * t:2 * t + w // 2].copy(),
                     cbig[2 * t:2 * t + h // 2, t:t + w // 2][::-1].copy()))
    return clip


def _noise(seed, w, h, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _frames(clip):
    return [Frame.from_planes(*p) for p in clip]


def _bytes(packets):
    return [p.to_bytes() for p in packets]


def _eager(cfg, frames, device="cpu"):
    """The packets of a fresh engine's call: a key's first call is the
    eager loop, and so is its worst-case rerun's."""
    return _bytes(GopEngine(cfg, device=device).encode_gop(frames, 0)[0])


def _counted(fn):
    """(fn(), the rise of build.LAUNCHES over the call)."""
    before = dict(build.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in build.LAUNCHES.items()
                 if v != before[k]}


# ---- (a) the key ---------------------------------------------------------

_BASE = dict(width=64, height=48, gop_n=4, base_qp=28, search="full",
             rc="vbv", target_kbps=300, vbv_kbits=200, format_version=3,
             chroma_qp_offset=2, quant_bias=8, quant_matrix=False,
             intra_slice_mbrows=1)
_Y, _C = (4, 48, 64), (4, 24, 32)


def _key(cfg=None, emit=None, y=_Y, c=_C, bw=16, cap=100):
    eng = GopEngine(EncoderConfig(**{**_BASE, **(cfg or {})}), device="cpu",
                    emit=emit)
    return eng.graph_key(y, c, bw, cap)


@pytest.mark.parametrize("change", [
    "equal", "search", "rc", "block_words", "cap_words", "target_bits", "fmt",
    "cqpo", "qbias", "vbv_bits", "qmat", "islice", "emit", "T", "G", "H",
    "W", "TVC_SEA", "force"])
def test_graph_key_changes_with_each_static_argument(monkeypatch, change):
    """Equal inputs give equal keys; each static argument of the
    reference's jit, each shape, the SEA route and the dispatch route
    changes it (a capture bakes every one of them in)."""
    monkeypatch.delenv("TVC_SEA", raising=False)
    base = _key()
    other = {
        "equal": lambda: _key(),
        "search": lambda: _key(dict(search="diamond")),
        "rc": lambda: _key(dict(rc="mb")),
        "block_words": lambda: _key(bw=24),
        "cap_words": lambda: _key(cap=101),
        "target_bits": lambda: _key(dict(target_kbps=301)),
        "fmt": lambda: _key(dict(format_version=4)),
        "cqpo": lambda: _key(dict(chroma_qp_offset=3)),
        "qbias": lambda: _key(dict(quant_bias=5)),
        "vbv_bits": lambda: _key(dict(vbv_kbits=201)),
        "qmat": lambda: _key(dict(quant_matrix=True)),
        "islice": lambda: _key(dict(intra_slice_mbrows=2)),
        "emit": lambda: _key(emit="chunks"),
        "T": lambda: _key(y=(3, 48, 64), c=(3, 24, 32)),
        "G": lambda: _key(y=(4, 2, 48, 64), c=(4, 2, 24, 32)),
        "H": lambda: _key(y=(4, 64, 64), c=(4, 32, 32)),
        "W": lambda: _key(y=(4, 48, 80), c=(4, 24, 40)),
    }
    if change == "TVC_SEA":
        monkeypatch.setenv("TVC_SEA", "1")
        got = _key()
    elif change == "force":
        dispatch.force("plain")
        try:
            got = _key()
        finally:
            dispatch.force(None)
    else:
        got = other[change]()
    assert (got == base) == (change == "equal")


# ---- (b) the CPU builds no graph ----------------------------------------

def test_cpu_engine_never_builds_a_graph(monkeypatch):
    def refuse(body, pool):
        raise AssertionError("a CPU engine captured a graph")

    monkeypatch.setattr(gop_engine, "_capture", refuse)
    clip = _clip(1, 48, 32, 3)
    eng = GopEngine(EncoderConfig(width=48, height=32, gop_n=3), device="cpu")
    first = eng.encode_gop(_frames(clip), 0)[0]
    for _ in range(2):
        assert _bytes(eng.encode_gop(_frames(clip), 0)[0]) == _bytes(first)
        eng.finish(eng.start([_frames(clip)] * 2, [0, 3]))
    assert eng.graphs == {}


# ---- (c) the seam: a fake graph on the CPU ------------------------------

class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: replay reruns the captured body
    and writes its results into the static outputs of the capture, as a
    replay writes the same buffers; a replay runs no Python wrapper, so
    the launch counts it would move are put back."""

    def __init__(self, body, outs):
        self.body, self.outs, self.replays = body, outs, 0

    def replay(self):
        saved = dict(build.LAUNCHES)
        new = self.body()
        build.LAUNCHES.update(saved)
        for k, v in new.items():
            self.outs[k].copy_(v)
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


def test_two_gops_in_flight_keep_their_own_outputs(fake_graphs):
    """GOP k + 1 is launched before GOP k is drained (the CLI's double
    buffer): each handle's outputs are its own copies, not the graph's
    static outputs, which the next replay overwrites. Each call raises
    LAUNCHES by the eager loop's counts."""
    cfg = EncoderConfig(width=48, height=32, gop_n=3, base_qp=26)
    clips = [_frames(_clip(s, 48, 32, 3)) for s in (1, 2, 3)]
    want = [_eager(cfg, c) for c in clips]
    assert len({tuple(w) for w in want}) == 3
    eng = GopEngine(cfg, device="cpu")
    handles, rises = [], []
    for i in (0, 1, 2, 0, 1):          # eager, capture, then replays
        h, rise = _counted(lambda i=i: eng.start([clips[i]], [0]))
        handles.append((i, h))
        rises.append(rise)
        if len(handles) > 1:           # drain the one before, as the CLI does
            j, prev = handles[-2]
            assert _bytes(eng.finish(prev)[0][0]) == want[j]
    j, last = handles[-1]
    assert _bytes(eng.finish(last)[0][0]) == want[j]
    assert rises == [{"code_plane": 9}] * 5
    (graph,) = [g for g in eng.graphs.values()]
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 4
    assert graph.launches == {"code_plane": 9} and graph.capture_s >= 0
    static = {v.data_ptr() for v in graph.outs.values()}
    assert not static & {v.data_ptr() for _, h in handles
                         for v in h.outs.values()}


def test_overflow_rerun_reads_its_own_planes(fake_graphs):
    """Noise at qp 1 overflows every GOP's budget. GOP k's worst-case
    rerun runs after GOP k + 1 was launched, so it must read GOP k's
    planes from its handle, not the static inputs that GOP k + 1 filled;
    from its second call on the rerun is a graph of its own key."""
    cfg = EncoderConfig(width=48, height=32, gop_n=3, base_qp=1)
    clips = [_frames(_noise(s, 48, 32, 3)) for s in (5, 6, 7, 8)]
    want = [_eager(cfg, c) for c in clips]
    eng = GopEngine(cfg, device="cpu")
    h = [eng.start([clips[0]], [0]), eng.start([clips[1]], [0])]
    got = [eng.finish(h[0])[0]]                  # the rerun's eager call
    h.append(eng.start([clips[2]], [0]))         # static inputs: GOP 2's
    got.append(eng.finish(h[1])[0])              # rerun captured: GOP 1
    h.append(eng.start([clips[3]], [0]))
    got += [eng.finish(h[2])[0], eng.finish(h[3])[0]]
    for g, w in zip(got, want):
        assert _bytes(g[0]) == w
    assert all(bool(x.outs["ovf"].any()) for x in h)
    xl = [g for k, g in eng.graphs.items() if k.cap_words == entropy.max_words(6)]
    assert len(xl) == 1 and xl[0] is not None
    assert [g.replays for g in fake_graphs] == [3, 3]


def test_batched_replay_fills_per_gop_qps(fake_graphs):
    """run_batch's graph takes the G base qps as a [G] input filled before
    each replay: a batch at other qps replays the same graph and gives the
    packets of its own eager encode."""
    cfg = EncoderConfig(width=48, height=32, gop_n=3)
    gops = [_frames(_clip(s, 48, 32, 3)) for s in (1, 2)]
    def eager(qps):     # a fresh engine: its key's first, eager call
        plain = GopEngine(cfg, device="cpu")
        return [_bytes(p) for p, _ in
                plain.finish(plain.start(gops, [0, 3], list(qps)))]

    want = {qps: eager(qps) for qps in ((24, 30), (31, 22), (27, 27))}
    eng = GopEngine(cfg, device="cpu")
    for qps in ((24, 30), (31, 22), (27, 27), (24, 30)):
        got = eng.finish(eng.start(gops, [0, 3], list(qps)))
        assert [_bytes(p) for p, _ in got] == want[qps]
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 3


# ---- (d) the preallocated-output loop against the JAX engine -------------

@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_loop_matches_jax_engine(cell, emit):
    """The three 1080p cells at 96x64, T = 4: the port's loop, writing each
    frame into [T, ...] outputs, gives the JAX engine's packets (its jnp
    path), and so does the lockstep loop of two GOPs."""
    pytest.importorskip("jax")
    from video_encoder_tpu.codec import golden
    from video_encoder_tpu.codec.config import EncoderConfig as JConfig
    from video_encoder_tpu.ops import dispatch as jdispatch
    from video_encoder_tpu.pipeline import gop_engine as jgop

    w, h, n = 96, 64, 4
    kw = dict(width=w, height=h, gop_n=n, base_qp=26, **CELLS[cell])
    clips = [_clip(s, w, h, n) for s in (11, 12)]
    jdispatch.force("jnp")
    try:
        jeng = jgop.GopEngine(JConfig(**kw))
        jframes = [[golden.Frame.from_planes(*p) for p in c] for c in clips]
        want = _bytes(jeng.encode_gop(jframes[0], 0)[0])
        want_batch = [_bytes(p) for p, _ in jeng.encode_gops(jframes, [0, n])]
    finally:
        jdispatch.force(None)
    eng = GopEngine(EncoderConfig(**kw), device="cpu", emit=emit)
    outs = eng.run(*eng.upload(
        lambda p: [getattr(f, p) for f in _frames(clips[0])], (n,)), 26)
    assert outs["words"].shape[0] == n and outs["sse"].shape == (n, 3)
    assert _bytes(eng.encode_gop(_frames(clips[0]), 0)[0]) == want
    got = eng.finish(eng.start([_frames(c) for c in clips], [0, n]))
    assert [_bytes(p) for p, _ in got] == want_batch


# ---- on the card ---------------------------------------------------------

def _card_cfg(cell, **kw):
    return EncoderConfig(**{**dict(width=192, height=128, gop_n=6,
                                   base_qp=26), **CELLS[cell], **kw})


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replay_equals_eager_on_card(cuda, cell, emit, g):
    """Calls 1-3 of one key: the eager loop, the capture and its replay,
    a replay. Same packets each time, equal to the CPU's, and the same
    launch counts per GOP."""
    cfg = _card_cfg(cell)
    gops = [_frames(_clip(20 + i, 192, 128, 6)) for i in range(g)]
    firsts = [6 * i for i in range(g)]
    eng = GopEngine(cfg, device=cuda, emit=emit)

    def call():
        if g == 1:
            return [eng.encode_gop(gops[0], 0)]
        return eng.finish(eng.start(gops, firsts))

    runs = [_counted(call) for _ in range(3)]
    want = [_bytes(p) for p, _ in runs[0][0]]
    for got, rise in runs[1:]:
        assert [_bytes(p) for p, _ in got] == want
        assert rise == runs[0][1]
    cpu = GopEngine(cfg, device="cpu", emit=emit)
    assert want == [_bytes(cpu.encode_gop(gp, f)[0]) for gp, f in zip(gops, firsts)]
    graphs = [v for v in eng.graphs.values() if v is not None]
    assert len(graphs) >= 1 and all(v.capture_s > 0 for v in graphs)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replayed_outputs_equal_the_eager_loop_on_card(cuda, cell):
    """Every output tensor of a replay equals the eager loop's (`_run`) on
    the same planes, and is a tensor of the call's own."""
    cfg = _card_cfg(cell)
    eng = GopEngine(cfg, device=cuda)
    frames = _frames(_clip(31, 192, 128, 6))
    y, cb, cr = eng.upload(lambda p: [getattr(f, p) for f in frames], (6,))
    n_mbs = (128 // 16) * (192 // 16)
    bw, cap = eng._capacities(n_mbs, 26, False)
    eager = eng._run(y, cb, cr, torch.full((), 26, dtype=torch.int32,
                                           device=cuda), bw, cap)
    outs = [eng.run(y, cb, cr, 26) for _ in range(3)]
    (graph,) = [v for v in eng.graphs.values() if v is not None]
    for o in outs:
        assert set(o) == set(eager)
        for k in eager:
            assert torch.equal(o[k], eager[k]), k
            assert o[k].data_ptr() != graph.outs[k].data_ptr()


def test_tail_gop_has_its_own_graph_on_card(cuda):
    """A clip's short last GOP is a key of its own (T differs): GOPs of 6
    and 4 frames alternating, each from its second call a replay."""
    cfg = _card_cfg("full")
    clip = _frames(_clip(41, 192, 128, 10))
    eng = GopEngine(cfg, device=cuda)
    runs = [_counted(lambda s=s, e=e: eng.encode_gop(clip[s:e], s)[0])
            for _ in range(3) for s, e in ((0, 6), (6, 10))]
    for i, (got, rise) in enumerate(runs[2:], 2):
        assert _bytes(got) == _bytes(runs[i % 2][0])
        assert rise == runs[i % 2][1]
    assert sorted(k.y_shape[0] for k, v in eng.graphs.items() if v) == [4, 6]


def test_forced_rerun_replays_on_card(cuda):
    """Noise at qp 1 overflows: the worst-case rerun is a key of its own,
    captured at its second call; with two GOPs in flight each rerun reads
    its own GOP's planes, and every GOP gives its eager packets."""
    cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=1)
    clips = [_frames(_noise(s, 64, 48, 3)) for s in (5, 6, 7, 8)]
    want = [_eager(cfg, c, cuda) for c in clips]
    eng = GopEngine(cfg, device=cuda)
    h = [eng.start([clips[0]], [0]), eng.start([clips[1]], [0])]
    got = [eng.finish(h[0])[0]]
    h.append(eng.start([clips[2]], [0]))
    got.append(eng.finish(h[1])[0])
    h.append(eng.start([clips[3]], [0]))
    got += [eng.finish(h[2])[0], eng.finish(h[3])[0]]
    assert [_bytes(g[0]) for g in got] == want
    xl = [v for k, v in eng.graphs.items() if k.cap_words == entropy.max_words(12)]
    assert len(xl) == 1 and xl[0] is not None


def test_sea_toggle_between_calls_on_card(cuda, monkeypatch):
    """TVC_SEA is read at every call and baked into a capture: turning it
    on between two calls makes a new key, whose replays launch the SEA
    search and not the exhaustive one, with the same packets."""
    monkeypatch.delenv("TVC_SEA", raising=False)
    cfg = _card_cfg("full")
    frames = _frames(_clip(51, 192, 128, 6))
    eng = GopEngine(cfg, device=cuda)
    off = [_counted(lambda: eng.encode_gop(frames, 0)[0]) for _ in range(2)]
    monkeypatch.setenv("TVC_SEA", "1")
    on = [_counted(lambda: eng.encode_gop(frames, 0)[0]) for _ in range(3)]
    want = _bytes(off[0][0])
    assert all(_bytes(p) == want for p, _ in off + on)
    assert off[1][1] == off[0][1] and on[2][1] == on[1][1] == on[0][1]
    assert on[2][1]["full_search_sea"] == 5 and "full_search" not in on[2][1]
    assert off[1][1]["full_search"] == 5 and "full_search_sea" not in off[1][1]
    assert sum(v is not None for v in eng.graphs.values()) == 2


def test_replay_on_another_stream_raises_on_card(cuda):
    """An engine's graphs replay on one stream (the merges' overflow
    ticket is one per device, and the graphs share a memory pool): a call
    from another stream raises instead of replaying there."""
    frames = _frames(_clip(71, 96, 64, 3))
    eng = GopEngine(EncoderConfig(width=96, height=64, gop_n=3), device=cuda)
    want = _bytes(eng.encode_gop(frames, 0)[0])
    assert _bytes(eng.encode_gop(frames, 0)[0]) == want     # the capture
    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        with pytest.raises(RuntimeError, match="one stream"):
            eng.encode_gop(frames, 0)
    assert _bytes(eng.encode_gop(frames, 0)[0]) == want


def test_cli_double_buffered_encode_on_card(cuda, tmp_path, capsys):
    """The CLI launches GOP k + 1 before it drains GOP k: 4 GOPs of 4
    frames and a tail of 2, from the second GOP on through the graph, give
    the CPU's file."""
    clip = _clip(61, 96, 64, 18)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    files = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.tvc"
        assert cli.main(["encode", "-i", str(path), "-W", "96", "-H", "64",
                         "-o", str(out), "--gop", "4", "--search", "diamond",
                         "--rc", "mb", "--kbps", "300", "--device",
                         device]) == 0
        files[device] = out.read_bytes()
    capsys.readouterr()
    assert files["cuda"] == files["cpu"]


_GRAPH_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine
from video_encoder_tpu_torch.utils.trace import trace

rng = np.random.default_rng(3)
y = torch.from_numpy(rng.integers(0, 256, (4, 64, 96), dtype=np.uint8)).cuda()
cb, cr = (torch.from_numpy(rng.integers(0, 256, (4, 32, 48), dtype=np.uint8)
                           ).cuda() for _ in range(2))
eng = GopEngine(EncoderConfig(width=96, height=64, gop_n=4), device="cuda")
if sys.argv[1] == "trace":       # a replay's trace names the graph's kernels
    eng.run(y, cb, cr, 28)
    eng.run(y, cb, cr, 28)
    torch.cuda.synchronize()
    with trace(sys.argv[2]):
        eng.run(y, cb, cr, 28)
        torch.cuda.synchronize()
    import glob, os
    (path,) = glob.glob(os.path.join(sys.argv[2], "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    print(json.dumps([e["name"] for e in events if e.get("cat") == "kernel"]))
else:                           # a host sync inside the body fails the capture
    loop = eng._run

    def synced(*args):
        out = loop(*args)
        bool(out["ovf"].any())
        return out

    eng._run = synced
    eng.run(y, cb, cr, 28)       # the eager first call may sync
    for _ in range(2):
        try:
            eng.run(y, cb, cr, 28)
        except RuntimeError as e:
            print("RAISED", str(e).splitlines()[0][:200])
        else:
            print("NO RAISE")
    print("GRAPHS", sum(v is not None for v in eng.graphs.values()))
"""


def _graph_script(*args):
    r = subprocess.run([sys.executable, "-c", _GRAPH_SCRIPT, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()


def test_replay_trace_names_the_kernels_on_card(cuda, tmp_path):
    """torch.profiler over one replay records the graph's kernels under
    their own names (a process of its own, as `encode --trace` runs)."""
    names = json.loads(_graph_script("trace", str(tmp_path))[-1])
    for k in ("tiled_kernel", "plane_kernel", "block_pack_kernel"):
        assert any(k in n for n in names), (k, sorted(set(names)))


def test_host_sync_in_the_body_fails_the_capture_on_card(cuda):
    """A host read inside the captured loop raises at every capture, and
    nothing falls back to the eager loop: no graph is kept, no result is
    returned."""
    out = _graph_script("sync")
    assert [ln.split()[0] for ln in out[-3:]] == ["RAISED", "RAISED", "GRAPHS"]
    assert out[-1] == "GRAPHS 0"
