"""The device decoders as one captured CUDA graph per key
(`pipeline/decoder.py` GopDecodeEngine.run per DecodeKey and
DeviceDecodeEngine.decode per DecodeFrameKey, both through
`pipeline/gop_engine.py` GraphCache): the port's counterparts of the
reference's jitted `_decode_gop_jit` and `DeviceDecodeEngine._recon`.

On the CPU: each key changes with every static argument, the shape, the
frame count, the I/P pattern and `dispatch.force`, and not with the
chroma qp offset (applied on the host); CPU decoders build no graph;
through the seam of tests/test_torch_graphs.py (a fake `_capture` and
"cpu" in `_GRAPH_DEVICE_TYPES`) a stream of three GOPs and a tail at
formats 1-4 decodes (eager, capture, replay, the tail eager) to the
reference's GopDecodeEngine on the CPU and to `decode_clip_native`,
through both engines; two GOPs in flight keep their own bytes; a replay
raises `build.LAUNCHES` by the counts recorded at capture; a GOP whose
first frame is P (the zero references) is a key of its own.

On the card (tests that take the `cuda` fixture skip without one):
replay equals the eager loop at formats 1 and 4; `decode --engine gop`
and `--engine device` of a three-GOP 1080p stream with a tail equal
`--engine native`'s file; a host sync in either body makes the capture
raise. The card host has no JAX: there run

    python -m pytest tests/test_torch_graphs_decode.py --noconftest -q

where the JAX comparisons skip. Tolerance 0: the codec is integer-only.
"""

import contextlib
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.codec import bitstream
from video_encoder_tpu_torch.codec.bitstream import OrderedMux
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.ops.kernels import build
from video_encoder_tpu_torch.pipeline import decoder, gop_engine
from video_encoder_tpu_torch.pipeline.decoder import (DeviceDecodeEngine,
                                                      GopDecodeEngine)
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


@contextlib.contextmanager
def _eager_types():
    """No device type runs graphs while the block runs: every call eager."""
    saved = gop_engine._GRAPH_DEVICE_TYPES
    gop_engine._GRAPH_DEVICE_TYPES = ()
    try:
        yield
    finally:
        gop_engine._GRAPH_DEVICE_TYPES = saved


def _stream(cfg, clip, device="cpu"):
    """The TVC1 stream of the port's GOP engine, its loop eager: GOPs of
    cfg.gop_n frames and the tail."""
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, len(clip))
    eng = GopEngine(cfg, device=device)
    frames = [Frame.from_planes(*p) for p in clip]
    with _eager_types():
        for i in range(0, len(frames), cfg.gop_n):
            for pkt in eng.encode_gop(frames[i:i + cfg.gop_n], i)[0]:
                mux.push(pkt)
    mux.close()
    return buf.getvalue()


def _frames(run, data):
    _, frames = run(io.BytesIO(data))
    return [tuple(np.asarray(p) for p in f) for f in frames]


def _same(got, want):
    return len(got) == len(want) and all(
        all(a.dtype == np.uint8 and np.array_equal(a, b) for a, b in zip(x, y))
        for x, y in zip(got, want))


def _counted(fn):
    """(fn(), the rise of build.LAUNCHES over the call)."""
    before = dict(build.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in build.LAUNCHES.items()
                 if v != before[k]}


def _parsed(eng, data):
    """(info, the host-parsed GOPs of a stream) for a GopDecodeEngine."""
    info, packets = bitstream.demux(io.BytesIO(data))
    decoder._take_stream_fields(eng, info)
    return info, [eng.parse(info.width, info.height, gop)
                  for gop in decoder._gops(packets)]


# ---- (a) the keys --------------------------------------------------------

_KBASE = dict(version=3, chroma_qp_offset=2, quant_matrix=False,
              intra_slice=1)


def _gop_key(eng=None, shape=(4, 6, 8, 64), is_p=(False, True, True, True)):
    eng = GopDecodeEngine(**{**_KBASE, **(eng or {})}, device="cpu")
    return eng.key(shape, is_p)


def _frame_key(eng=None, is_p=True, has_ref=True, hp=48, wp=64):
    eng = DeviceDecodeEngine(**{**_KBASE, **(eng or {})}, device="cpu")
    return eng.key(is_p, has_ref, hp, wp)


def _forced(fn):
    dispatch.force("plain")
    try:
        return fn()
    finally:
        dispatch.force(None)


@pytest.mark.parametrize("change,same", [
    ("equal", True), ("cqpo", True), ("fmt", False), ("qmat", False),
    ("islice", False), ("T", False), ("H", False), ("W", False),
    ("is_p", False), ("first_p", False), ("force", False)])
def test_decode_key_changes_with_each_static_argument(change, same):
    """Equal inputs give equal keys; each argument `_decode_gop_jit` takes
    as static but the chroma qp offset (the host's plane_qsteps applies
    it: the body never sees it), the frame count, the padded size, the
    I/P pattern (a GOP that starts with a P frame rebuilds from zero
    planes) and the route change it."""
    base = _gop_key()
    got = {
        "equal": lambda: _gop_key(),
        "cqpo": lambda: _gop_key(dict(chroma_qp_offset=-3)),
        "fmt": lambda: _gop_key(dict(version=4)),
        "qmat": lambda: _gop_key(dict(quant_matrix=True)),
        "islice": lambda: _gop_key(dict(intra_slice=2)),
        "T": lambda: _gop_key(shape=(3, 6, 8, 64), is_p=(False, True, True)),
        "H": lambda: _gop_key(shape=(4, 8, 8, 64)),
        "W": lambda: _gop_key(shape=(4, 6, 10, 64)),
        "is_p": lambda: _gop_key(is_p=(False, True, False, True)),
        "first_p": lambda: _gop_key(is_p=(True, True, True, True)),
        "force": lambda: _forced(_gop_key),
    }[change]()
    assert (got == base) == same
    assert (base.t_frames, base.hp, base.wp) == (4, 48, 64)


@pytest.mark.parametrize("change,same", [
    ("equal", True), ("cqpo", True), ("is_p", False), ("has_ref", False),
    ("fmt", False), ("qmat", False), ("islice", False), ("H", False),
    ("W", False), ("force", False)])
def test_frame_key_changes_with_each_argument(change, same):
    """The per-frame decoder's key: the reference `_recon`'s static
    arguments but the chroma qp offset, whether a P frame has reference
    planes, the padded size and the route."""
    base = _frame_key()
    got = {
        "equal": lambda: _frame_key(),
        "cqpo": lambda: _frame_key(dict(chroma_qp_offset=0)),
        "is_p": lambda: _frame_key(is_p=False, has_ref=True),
        "has_ref": lambda: _frame_key(has_ref=False),
        "fmt": lambda: _frame_key(dict(version=2)),
        "qmat": lambda: _frame_key(dict(quant_matrix=True)),
        "islice": lambda: _frame_key(dict(intra_slice=0)),
        "H": lambda: _frame_key(hp=64),
        "W": lambda: _frame_key(wp=80),
        "force": lambda: _forced(_frame_key),
    }[change]()
    assert (got == base) == same


# ---- (b) no graph on the CPU ---------------------------------------------

def test_cpu_decoders_never_build_a_graph(monkeypatch):
    def refuse(body, pool):
        raise AssertionError("a CPU decoder captured a graph")

    monkeypatch.setattr(gop_engine, "_capture", refuse)
    cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=26)
    data = _stream(cfg, _clip(1, 64, 48, 11))
    want = _frames(decoder.decode_clip_native, data)
    gop, dev = GopDecodeEngine(device="cpu"), DeviceDecodeEngine(device="cpu")
    for _ in range(2):
        assert _same(_frames(lambda f: decoder.decode_clip_gop(f, gop), data),
                     want)
        assert _same(_frames(lambda f: decoder.decode_clip(f, dev), data),
                     want)
    assert gop.graphs == {} and dev.graphs == {}


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
    """Graphs on the CPU through the seam, and the decode path's three
    wrappers counted in build.LAUNCHES as their kernel wrappers count
    them on the card."""
    made = []

    def capture(body, pool):
        outs = body()
        made.append(_FakeGraph(body, outs))
        return made[-1], outs

    def counted(name, fn):
        def call(*args, **kw):
            build.LAUNCHES[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(gop_engine, "_capture", capture)
    monkeypatch.setattr(gop_engine, "_GRAPH_DEVICE_TYPES", ("cpu",))
    for attr, name in (("recon_plane", "recon_plane"),
                       ("intra_rows_recon_plane", "recon_plane_rows"),
                       ("mc_predict", "mc_predict")):
        monkeypatch.setattr(dispatch, attr,
                            counted(name, getattr(dispatch, attr)))
    return made


# name -> config fields: formats 1-4 with what each adds (the chroma qp
# offset, the quant matrix, intra slices, half-pel vectors)
_FORMATS = {
    1: dict(),
    2: dict(format_version=2, chroma_qp_offset=3),
    3: dict(format_version=3, quant_matrix=True, intra_slice_mbrows=1),
    4: dict(format_version=4, quant_matrix=True, chroma_qp_offset=2,
            intra_slice_mbrows=2),
}
_STREAMS = {}


def _format_stream(fmt):
    """(data, the reference's decoded frames) of 11 frames at 64x48 in GOPs
    of 3: three GOPs and a tail of 2, encoded once per format. The
    reference is the JAX package's GopDecodeEngine on its jnp path (on the
    CPU under the tests' conftest) where JAX is importable, else the C++
    decoder."""
    if fmt not in _STREAMS:
        cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=26,
                            **_FORMATS[fmt])
        data = _stream(cfg, _clip(10 + fmt, 64, 48, 11))
        native = _frames(decoder.decode_clip_native, data)
        try:
            from video_encoder_tpu.ops import dispatch as jdispatch
            from video_encoder_tpu.pipeline import decoder as jdec
        except ImportError:
            want = native
        else:
            jdispatch.force("jnp")
            try:
                want = _frames(jdec.decode_clip_gop, data)
            finally:
                jdispatch.force(None)
            assert _same(native, want)
        assert len(want) == 11
        _STREAMS[fmt] = data, want
    return _STREAMS[fmt]


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_gop_decoder_replays_to_the_reference(fake_graphs, fmt):
    """`decode_clip_gop` through the fake graph: GOP 1 eager, GOP 2 the
    capture and its replay, GOP 3 a replay, the tail's key eager; every
    frame equals the reference's GopDecodeEngine (JAX on the CPU) and the
    C++ decoder, and each GOP raises the launch counts as the eager loop
    does."""
    data, want = _format_stream(fmt)
    eng = GopDecodeEngine(device="cpu")
    rises = []
    real = eng.run

    def run(dev):
        out, rise = _counted(lambda: real(dev))
        rises.append(rise)
        return out

    eng.run = run
    assert _same(_frames(lambda f: decoder.decode_clip_gop(f, eng), data),
                 want)
    full = {"mc_predict": 2, "recon_plane": 6 if fmt >= 3 else 9}
    tail = {"mc_predict": 1, "recon_plane": 3 if fmt >= 3 else 6}
    if fmt >= 3:
        full["recon_plane_rows"] = tail["recon_plane_rows"] = 3
    assert rises == [full, full, full, tail]
    graphs = {k.t_frames: v for k, v in eng.graphs.items()}
    assert graphs[2] is None and graphs[3] is not None
    assert graphs[3].launches == full
    assert len(fake_graphs) == 1 and fake_graphs[0].replays == 2


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_device_decoder_replays_to_the_reference(fake_graphs, fmt):
    """`decode_clip` through the fake-graphed DeviceDecodeEngine: the P
    key eager at frame 1, captured at frame 2, replayed from frame 4 on
    (across GOPs), the I key eager in GOP 1, captured in GOP 2 and
    replayed in GOP 3 and the tail; every frame equals the reference's decode, and
    the recon the engine keeps is a replay's own copy."""
    data, want = _format_stream(fmt)
    eng = DeviceDecodeEngine(device="cpu")
    assert _same(_frames(lambda f: decoder.decode_clip(f, eng), data), want)
    keys = {k.is_p: v for k, v in eng.graphs.items()}
    assert set(keys) == {False, True} and all(keys.values())
    assert all(k.has_ref for k in eng.graphs if k.is_p)
    # 7 P frames: eager, capture (and replay), 5 replays; 4 I frames:
    # eager, capture (and replay), 2 replays
    assert sorted(g.replays for g in fake_graphs) == [3, 6]
    static = {t.data_ptr() for t in keys[True].outs["rec"]}
    assert not static & {t.data_ptr() for t in eng._last[1]}


def test_two_gops_in_flight_keep_their_own_bytes(fake_graphs):
    """GOP k + 1 is parsed, uploaded and launched before GOP k is
    downloaded (decode_clip_gop's order): each handle's bytes are its own
    copy, not the graph's static output, which the next replay
    overwrites."""
    cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=26)
    data = _stream(cfg, _clip(3, 64, 48, 9))
    info, packets = bitstream.demux(io.BytesIO(data))
    gops = list(decoder._gops(packets))
    eng = GopDecodeEngine(device="cpu")
    with _eager_types():
        want = [eng.decode_gop_finish(eng.decode_gop_start(64, 48, g))
                for g in gops]
    assert eng.graphs == {}
    handles, got = [], []
    for i in (0, 1, 2, 0, 1):            # eager, capture, then replays
        handles.append((i, eng.decode_gop_start(64, 48, gops[i])))
        if len(handles) > 1:
            j, prev = handles[-2]
            got.append((j, eng.decode_gop_finish(prev)))
    got.append((handles[-1][0], eng.decode_gop_finish(handles[-1][1])))
    for j, frames in got:
        assert _same([tuple(f) for f in frames], [tuple(f) for f in want[j]])
    (graph,) = [v for v in eng.graphs.values() if v is not None]
    assert fake_graphs[0].replays == 4 and graph.capture_s >= 0
    static = graph.outs["out"].data_ptr()
    assert all(h["out"].data_ptr() != static for _, h in handles)


def test_first_p_gop_is_a_key_of_its_own(fake_graphs):
    """A GOP whose first frame is P rebuilds from zero planes
    (recon_frame's zero references): its key differs from the GOP's that
    starts with its I frame, and its replays give the eager loop's bytes
    with the eager loop's launch counts."""
    cfg = EncoderConfig(width=64, height=48, gop_n=4, base_qp=26)
    eng = GopDecodeEngine(device="cpu")
    _, (host,) = _parsed(eng, _stream(cfg, _clip(4, 64, 48, 4)))
    p_only = {k: v[1:] for k, v in host.items()}
    assert all(p_only["is_p"])
    dev = eng.upload(p_only)
    with _eager_types():
        want, eager = _counted(lambda: eng.run(dev))
    for _ in range(3):
        got, rise = _counted(lambda: eng.run(dev))
        assert torch.equal(got, want) and rise == eager
    assert eager == {"mc_predict": 3, "recon_plane": 9}
    full = eng.key(eng.upload(host)["ly"].shape, host["is_p"])
    (key,) = eng.graphs
    assert key.is_p == (True, True, True) and key != full
    assert fake_graphs[0].replays == 2


# ---- on the card ---------------------------------------------------------

@pytest.mark.parametrize("fmt", [1, 4])
def test_replay_equals_eager_on_card(cuda, fmt):
    """Calls 1-3 of one GOP key (the eager loop, the capture and its
    replay, a replay) give the eager loop's bytes with its launch counts,
    each a tensor of the call's own; the per-frame decoder through its
    graphs gives the C++ decoder's frames."""
    cfg = EncoderConfig(width=192, height=128, gop_n=4, base_qp=26,
                        **_FORMATS[fmt])
    data = _stream(cfg, _clip(30 + fmt, 192, 128, 14), device=cuda)
    eng = GopDecodeEngine(device=cuda)
    _, gops = _parsed(eng, data)
    dev = eng.upload(gops[0])
    is_p = tuple(dev["is_p"])
    eager, eager_rise = _counted(lambda: eng._recon_gop(
        is_p, *(dev[k] for k in decoder.GOP_INPUTS))["out"])
    for _ in range(3):
        got, rise = _counted(lambda: eng.run(dev))
        assert rise == eager_rise and torch.equal(got, eager)
    (graph,) = [v for v in eng.graphs.values() if v is not None]
    assert graph.capture_s > 0 and got.data_ptr() != graph.outs[
        "out"].data_ptr()
    want = _frames(decoder.decode_clip_native, data)
    assert _same(_frames(lambda f: decoder.decode_clip_gop(
        f, GopDecodeEngine(device=cuda)), data), want)
    per_frame = DeviceDecodeEngine(device=cuda)
    assert _same(_frames(lambda f: decoder.decode_clip(f, per_frame), data),
                 want)
    assert sum(v is not None for v in per_frame.graphs.values()) == 2


@pytest.mark.parametrize("engine", ["gop", "device"])
def test_cli_decode_of_three_gops_equals_native_on_card(cuda, tmp_path,
                                                         capsys, engine):
    """`decode --engine gop|device` of a 1080p stream of three GOPs of 3
    and a tail of 2 (the third GOP a replay, the tail a key of its own)
    gives `--engine native`'s file."""
    cfg = EncoderConfig(width=1920, height=1080, gop_n=3, base_qp=28)
    stream = tmp_path / "s.tvc"
    stream.write_bytes(_stream(cfg, _clip(41, 1920, 1080, 11), device=cuda))
    files = {}
    for name, flags in (("native", ["--engine", "native"]),
                        (engine, ["--engine", engine, "--device", "cuda"])):
        out = tmp_path / f"{name}.yuv"
        assert cli.main(["decode", "-i", str(stream), "-o", str(out),
                         *flags]) == 0
        files[name] = out.read_bytes()
    capsys.readouterr()
    assert len(files["native"]) == 11 * 1920 * 1080 * 3 // 2
    assert files[engine] == files["native"]


_SYNC_SCRIPT = r"""
import io
import sys
import numpy as np
import torch
from video_encoder_tpu_torch.codec import bitstream
from video_encoder_tpu_torch.codec.bitstream import OrderedMux
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline import decoder
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

rng = np.random.default_rng(3)
cfg = EncoderConfig(width=96, height=64, gop_n=4)
clip = [(rng.integers(0, 256, (64, 96), dtype=np.uint8),
         rng.integers(0, 256, (32, 48), dtype=np.uint8),
         rng.integers(0, 256, (32, 48), dtype=np.uint8)) for _ in range(4)]
buf = io.BytesIO()
mux = OrderedMux(buf, cfg, 4)
for pkt in GopEngine(cfg, device="cuda").encode_gop(
        [Frame.from_planes(*p) for p in clip], 0)[0]:
    mux.push(pkt)
mux.close()
info, packets = bitstream.demux(io.BytesIO(buf.getvalue()))
packets = list(packets)
recon = decoder.recon_frame


def synced(*args, **kw):
    out = recon(*args, **kw)
    bool(out[0].any())
    return out


def attempt(call):
    try:
        call()
    except RuntimeError as e:
        print("RAISED", str(e).splitlines()[0][:200])
    else:
        print("NO RAISE")


decoder.recon_frame = synced
if sys.argv[1] == "gop":
    eng = decoder.GopDecodeEngine(device="cuda")
    dev = eng.upload(eng.parse(96, 64, packets))
    eng.run(dev)                   # the eager first call may sync
    for _ in range(2):
        attempt(lambda: eng.run(dev))
else:
    eng = decoder.DeviceDecodeEngine(device="cuda")
    ref = eng.decode(96, 64, packets[0], None)
    ref = eng.decode(96, 64, packets[1], ref)      # eager: may sync
    for _ in range(2):
        attempt(lambda: eng.decode(96, 64, packets[2], ref))
print("GRAPHS", sum(v is not None for v in eng.graphs.values()))
"""


@pytest.mark.parametrize("engine", ["gop", "device"])
def test_host_sync_in_the_body_fails_the_capture_on_card(cuda, engine):
    """A host read inside either decoder's captured body raises at every
    capture, and nothing falls back to the eager call: no graph is kept,
    no result is returned (a process of its own)."""
    r = subprocess.run([sys.executable, "-c", _SYNC_SCRIPT, engine],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert [ln.split()[0] for ln in out[-3:]] == ["RAISED", "RAISED", "GRAPHS"]
    assert out[-1] == "GRAPHS 0"
