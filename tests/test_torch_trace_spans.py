"""The port's recorder (`utils/trace.py` Recorder and RECORDER) and the
spans and counts the program writes into it, on the CPU.

The recorder: nesting and parents, StageTimer's report, the ring's bound
and what it drops, `enabled`, and the anchor that puts a span on the
profiler's clock. The profiler: a profiled encode holds no span of the
program unless trace() (the CLI's `--trace`) turns the annotation on, and
then holds them. The program: GraphCache's eager, capture and replay
counts and per-key stats() through the capture seam of
tests/test_torch_graphs.py (a fake `_capture`, "cpu" in
`_GRAPH_DEVICE_TYPES`), the spans and bytes of GopEngine.download and
gop_packets, the upload's spans, the overflow reruns, and the CLI's
`--stage-timers` summary.
"""

import json
import time

import numpy as np
import pytest
import torch

from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.ops.kernels import build
from video_encoder_tpu_torch.pipeline import gop_engine
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine
from video_encoder_tpu_torch.utils import trace as tr
from video_encoder_tpu_torch.utils.trace import RECORDER, Recorder, StageTimer

torch.set_num_threads(1)

W, H = 48, 32
# every span the program opens
SPANS = {"engine.upload", "engine.upload.stack", "engine.upload.copy",
         "engine.eager", "engine.capture", "engine.launch", "engine.copy_in",
         "engine.replay", "engine.copy_out", "finish.wait", "finish.copy",
         "finish.copy.meta", "finish.copy.words", "finish.packets"}


@pytest.fixture
def recorder():
    """RECORDER emptied, on, not annotating; left so."""
    RECORDER.reset()
    RECORDER.enabled, RECORDER.annotate = True, False
    yield RECORDER
    RECORDER.enabled, RECORDER.annotate = True, False


@pytest.fixture
def clock(monkeypatch):
    """perf_counter_ns and perf_counter on one fake clock that steps 10 ns
    (0.01 us) at each reading."""
    now = [1_000]

    def ns():
        now[0] += 10
        return now[0]

    monkeypatch.setattr(time, "perf_counter_ns", ns)
    monkeypatch.setattr(time, "perf_counter", lambda: ns() / 1e9)
    return now


def _planes(seed, n, noise=False, w=W, h=H):
    """n frames' uint8 (y, cb, cr): a smoothed texture moving 1 px a frame,
    flat chroma; or noise in every plane."""
    rng = np.random.default_rng(seed)
    if noise:
        return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
                 rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                 rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
                for _ in range(n)]
    base = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int64)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, (1, 1), (0, 1))) // 4
    return [(base[t:t + h, t:t + w].astype(np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for t in range(n)]


def _clip(seed, n, noise=False, w=W, h=H):
    return [Frame.from_planes(*p) for p in _planes(seed, n, noise, w, h)]


def _yuv(path, seed, n):
    """A raw I420 file of n frames of _planes."""
    with open(path, "wb") as f:
        for planes in _planes(seed, n):
            f.write(b"".join(p.tobytes() for p in planes))
    return str(path)


def _spans(rec, name=None):
    return [r for r in rec.records() if r[5] is None
            and (name is None or r[1] == name)]


def _counts(rec, name):
    return [r for r in rec.records() if r[1] == name and r[5] is not None]


# ---- the recorder --------------------------------------------------------

def test_spans_nest_with_their_parents(clock):
    rec = Recorder(size=16)
    with rec.span("a"):
        with rec.span("b"):
            rec.count("n", 5)
            with rec.span("c"):
                pass
        with rec.span("d"):
            pass
    rows = {r[1]: r for r in rec.records()}
    assert [r[1] for r in rec.records()] == ["a", "b", "n", "c", "d"]
    seq = {name: r[0] for name, r in rows.items()}
    assert rows["a"][4] == -1 and rows["b"][4] == seq["a"]
    assert rows["n"][4] == seq["b"] and rows["c"][4] == seq["b"]
    assert rows["d"][4] == seq["a"]
    assert rows["n"][5] == 5 and rows["c"][5] is None
    for name in "abcd":       # inside its parent, and ended
        s, e, parent = rows[name][2], rows[name][3], rows[name][4]
        assert 0 < s < e
        if parent >= 0:
            p = [r for r in rec.records() if r[0] == parent][0]
            assert p[2] < s and e < p[3]
    assert rec.counters == {"n": 5} and rec.open == []


def test_report_is_the_stage_timers(clock):
    """report() has StageTimer's format and, on one clock, its numbers."""
    rec, st = Recorder(size=16), StageTimer()
    for name in ("b", "a", "b"):
        with rec.span(name):
            pass
        with st.stage(name):
            pass
    assert rec.report() == st.report()
    assert list(rec.report()) == ["a", "b"] and rec.report()["b"]["count"] == 2
    assert json.loads(rec.to_json()) == rec.report()


@pytest.mark.parametrize("n", [5, 8, 20, 100])
def test_ring_keeps_the_last_records_and_counts_what_it_drops(clock, n):
    rec = Recorder(size=8)
    for k in range(n):
        with rec.span(f"s{k}"):
            pass
    assert rec.dropped == max(0, n - 8) and rec.written == n
    kept = rec.records()
    assert [r[1] for r in kept] == [f"s{k}" for k in range(max(0, n - 8), n)]
    assert rec.oldest_ns() == kept[0][2]
    assert all(kept[0][2] <= r[2] for r in kept)
    assert rec.counts[f"s{n - 1}"] == 1 and len(rec.report()) == n


def test_a_span_the_ring_went_round_inside_is_dropped(clock):
    """A span that stays open while the ring wraps loses its slot to a
    later record; its close writes nothing there, its totals still
    count."""
    rec = Recorder(size=4)
    with rec.span("outer"):
        for _ in range(6):
            rec.count("n")
    assert [r[1] for r in rec.records()] == ["n"] * 4
    assert rec.dropped == 3 and rec.counts["outer"] == 1
    assert rec.counters["n"] == 6


def test_disabled_records_nothing(clock):
    rec = Recorder(size=8)
    rec.enabled = False
    with rec.span("a"):
        rec.count("n", 3)
    assert rec.written == 0 and rec.records() == [] and rec.oldest_ns() is None
    assert rec.report() == {} and dict(rec.counters) == {}
    rec.enabled = True
    with rec.span("a"):
        pass
    assert [r[1] for r in rec.records()] == ["a"]


def test_a_span_closes_on_an_exception(clock):
    rec = Recorder(size=8)
    with pytest.raises(KeyError):
        with rec.span("a"):
            with rec.span("b"):
                raise KeyError("x")
    assert rec.open == [] and [r[1] for r in rec.records()] == ["a", "b"]
    assert all(r[3] > r[2] for r in rec.records())


def test_reset_and_size():
    rec = Recorder(size=8)
    with rec.span("a"):
        rec.count("n")
    old = rec.anchor
    rec.reset()
    assert rec.records() == [] and rec.report() == {} and not rec.counters
    assert rec.anchor[0] >= old[0]
    with pytest.raises(ValueError, match="power of 2"):
        Recorder(size=12)
    assert RECORDER.size == Recorder.SIZE == 2**16 and RECORDER.enabled


def test_anchor_puts_a_span_on_the_profilers_clock(recorder):
    """A span's start, mapped by the anchor onto the epoch clock, lies
    within 100 us of the start of the record_function event of the same
    span in a CPU profile: in at least one of five spans, as a span here
    can lose the processor between the two readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with record_function("warm"):        # the first call's set-up
        pass
    recorder.annotate = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with recorder.span("finish.copy"):
                torch.ones(8).sum()
    recorder.annotate = False
    mine = _spans(recorder, "finish.copy")
    theirs = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "finish.copy")
    assert len(theirs) == len(mine) == 5
    offsets = [abs(recorder.epoch_ns(m[2]) - t) for m, t in zip(mine, theirs)]
    assert min(offsets) < 100_000, offsets


# ---- the profiler sees the spans only when asked ------------------------

def _encode(eng, frames):
    return eng.finish(eng.start([frames], [0]))[0]


def test_a_profiled_encode_holds_no_span_unless_asked(recorder):
    """The benchmark's traced window takes every event that is not its own
    span as the device's work: with the recorder not told to annotate, a
    profile of an encode holds none of the program's span names."""
    from torch.profiler import ProfilerActivity, profile

    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _encode(eng, _clip(1, 2))
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & SPANS
    assert {r[1] for r in _spans(recorder)} >= {
        "engine.upload", "engine.eager", "finish.wait", "finish.copy",
        "finish.packets"}


def test_trace_annotates_the_program_spans(recorder, tmp_path):
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    with tr.trace(str(tmp_path / "t")):
        assert recorder.annotate
        _encode(eng, _clip(1, 2))
    assert not recorder.annotate
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert names >= SPANS - {"engine.capture", "engine.launch",
                             "engine.copy_in", "engine.replay",
                             "engine.copy_out"}


def test_cli_trace_holds_the_program_spans(recorder, tmp_path, capsys):
    """`--trace DIR` on a CPU encode through the GOP engine: no graph
    replays on the CPU, so the trace holds the eager call, the copies and
    the packets of the program, each on the host's row."""
    path = _yuv(tmp_path / "in.yuv", 2, 3)
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(tmp_path / "o.tvc"), "--gop", "2",
                     "--engine", "gop", "--device", "cpu",
                     "--trace", str(tmp_path / "t")]) == 0
    (trace_file,) = (tmp_path / "t").glob("*.pt.trace.json")
    events = json.loads(trace_file.read_text())["traceEvents"]
    for name in ("engine.eager", "finish.copy", "finish.packets",
                 "engine.upload", "finish.wait"):
        mine = [e for e in events if e.get("name") == name]
        assert len(mine) == 2 and all(e.get("ph") == "X" for e in mine), name
    assert not recorder.annotate


# ---- the graph cache, through the capture seam --------------------------

class _FakeGraph:
    """torch.cuda.CUDAGraph's stand-in (as tests/test_torch_graphs.py's):
    replay reruns the body into the capture's static outputs, with the
    launch counts put back."""

    def __init__(self, body, outs):
        self.body, self.outs = body, outs

    def replay(self):
        saved = dict(build.LAUNCHES)
        for k, v in self.body().items():
            self.outs[k].copy_(v)
        build.LAUNCHES.update(saved)

    def pool(self):
        return None


@pytest.fixture
def fake_graphs(monkeypatch):
    def capture(body, pool):
        outs = body()
        return _FakeGraph(body, outs), outs

    plain = dispatch.code_plane

    def code_plane(*args):
        build.LAUNCHES["code_plane"] += 1
        return plain(*args)

    monkeypatch.setattr(gop_engine, "_capture", capture)
    monkeypatch.setattr(gop_engine, "_GRAPH_DEVICE_TYPES", ("cpu",))
    monkeypatch.setattr(dispatch, "code_plane", code_plane)


@pytest.mark.parametrize("calls", [1, 2, 4])
def test_graph_cache_counts_eager_capture_and_replays(recorder, fake_graphs,
                                                      calls):
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=3), device="cpu")
    frames = _clip(3, 3)
    for _ in range(calls):
        _encode(eng, frames)
    replays = max(0, calls - 1)
    assert recorder.counters["engine.eager_calls"] == 1
    assert recorder.counters["engine.captures"] == (calls > 1)
    assert recorder.counters["engine.replays"] == replays
    assert "engine.graph_pool_bytes" not in recorder.counters   # CUDA only
    (key,) = eng.cache.graphs
    st = eng.cache.stats()[key]
    assert st["eager_calls"] == 1 and st["eager_ns"] > 0
    assert st["replays"] == replays and st["captures"] == (calls > 1)
    assert st["launches"] == ({"code_plane": 9} if calls > 1 else {})
    assert st["pool_bytes"] is None
    # engine.capture_ns: the eager first call and the capture
    ns = [r[5] for r in _counts(recorder, "engine.capture_ns")]
    assert ns[0] == st["eager_ns"] and sum(ns) == recorder.counters[
        "engine.capture_ns"]
    if calls > 1:
        assert ns[1:] == [st["capture_ns"]]
        assert eng.graphs[key].capture_s == st["capture_ns"] / 1e9
    assert len(_spans(recorder, "engine.eager")) == 1
    assert len(_spans(recorder, "engine.capture")) == (calls > 1)
    launches = _spans(recorder, "engine.launch")
    assert len(launches) == replays
    for name in ("engine.copy_in", "engine.replay", "engine.copy_out"):
        children = _spans(recorder, name)
        assert [r[4] for r in children] == [r[0] for r in launches], name
    # a replay's count sits in its launch
    assert {r[4] for r in _counts(recorder, "engine.replays")} == {
        r[0] for r in launches}


def test_graph_cache_stats_per_key(recorder, fake_graphs):
    """A single GOP and a lockstep batch are two keys, each with its own
    eager call, capture and replays."""
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    frames = _clip(4, 2)
    for _ in range(3):
        _encode(eng, frames)
    for _ in range(2):
        eng.finish(eng.start([frames, frames], [0, 2]))
    stats = eng.cache.stats()
    assert sorted((s["replays"], s["captures"]) for s in stats.values()) == [
        (1, 1), (2, 1)]
    assert {len(k.y_shape) for k in stats} == {3, 4}
    assert recorder.counters["engine.eager_calls"] == 2
    assert recorder.counters["engine.replays"] == 3


def test_a_cpu_engine_counts_eager_calls_only(recorder):
    """On the CPU every call is eager and has no key: no capture time."""
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    for _ in range(3):
        _encode(eng, _clip(5, 2))
    assert recorder.counters["engine.eager_calls"] == 3
    assert "engine.capture_ns" not in recorder.counters
    assert eng.cache.stats() == {}


# ---- the finish ----------------------------------------------------------

@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("g", [1, 2])
def test_download_and_packets_spans_and_bytes(recorder, emit, g):
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu",
                    emit=emit)
    frames = _clip(6, 2)
    outs = (eng.run(*eng.upload(lambda p: [getattr(f, p) for f in frames],
                                (2,)), 28) if g == 1 else
            eng.run_batch(*eng.upload(lambda p: [getattr(f, p) for f in frames
                                                 for _ in range(g)], (2, g)),
                          [28] * g))
    recorder.reset()
    host = eng.download(outs)
    for gi in range(g):
        eng.gop_packets(frames, 0, host if g == 1 else
                        {k: v if v is None else v[:, gi]
                         for k, v in host.items()}, 1.0)
    (copy,) = _spans(recorder, "finish.copy")
    for name in ("finish.copy.meta", "finish.copy.words"):
        (child,) = _spans(recorder, name)
        assert child[4] == copy[0]
    (counted,) = _counts(recorder, "finish.copy_bytes")
    small = 3 + 3 + (outs["cbits"].shape[-1] if emit == "chunks" else 0)
    want = 8 * small * outs["bits"].numel() + host["words"].nbytes
    assert counted[4] == copy[0] and counted[5] == want
    assert host["words"].nbytes == 4 * host["words"].size
    packets = _spans(recorder, "finish.packets")
    assert len(packets) == g and all(r[4] == -1 for r in packets)


def _outs(eng, frames, g, xl=False):
    """run() (g = 1) or run_batch() (g copies of the GOP) of frames."""
    if g == 1:
        return eng.run(*eng.upload(lambda p: [getattr(f, p) for f in frames],
                                   (len(frames),)), 28, xl=xl)
    return eng.run_batch(*eng.upload(lambda p: [getattr(f, p) for f in frames
                                                for _ in range(g)],
                                     (len(frames), g)), [28] * g, xl=xl)


def _halfpel_clip(seed, n, w=64, h=48):
    """n frames panning (+0.5, +0.5) px a frame: each the 2x2 means of a
    smoothed texture twice the size, at an offset growing by one of its
    samples a frame; chroma the same pan at half the size."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (2 * h + 16, 2 * w + 16)).astype(np.int64)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for t in range(n):
        win = big[t:t + 2 * h, t:t + 2 * w]
        y = (win[0::2, 0::2] + win[0::2, 1::2] + win[1::2, 0::2]
             + win[1::2, 1::2] + 2) // 4
        c = win.reshape(h // 2, 4, w // 2, 4).sum((1, 3)) // 16
        frames.append(Frame.from_planes(y.astype(np.uint8),
                                        (64 + c // 2).astype(np.uint8),
                                        (192 - c // 2).astype(np.uint8)))
    return frames


@pytest.mark.parametrize("g", [1, 2])
def test_format4_download_counts_half_pel_and_inter_mbs(recorder, monkeypatch,
                                                        g):
    """A format-4 encode's outputs carry n_hpel, each frame's inter MBs on
    a half-pel vector; download counts the P frames' half-pel MBs and
    inter MBs in `motion.hpel_mbs` and `motion.inter_mbs`, inside its
    `finish.copy` span, equal to the numbers recomputed from the vectors
    and modes the GOP's P frames were coded with."""
    seen = []
    real = gop_engine.predict_p_traced

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[:3])
        return out

    monkeypatch.setattr(gop_engine, "predict_p_traced", spy)
    cfg = EncoderConfig(width=64, height=48, gop_n=4, format_version=4,
                        quant_matrix=True, chroma_qp_offset=2)
    eng = GopEngine(cfg, device="cpu")
    outs = _outs(eng, _halfpel_clip(3, 4), g)
    recorder.reset()
    host = eng.download(outs)
    per_frame = [(int((inter & (((dy | dx) & 1) != 0)).sum()), int(inter.sum()))
                 for dy, dx, inter in seen]
    hpel, inter = map(sum, zip(*per_frame))
    assert 0 < hpel <= inter
    (copy,) = _spans(recorder, "finish.copy")
    (h,) = _counts(recorder, "motion.hpel_mbs")
    (i,) = _counts(recorder, "motion.inter_mbs")
    assert h[4] == copy[0] and i[4] == copy[0]
    assert (h[5], i[5]) == (hpel, inter)
    assert host["n_hpel"].shape == host["n_inter"].shape == outs["bits"].shape
    assert host["n_hpel"][0].sum() == 0
    assert [int(n.sum()) for n in host["n_hpel"][1:]] == [n for n, _ in per_frame]


@pytest.mark.parametrize("fmt", [1, 3])
@pytest.mark.parametrize("g", [1, 2])
def test_formats_below_4_count_no_half_pel(recorder, fmt, g):
    """Below format 4 the outputs carry no n_hpel and download counts
    neither motion count."""
    cfg = EncoderConfig(width=W, height=H, gop_n=2, format_version=fmt,
                        quant_matrix=fmt >= 3)
    eng = GopEngine(cfg, device="cpu")
    outs = _outs(eng, _clip(6, 2), g)
    assert "n_hpel" not in outs
    recorder.reset()
    host = eng.download(outs)
    assert "n_hpel" not in host
    assert not _counts(recorder, "motion.hpel_mbs")
    assert not _counts(recorder, "motion.inter_mbs")


def _plain_words(outs):
    """The words as download copied them before the staging buffer: the
    slice to the longest payload or string, .cpu(), viewed as uint32."""
    bits = (outs["cbits"] if "cbits" in outs else outs["bits"]).max()
    maxw = int(bits + 31) // 32
    if "cbits" in outs:
        maxw = max(maxw, 1)
    return outs["words"][..., :maxw].cpu().numpy().view(np.uint32)


def _packets(eng, frames, host, g):
    return [p.to_bytes() for gi in range(g)
            for p in eng.gop_packets(frames, 0, host if g == 1 else
                                     {k: v if v is None else v[:, gi]
                                      for k, v in host.items()}, 1.0)[0]]


@pytest.fixture
def fake_staging(monkeypatch):
    """The staging path on the CPU: "cpu" among the staging devices and
    _pinned an ordinary tensor; the sizes it was asked for."""
    made = []

    def pinned(n, dtype):
        made.append(n)
        return torch.empty(n, dtype=dtype)

    monkeypatch.setattr(gop_engine, "_STAGING_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(gop_engine, "_pinned", pinned)
    return made


@pytest.mark.parametrize("emit", ["frame", "chunks"])
def test_a_cpu_download_stages_nothing(recorder, emit):
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu",
                    emit=emit)
    frames = _clip(6, 2)
    for _ in range(2):
        outs = _outs(eng, frames, 1)
        host = eng.download(outs)
        assert np.array_equal(host["words"], _plain_words(outs))
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [0, 0]
    assert "finish.staging_bytes" not in recorder.counters
    assert eng._staging is None


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("g", [1, 2])
def test_copy_bytes_and_words_unchanged(recorder, request, emit, g, staged):
    """finish.copy_bytes counts the bytes of the two host arrays of the
    plain copy, staged or not, and the words are the plain copy's."""
    if staged:
        request.getfixturevalue("fake_staging")
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu",
                    emit=emit)
    outs = _outs(eng, _clip(6, 2), g)
    recorder.reset()
    host = eng.download(outs)
    plain = _plain_words(outs)
    assert host["words"].shape == plain.shape
    assert host["words"].tobytes() == plain.tobytes()
    small = 3 + 3 + (outs["cbits"].shape[-1] if emit == "chunks" else 0)
    (counted,) = _counts(recorder, "finish.copy_bytes")
    assert counted[5] == 8 * small * outs["bits"].numel() + plain.nbytes
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [
        int(staged)]


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_small_columns_outlive_the_next_download(recorder, request, g,
                                                 staged):
    """A second download of other outputs leaves the first download's
    small columns as they were: they are the caller's own. Its words
    share the staging buffer, which the second download overwrites."""
    if staged:
        request.getfixturevalue("fake_staging")
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    first = eng.download(_outs(eng, _clip(6, 2), g))
    kept = {k: v.copy() for k, v in first.items() if v is not None}
    second = eng.download(_outs(eng, _clip(12, 2, noise=True), g))
    assert not np.array_equal(second["sse"], kept["sse"])
    for k in ("bits", "n_inter", "qp", "sse"):
        assert np.array_equal(first[k], kept[k])
        assert not np.shares_memory(first[k], second[k])
    assert np.shares_memory(first["words"], second["words"]) == staged


def test_one_staging_buffer_until_a_larger_budget(recorder, fake_staging):
    """Three downloads of one key make one buffer, the size of the key's
    words; a larger budgeted key makes it again, a smaller one does not."""
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    frames = _clip(6, 2)
    sizes = []
    for g in (1, 1, 1, 2, 1, 2):
        outs = _outs(eng, frames, g)
        sizes.append(outs["words"].numel())
        eng.download(outs)
    assert fake_staging == [sizes[0], sizes[3]]
    assert [r[5] for r in _counts(recorder, "finish.staging_bytes")] == [
        4 * sizes[0], 4 * sizes[3]]
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [1] * 6


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("g", [1, 2])
def test_an_xl_rerun_takes_the_plain_copy(recorder, fake_staging, emit, g):
    """The worst-case rerun's words are more than any budgeted launch
    returned, but cut to the longest payload they fit the budgeted
    buffer: they go through it (counted 1), make no buffer of their own,
    equal the plain copy byte for byte and give the budgeted encode's
    packets."""
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu",
                    emit=emit)
    frames = _clip(6, 2)
    want = _packets(eng, frames, eng.download(_outs(eng, frames, g)), g)
    xl = _outs(eng, frames, g, xl=True)
    assert xl["words"].numel() > eng._budget_words
    host = eng.download(xl)
    assert host["words"].tobytes() == _plain_words(xl).tobytes()
    got = _packets(eng, frames, host, g)
    assert got == want
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [1, 1]
    assert len(fake_staging) == 1


def test_a_first_launch_at_the_worst_case_stages_nothing(recorder,
                                                         fake_staging):
    """Before any budgeted launch, a worst-case download stages nothing
    beyond its words cut to the longest payload: the buffer is made at
    their size, not at the worst case's."""
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    outs = _outs(eng, _clip(6, 2), 1, xl=True)
    host = eng.download(outs)
    plain = _plain_words(outs)
    assert host["words"].tobytes() == plain.tobytes()
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [1]
    assert fake_staging == [plain.size] and plain.size < outs["words"].numel()


@pytest.mark.parametrize("batched", [False, True])
def test_overflow_reruns_are_counted(recorder, batched):
    """Noise at qp 1 overflows every budget: each finish reruns at the
    worst case, inside its finish.wait span."""
    cfg = EncoderConfig(width=W, height=H, gop_n=2, base_qp=1)
    eng = GopEngine(cfg, device="cpu")
    clips = [_clip(s, 2, noise=True) for s in (7, 8)]
    for frames in clips:
        if batched:
            eng.finish(eng.start([frames, frames], [0, 2]))
        else:
            _encode(eng, frames)
    assert recorder.counters["engine.overflow_reruns"] == 2
    waits = {r[0] for r in _spans(recorder, "finish.wait")}
    assert len(waits) == 2
    assert {r[4] for r in _counts(recorder, "engine.overflow_reruns")} == waits
    reruns = [r for r in _spans(recorder, "engine.eager") if r[4] in waits]
    assert len(reruns) == 2


@pytest.mark.parametrize("batched", [False, True])
def test_upload_spans(recorder, batched):
    eng = GopEngine(EncoderConfig(width=W, height=H, gop_n=2), device="cpu")
    frames = _clip(9, 2)
    if batched:
        h = eng.start([frames, frames], [0, 2])
        assert h.y.shape == (2, 2, H, W)
    else:
        h = eng.start([frames], [0])
        assert h.y.shape == (2, H, W)
    assert torch.equal(h.cb[1] if not batched else h.cb[1, 0],
                       torch.from_numpy(frames[1].cb))
    (up,) = _spans(recorder, "engine.upload")
    for name in ("engine.upload.stack", "engine.upload.copy"):
        (child,) = _spans(recorder, name)
        assert child[4] == up[0]
    assert "engine.upload_busy" not in recorder.counters   # CUDA only


# ---- the CLI -------------------------------------------------------------

@pytest.mark.parametrize("engine,stages", [
    ("gop", ["drain+mux", "upload+dispatch"]), ("device", [])])
def test_stage_timers_summary_adds_spans_and_counters(recorder, tmp_path,
                                                      capsys, engine, stages):
    path = _yuv(tmp_path / "in.yuv", 10, 5)
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(tmp_path / "o.tvc"), "--gop", "2",
                     "--engine", engine, "--device", "cpu",
                     "--stage-timers"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out["stages"]) == stages
    for s in out["spans"].values():
        assert set(s) == {"total_s", "count", "mean_ms"}
    if engine == "gop":     # two GOPs and a tail
        assert out["spans"]["engine.eager"]["count"] == 3
        assert out["spans"]["finish.packets"]["count"] == 3
        assert out["spans"]["engine.upload"]["count"] == 3
        assert out["counters"]["engine.eager_calls"] == 3
        assert out["counters"]["finish.copy_bytes"] > 0
    else:                   # the per-frame engine: one eager call a frame
        assert out["counters"] == {"engine.eager_calls": 5}
        assert list(out["spans"]) == ["engine.eager"]


@pytest.mark.parametrize("staged", [False, True])
def test_stage_timers_summary_counts_the_staging(recorder, request, tmp_path,
                                                 capsys, staged):
    """The summary's counters name the staged downloads and the buffer's
    bytes: three GOP downloads, one buffer (the tail's words are fewer)."""
    made = request.getfixturevalue("fake_staging") if staged else []
    path = _yuv(tmp_path / "in.yuv", 10, 5)
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(tmp_path / "o.tvc"), "--gop", "2",
                     "--device", "cpu", "--stage-timers"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["counters"]["finish.copy_staged"] == (3 if staged else 0)
    if staged:
        assert out["counters"]["finish.staging_bytes"] == 4 * made[0]
        assert len(made) == 1
    else:
        assert "finish.staging_bytes" not in out["counters"]


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and the graphs' pool exist "
                    "only on the card")
    return torch.device("cuda", 0)


def test_graph_pool_and_busy_upload_on_card(recorder, cuda):
    """On the card: the pool's bytes after the capture, by its segments,
    in stats() and in engine.graph_pool_bytes; replays counted per key;
    an upload behind a long kernel counted in engine.upload_busy."""
    eng = GopEngine(EncoderConfig(width=96, height=64, gop_n=3), device=cuda)
    frames = _clip(11, 3, w=96, h=64)
    for _ in range(3):
        _encode(eng, frames)
    (st,) = eng.cache.stats().values()     # eager, capture and replay, replay
    assert st["captures"] == 1 and st["replays"] == 2
    assert st["pool_bytes"] == gop_engine._pool_bytes(eng.cache.pool) > 0
    assert recorder.counters["engine.graph_pool_bytes"] == st["pool_bytes"]
    assert "engine.upload_busy" not in recorder.counters
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # keeps the stream busy
    h = eng.start([frames], [0])
    assert recorder.counters["engine.upload_busy"] == 1
    eng.finish(h)
    assert recorder.counters["engine.replays"] == 3


@pytest.mark.parametrize("g", [1, 4])
def test_staged_words_equal_the_plain_copy_at_1080p(recorder, cuda, g):
    """At 1080p, one GOP and four in lockstep: the staged words are the
    pageable copy's, byte for byte, and land in a buffer the size of the
    budgeted words."""
    eng = GopEngine(EncoderConfig(width=1920, height=1080, gop_n=2),
                    device=cuda)
    frames = _clip(13, 2, w=1920, h=1080)
    outs = _outs(eng, frames, g)
    host = eng.download(outs)
    plain = _plain_words(outs)
    assert host["words"].shape == plain.shape
    assert host["words"].tobytes() == plain.tobytes()
    assert eng._staging.is_pinned()
    assert eng._staging.numel() == outs["words"].numel()
    assert recorder.counters["finish.copy_staged"] == 1
    assert recorder.counters["finish.staging_bytes"] == 4 * outs[
        "words"].numel()


def test_three_downloads_one_staging_buffer_on_card(recorder, cuda):
    """Three encodes of one key (eager, capture and replay, replay): one
    buffer, every download staged."""
    eng = GopEngine(EncoderConfig(width=96, height=64, gop_n=3), device=cuda)
    frames = _clip(11, 3, w=96, h=64)
    got = [_encode(eng, frames)[0] for _ in range(3)]
    assert got[0] == got[1] == got[2]
    assert len(_counts(recorder, "finish.staging_bytes")) == 1
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [1] * 3


@pytest.mark.parametrize("g", [1, 4])
def test_a_download_right_after_run_has_landed(recorder, cuda, g):
    """download straight after run(), behind a long kernel and with no
    sync of the caller's, gives a synchronous encode's packets: the copy
    has landed before download returns."""
    eng = GopEngine(EncoderConfig(width=96, height=64, gop_n=3), device=cuda)
    frames = _clip(14, 3, w=96, h=64)
    want = _packets(eng, frames, eng.download(_outs(eng, frames, g)), g)
    torch.cuda.synchronize()
    for _ in range(2):       # the capture, then a replay
        eng.download(_outs(eng, _clip(15, 3, noise=True, w=96, h=64), g))
        torch.cuda._sleep(100_000_000)
        got = _packets(eng, frames, eng.download(_outs(eng, frames, g)), g)
        assert got == want
    assert set(r[5] for r in _counts(recorder, "finish.copy_staged")) == {1}


def test_an_xl_rerun_takes_the_plain_copy_on_card(recorder, cuda):
    """A forced worst-case rerun's words, cut to the longest payload, go
    through the budgeted buffer (counted 1), make no buffer of their own,
    equal the plain copy, and its stream is the budgeted encode's."""
    eng = GopEngine(EncoderConfig(width=1920, height=1080, gop_n=2),
                    device=cuda)
    frames = _clip(16, 2, w=1920, h=1080)
    want = _packets(eng, frames, eng.download(_outs(eng, frames, 1)), 1)
    xl = _outs(eng, frames, 1, xl=True)
    host = eng.download(xl)
    assert host["words"].tobytes() == _plain_words(xl).tobytes()
    got = _packets(eng, frames, host, 1)
    assert got == want
    assert [r[5] for r in _counts(recorder, "finish.copy_staged")] == [1, 1]
    assert len(_counts(recorder, "finish.staging_bytes")) == 1
