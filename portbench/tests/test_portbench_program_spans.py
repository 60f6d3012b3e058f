"""The readers of the program's own spans and counts (`program_spans.py`
and the six metrics that use it) on a hand-filled recorder against
hand-made GOP records, and on CPU runs of every cell."""

import time

import pytest
import torch

from portbench import run
from portbench.tests.helpers import tiny
from video_encoder_tpu_torch.utils import trace

torch.set_num_threads(2)
CELLS = [c["name"] for c in run.load_json(f"{run.ROOT}/BENCHMARK.json")["workloads"]]
FINISH = ("finish.copy_ms_per_gop", "finish.copy_gb_per_s",
          "finish.packets_ms_per_gop")
ENGINE = ("engine.launch_host_ms_per_gop", "engine.capture_s",
          "engine.graph_pool_mib")
MS = 1_000_000        # ns


class Clock:
    """perf_counter_ns at a time the test sets."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def rec(monkeypatch):
    """An empty recorder in RECORDER's place, on a clock the test sets."""
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    new = trace.Recorder(size=1024)
    new.clock = clock
    monkeypatch.setattr(trace, "RECORDER", new)
    return new


def span(rec, name, start, end, inner=()):
    """A span of name from start to end ns, with `inner` (calls) inside."""
    rec.clock.t = start
    with rec.span(name):
        for f in inner:
            f()
        rec.clock.t = end


def count(rec, name, n, at):
    def f():
        rec.clock.t = at
        rec.count(name, n)
    return f


def gop_record(k, t_launch, traced):
    return {"k": k, "traced": traced, "t_launch": t_launch,
            "t_done": t_launch + 0.09, "dev_ms": 30.0, "finish.download": 0,
            "finish.packets": 0, "finish.mux": 0}


def fill(rec, g=1, slow=10 * MS):
    """Set-up at 1.0-1.5 s: a key's eager call (0.5 s) and its capture
    (0.3 s), the pool at 64 MiB, and a warm launch and finish; then eight
    launches 0.1 s apart from 2.5 s, the first three traced, each finished
    after the next is launched. A traced launch and the finishes that run
    while the profiler runs take `slow`; the rest take 0.2 ms (launch),
    1 ms (copy, moving 1e6 bytes) and 0.5 ms (packets, one per GOP)."""
    count(rec, "engine.capture_ns", 500 * MS, int(1.0e9))()
    span(rec, "engine.capture", int(1.1e9), int(1.4e9),
         [count(rec, "engine.capture_ns", 300 * MS, int(1.4e9))])
    count(rec, "engine.graph_pool_bytes", 64 * 2**20, int(1.4e9))()
    span(rec, "engine.launch", int(1.45e9), int(1.45e9) + slow)
    span(rec, "finish.copy", int(1.47e9), int(1.47e9) + slow,
         [count(rec, "finish.copy_bytes", 5, int(1.47e9) + 1)])
    gops = []
    for k in range(8):
        t = int(2.5e9) + k * 100 * MS
        traced = k < 3
        gops.append(gop_record(k, t / 1e9, traced))
        span(rec, "engine.launch", t + 1000, t + 1000 + (
            slow if traced else MS // 5))
        if k:        # the finish of launch k - 1, after launch k
            f = t + 2 * MS
            fast = k - 1 >= 2       # the profiler stops after launch 2
            span(rec, "finish.copy", f, f + (MS if fast else slow),
                 [count(rec, "finish.copy_bytes", 10**6 if fast else 1, f + 1)])
            for gi in range(g):
                p = f + 2 * MS + gi * MS
                span(rec, "finish.packets", p, p + (MS // 2 if fast else slow))
    return dict(setup_s=2.0, window_s=0.8, gop_batch=g, frames_per_gop=30,
                frames=8 * 30 * g, gops=gops, traced=None)


def read(name, record):
    return run.reader(name).read(record)


@pytest.mark.parametrize("g", [1, 4])
def test_readers_on_a_hand_filled_recorder(rec, g):
    """Only the spans that start in the untraced window count: set-up's
    and the traced launches' slow spans are left out."""
    record = fill(rec, g)
    assert read("finish.copy_ms_per_gop", record) == pytest.approx(1.0 / g)
    assert read("finish.copy_gb_per_s", record) == pytest.approx(1.0)
    assert read("finish.packets_ms_per_gop", record) == pytest.approx(0.5)
    assert read("engine.launch_host_ms_per_gop", record) == pytest.approx(
        0.2 / g)
    # the whole run, set-up included: 0.5 s of eager call, 0.3 of capture
    assert read("engine.capture_s", record) == pytest.approx(0.8)
    assert read("engine.graph_pool_mib", record) == pytest.approx(64.0)


def test_the_pool_reads_its_size_after_the_last_capture(rec):
    """Each capture counts the change of the pool's size: their sum is
    the size after the last one."""
    record = fill(rec)
    count(rec, "engine.graph_pool_bytes", 16 * 2**20, int(2.6e9))()
    count(rec, "engine.graph_pool_bytes", -8 * 2**20, int(2.7e9))()
    assert read("engine.graph_pool_mib", record) == pytest.approx(72.0)


def test_a_run_before_this_one_is_left_out(rec):
    """Counts from before this run's start (an earlier run in the same
    process) do not enter the run's sums."""
    count(rec, "engine.capture_ns", 9 * 10**9, int(0.1e9))()
    count(rec, "engine.graph_pool_bytes", 2**30, int(0.2e9))()
    record = fill(rec)
    assert read("engine.capture_s", record) == pytest.approx(0.8)
    assert read("engine.graph_pool_mib", record) == pytest.approx(64.0)


def test_silent_where_the_ring_dropped_the_window(monkeypatch):
    """A ring too small for the run: the records of the window's start
    are gone, so every reader gives None."""
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    small = trace.Recorder(size=8)
    small.clock = clock
    monkeypatch.setattr(trace, "RECORDER", small)
    record = fill(small)
    assert small.dropped > 0
    for name in FINISH + ENGINE:
        assert read(name, record) is None, name


def test_silent_where_the_span_never_ran(rec):
    """The CPU: no replay, no capture, no pool; and a run whose window
    holds no finish."""
    rec.clock.t = int(2.5e9)
    gops = [gop_record(k, 2.5 + 0.1 * k, False) for k in range(3)]
    record = dict(setup_s=2.0, window_s=0.3, gop_batch=1, frames_per_gop=30,
                  frames=90, gops=gops, traced=None)
    for name in FINISH + ENGINE:
        assert read(name, record) is None, name
    span(rec, "finish.copy", int(2.51e9), int(2.511e9))   # no bytes counted
    assert read("finish.copy_ms_per_gop", record) == pytest.approx(1.0)
    assert read("finish.copy_gb_per_s", record) is None
    assert read("engine.launch_host_ms_per_gop", record) is None
    no_gops = dict(record, gops=[])
    assert read("finish.copy_ms_per_gop", no_gops) is None


def test_silent_without_a_recorder(monkeypatch):
    """A checkout of the program from before the recorder has no
    RECORDER: every reader gives None and none raises."""
    monkeypatch.delattr(trace, "RECORDER")
    record = dict(setup_s=2.0, window_s=0.3, gop_batch=1, frames_per_gop=30,
                  frames=90, gops=[gop_record(0, 2.5, False)], traced=None)
    for name in FINISH + ENGINE:
        assert read(name, record) is None, name


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_run_reads_the_finish(workload):
    """A traced CPU run of each cell at the tiny size: the finish metrics
    are numbers; the engine's, which need a graph on the card, are not
    reported."""
    result, _, _ = run.run_cell(workload, 2**31 + 23, 0.3, True, device="cpu",
                                overrides=tiny(workload))
    assert result["correct"]
    metrics = result["metrics"]
    for name in FINISH:
        assert metrics[name]["value"] > 0, name
    assert metrics["finish.copy_gb_per_s"]["unit"] == "GB/s"
    assert not set(ENGINE) & set(metrics)
