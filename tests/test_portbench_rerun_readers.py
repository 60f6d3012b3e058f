"""The benchmark's readers of the frame budget, `engine.rerun_share` and
`engine.frame_budget_fill`, on a hand-filled recorder against hand-made
GOP records: only the downloads and reruns that start in the window's
untraced part count; each is silent without what it reads (the fill
count, the downloads' spans), without a recorder, and where the ring
dropped the window. The entries that report them list the cells as
stated, and a traced CPU run of every cell reads the fill."""

import json
import os
import time

import pytest
import torch

from portbench import run
from portbench.tests.helpers import tiny
from video_encoder_tpu_torch.utils import trace

torch.set_num_threads(2)
MS = 1_000_000        # ns
READERS = ("engine.rerun_share", "engine.frame_budget_fill")
BUDGET = 1000


class Clock:
    """perf_counter_ns at a time the test sets."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def recorder(monkeypatch, size=1024):
    """An empty recorder in RECORDER's place, on a clock the test sets."""
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    new = trace.Recorder(size=size)
    new.clock = clock
    monkeypatch.setattr(trace, "RECORDER", new)
    return new


def count(rec, name, n, at):
    rec.clock.t = at
    rec.count(name, n)


def download(rec, at, bits, counted=True, span="finish.copy"):
    """GopEngine.download's span with its fill count, the largest frame's
    `bits` over a budget of BUDGET bits in parts per million (no count
    where the program does not make it)."""
    rec.clock.t = at
    with rec.span(span):
        count(rec, "finish.copy_bytes", 10**6, at + 1)
        if counted:
            count(rec, "engine.frame_budget_fill_ppm",
                  bits * 10**6 // BUDGET, at + 2)
        rec.clock.t = at + MS


def fill(rec, bits, reruns, counted=True, span="finish.copy"):
    """Set-up's download and rerun at 1.4 s; then eight launches 0.1 s
    apart from 2.5 s, the first three traced, launch k finished 2 ms
    after launch k + 1 (the last 50 ms after its own), rerunning where
    `reruns` holds k. The untraced part starts at launch 3, so it holds
    the finishes of launches 2-7: `bits` are their frames' largest. The
    traced finishes and set-up's read 5,000 bits and rerun."""
    count(rec, "engine.overflow_reruns", 1, int(1.4e9))
    download(rec, int(1.41e9), 5000, counted, span)
    gops = []
    for k in range(8):
        t = int(2.5e9) + k * 100 * MS
        gops.append({"k": k, "traced": k < 3, "t_launch": t / 1e9})
    for k, g in enumerate(gops):
        f = (int(2.5e9) + (k + 1) * 100 * MS + 2 * MS if k < 7
             else int(g["t_launch"] * 1e9) + 50 * MS)
        if k < 2 or k in reruns:
            count(rec, "engine.overflow_reruns", 1, f)
        download(rec, f + 10, 5000 if k < 2 else bits[k - 2], counted, span)
        g["t_done"] = (f + 2 * MS) / 1e9
    return dict(setup_s=2.0, window_s=0.8, gop_batch=1, frames_per_gop=8,
                frames=64, gops=gops, traced=None)


def read(name, record):
    return run.reader(name).read(record)


def test_readers_on_a_hand_filled_recorder(monkeypatch):
    rec = recorder(monkeypatch)
    record = fill(rec, [1200, 600, 1500, 900, 1000, 1200], reruns={2, 4, 5})
    assert read("engine.rerun_share", record) == pytest.approx(50.0)
    assert read("engine.frame_budget_fill", record) == pytest.approx(
        100 * 6.4 / 6)


def test_every_launch_rerun_reads_a_whole_share(monkeypatch):
    rec = recorder(monkeypatch)
    record = fill(rec, [1100] * 6, reruns=set(range(8)))
    assert read("engine.rerun_share", record) == pytest.approx(100.0)
    assert read("engine.frame_budget_fill", record) == pytest.approx(110.0)


def test_no_rerun_reads_zero(monkeypatch):
    """A program that counts its downloads and reran none in the part."""
    rec = recorder(monkeypatch)
    record = fill(rec, [400] * 6, reruns=set())
    assert read("engine.rerun_share", record) == 0.0
    assert read("engine.frame_budget_fill", record) == pytest.approx(40.0)


def test_the_fill_is_silent_without_its_count(monkeypatch):
    """A program from before the fill count: its downloads and reruns are
    there, so the share reads; the count is not, so the fill is silent."""
    rec = recorder(monkeypatch)
    record = fill(rec, [1100] * 6, reruns={2, 3}, counted=False)
    assert read("engine.frame_budget_fill", record) is None
    assert read("engine.rerun_share", record) == pytest.approx(100 * 2 / 6)


def test_the_share_is_silent_without_the_downloads_spans(monkeypatch):
    """Reruns counted, but no `finish.copy` span to count downloads by."""
    rec = recorder(monkeypatch)
    record = fill(rec, [1100] * 6, reruns={2, 3}, span="finish.other")
    assert read("engine.rerun_share", record) is None
    assert read("engine.frame_budget_fill", record) == pytest.approx(110.0)


def test_silent_where_the_part_holds_no_download(monkeypatch):
    rec = recorder(monkeypatch)
    record = fill(rec, [1100] * 6, reruns=set())
    for name in READERS:
        assert read(name, dict(record, gops=[])) is None, name
    late = [dict(g, traced=False, t_launch=g["t_launch"] + 10) for g in
            record["gops"]]
    for name in READERS:
        assert read(name, dict(record, gops=late)) is None, name


def test_silent_where_the_ring_dropped_the_window(monkeypatch):
    rec = recorder(monkeypatch, size=8)
    record = fill(rec, [1100] * 6, reruns={2})
    assert rec.dropped > 0
    for name in READERS:
        assert read(name, record) is None, name


def test_silent_without_a_recorder(monkeypatch):
    rec = recorder(monkeypatch)
    record = fill(rec, [1100] * 6, reruns={2})
    monkeypatch.delattr(trace, "RECORDER")
    for name in READERS:
        assert read(name, record) is None, name


def test_the_entries_list_the_cells_as_stated():
    with open(os.path.join(run.HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert set(READERS) <= entries.keys()
    cells = [w["name"] for w in bench["workloads"]]
    assert len(cells) == 6
    assert entries["engine.rerun_share"]["workloads"] == ["q20-2160.g1"]
    assert entries["engine.frame_budget_fill"]["workloads"] == cells
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["layer"], m["moves"]) == (
            "%", "lower", "engine", "encode_fps")
        assert m["source"] == "program_counter"


def test_the_rerun_cell_is_left_out_of_the_launch_only_readers():
    """`device.idle_share` brackets only the launch with its events and
    `full_search.roofline` counts only the launches' P frames, while the
    harness's finish launches the rerun outside both: in a cell where
    every GOP reruns they would read the rerun as idle time and hold one
    pass's work against two passes' search time."""
    with open(os.path.join(run.HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ("device.idle_share", "full_search.roofline"):
        assert "full1080.g1" in entries[name]["workloads"], name
        assert "q20-2160.g1" not in entries[name]["workloads"], name


@pytest.mark.parametrize("workload", [w["name"] for w in run.load_json(
    os.path.join(run.ROOT, "BENCHMARK.json"))["workloads"]])
def test_traced_cpu_runs_read_the_fill(workload):
    """Every cell reads the fill; the 4K cell also the rerun share, and
    at qp 20 every launch of it overflows."""
    over = (tiny(workload) if workload != "q20-2160.g1"
            else {"encoder": {"width": 96, "height": 64}})
    result, _, info = run.run_cell(workload, 2**31 + 43, 0.3, True,
                                   device="cpu", overrides=over)
    assert result["correct"]
    metrics = result["metrics"]
    fill_pct = metrics["engine.frame_budget_fill"]["value"]
    assert fill_pct > 0 and metrics["engine.frame_budget_fill"]["unit"] == "%"
    if workload == "q20-2160.g1":
        assert metrics["engine.rerun_share"]["value"] == 100.0
        assert fill_pct > 100 and info["reruns"] == info["gops"]
    else:
        assert "engine.rerun_share" not in metrics
