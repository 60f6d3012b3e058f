"""The readers of the format-4 cell's two metrics: `hpel_refine.roofline`
on hand-made traces and `motion.hpel_mb_share` on a hand-filled recorder,
each giving None where the record holds nothing for it; and a traced CPU
run of the cell, whose counts the share reads."""

import time

import pytest
import torch

from portbench import run
from video_encoder_tpu_torch.utils import trace

torch.set_num_threads(2)

CELL = "fmt4-1080.g1"
REFINE = "void (anonymous namespace)::sad_at_kernel<16>(unsigned char const*, int)"
CHROMA = "void (anonymous namespace)::sad_at_kernel<8>(unsigned char const*, int)"
SEARCH = "void (anonymous namespace)::tiled_kernel<false>(int const*, int)"
H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000        # ns


def record(traced=None, gops=(), device_name=H100):
    return dict(setup_s=2.0, window_s=0.8, gop_batch=1, frames_per_gop=30,
                frames=240, gops=list(gops), pool_bytes=0,
                mem_allocated_peak=0, shape=(1088, 1920), traced=traced,
                device_name=device_name)


def traced(ops, launches=2):
    return dict(launches=launches, finishes=launches - 1,
                frames=launches * 30, p_frames=launches * 29, ops=ops,
                calls_by_span={}, window_s=0.1, busy_s=0.05, breakdown={})


def read(name, rec):
    return run.reader(name).read(rec)


def test_refine_roofline_reads_the_refine_kernel_only():
    """58 P frames, each at least 2 x 1088 x 1920 bytes at 3.35 TB/s (the
    bytes bind: 8160 x 9 x 256 abs-diffs, 4 a lane, take 0.14 us at the
    issue rate), against 2 ms of the refine's kernel; the search's and a
    chroma SAD kernel's time is not the refine's."""
    ops = [(SEARCH, 0, 5 * MS), (REFINE, 5 * MS, 7 * MS),
           (CHROMA, 7 * MS, 9 * MS)]
    least = 2 * 1088 * 1920 / 3.35e12 * 58
    assert read("hpel_refine.roofline", record(traced(ops))) == pytest.approx(
        100 * least / 2e-3)
    mod = run.reader("hpel_refine.roofline")
    peak = run.load_json(f"{run.HERE}/peaks.json")[H100]
    assert mod.least_s_per_p_frame(peak, 1088, 1920) == pytest.approx(
        4_177_920 / 3.35e12)
    issue = 8160 * 9 * 256 / 4 / (132 * 128 * 1.98e9)
    assert issue < 4_177_920 / 3.35e12 and issue == pytest.approx(0.14e-6,
                                                                  rel=0.01)


def test_refine_roofline_cannot_pass_100_for_the_least_time():
    mod = run.reader("hpel_refine.roofline")
    peak = run.load_json(f"{run.HERE}/peaks.json")[H100]
    least_ns = mod.least_s_per_p_frame(peak, 1088, 1920) * 29 * 1e9
    rec = record(traced([(REFINE, 0, least_ns)], launches=1))
    assert read("hpel_refine.roofline", rec) == pytest.approx(100.0)


def test_refine_roofline_is_silent_without_its_work():
    assert read("hpel_refine.roofline", record()) is None
    assert read("hpel_refine.roofline", record(traced([(SEARCH, 0, MS)]))) is None
    assert read("hpel_refine.roofline",
                record(traced([(REFINE, 0, MS)]), device_name="cpu")) is None
    assert read("hpel_refine.roofline",
                record(dict(traced([(REFINE, 0, MS)]), p_frames=0))) is None


@pytest.fixture
def rec(monkeypatch):
    """An empty recorder in RECORDER's place, on a clock the test sets."""
    now = [0]
    monkeypatch.setattr(time, "perf_counter_ns", lambda: now[0])
    new = trace.Recorder(size=1024)
    new.now = now
    monkeypatch.setattr(trace, "RECORDER", new)
    return new


def gop(k, t_launch, traced):
    return {"k": k, "traced": traced, "t_launch": t_launch,
            "t_done": t_launch + 0.09, "dev_ms": 30.0}


def download(rec, at, hpel, inter):
    """A finish.copy span at `at` ns counting a GOP's half-pel and inter
    MBs, as GopEngine.download does."""
    rec.now[0] = at
    with rec.span("finish.copy"):
        rec.count("motion.hpel_mbs", hpel)
        rec.count("motion.inter_mbs", inter)
        rec.now[0] = at + MS


def test_hpel_share_reads_the_untraced_window(rec):
    """Set-up's and the traced launches' downloads are left out; the
    window's counts give 100 x half-pel over inter MBs."""
    download(rec, int(1.0e9), 1000, 1000)             # set-up
    gops = [gop(k, 2.5 + 0.1 * k, k < 2) for k in range(6)]
    download(rec, int(2.55e9), 999, 1000)             # a traced finish
    for k in range(2, 6):
        download(rec, int((2.56 + 0.1 * k) * 1e9), 30 + k, 200)
    assert read("motion.hpel_mb_share", record(gops=gops)) == pytest.approx(
        100 * (32 + 33 + 34 + 35) / 800)


def test_hpel_share_is_silent_without_its_counts(rec, monkeypatch):
    gops = [gop(k, 2.5 + 0.1 * k, k < 2) for k in range(6)]
    assert read("motion.hpel_mb_share", record(gops=gops)) is None
    rec.now[0] = int(2.8e9)
    with rec.span("finish.copy"):        # a format-1 download: no counts
        rec.count("finish.copy_bytes", 100)
    assert read("motion.hpel_mb_share", record(gops=gops)) is None
    download(rec, int(2.9e9), 0, 0)      # no inter MB: no share
    assert read("motion.hpel_mb_share", record(gops=gops)) is None
    assert read("motion.hpel_mb_share", record()) is None
    monkeypatch.delattr(trace, "RECORDER")
    assert read("motion.hpel_mb_share", record(gops=gops)) is None


def test_cpu_run_of_the_cell_reads_the_share():
    """A traced CPU run of the cell at a small shape: the share is a
    number inside (0, 100]; the roofline, a device metric, is not
    reported off the card."""
    result, _, _ = run.run_cell(
        CELL, 2**31 + 23, 0.3, True, device="cpu",
        overrides={"encoder": dict(width=320, height=192, gop_n=4)})
    assert result["correct"]
    share = result["metrics"]["motion.hpel_mb_share"]
    assert 0 < share["value"] <= 100 and share["unit"] == "%"
    assert "hpel_refine.roofline" not in result["metrics"]
