"""Each metric reader on hand-made records and traces, and the trace
summary the traced readers take."""

import pytest

from portbench import lists, run, tracing

KERNEL = "void (anonymous namespace)::tiled_kernel<false>(int const*, int)"
MAP = "void (anonymous namespace)::tiled_kernel<true>(int const*, int)"
PACK = "void (anonymous namespace)::block_pack_kernel<false>(int const*)"
PLAIN = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)"
COPY = "Memcpy DtoH (Device -> Pageable)"


def gop(k, t_launch, t_done, dev_ms, traced=False, finish=(0.001, 0.002, 0.0005)):
    return {"k": k, "traced": traced, "t_launch": t_launch, "t_done": t_done,
            "dev_ms": dev_ms, "finish.download": finish[0],
            "finish.packets": finish[1], "finish.mux": finish[2]}


def record(**kw):
    rec = dict(setup_s=12.5, window_s=2.0, gop_batch=1, frames_per_gop=30,
               frames=600, gops=[], pool_bytes=100 * 2**20,
               mem_allocated_peak=400 * 2**20, shape=(1088, 1920), traced=None,
               device_name="NVIDIA H100 80GB HBM3")
    rec.update(kw)
    return rec


def traced(ops, calls_by_span=None, launches=2, finishes=1, g=1, t=30):
    return dict(launches=launches, finishes=finishes, frames=launches * g * t,
                p_frames=launches * g * (t - 1), ops=ops,
                calls_by_span=calls_by_span or {}, window_s=0.1, busy_s=0.05,
                breakdown={})


def test_end_to_end_readers():
    gops = [gop(k, k * 0.1, k * 0.1 + 0.05 + 0.001 * k, 30.0) for k in range(40)]
    rec = record(gops=gops)
    assert run.reader("encode_fps").read(rec) == 300.0
    assert run.reader("setup_s").read(rec) == 12.5
    assert run.reader("work_mem_peak_mib").read(rec) == 300.0
    # latencies 50, 51, ... 89 ms: the inclusive 95th percentile
    assert run.reader("gop_latency_p95_ms").read(rec) == pytest.approx(87.05)
    assert run.reader("gop_latency_p95_ms").read(record(gops=gops[:10])) is None
    assert run.reader("work_mem_peak_mib").read(record(mem_allocated_peak=0)) is None


def test_finish_and_idle_leave_out_traced_gops():
    gops = ([gop(k, k * 0.1, k * 0.1 + 0.05, 999.0, traced=True) for k in range(3)]
            + [gop(k, k * 0.1, k * 0.1 + 0.05, 60.0) for k in range(3, 8)])
    rec = record(gops=gops)
    assert run.reader("finish.host_ms_per_gop").read(rec) == pytest.approx(3.5)
    # window 0.3 s .. 0.75 s, five spans of 60 ms: 1 - 0.3 / 0.45
    assert run.reader("device.idle_share").read(rec) == pytest.approx(100 / 3)
    assert run.reader("finish.host_ms_per_gop").read(
        record(gops=gops, gop_batch=4)) == pytest.approx(3.5 / 4)


def test_traced_readers():
    ms = 1_000_000
    ops = [(KERNEL, 0, 2 * ms), (PACK, 2 * ms, 3 * ms), (PLAIN, 3 * ms, 7 * ms),
           (COPY, 7 * ms, 9 * ms), (MAP, 9 * ms, 10 * ms)]
    rec = record(traced=traced(ops, {"launch": 22, "finish.wait": 4,
                                     "finish.download": 3, "outside spans": 9}))
    # 60 frames: the port's kernels 2 + 1 + 1 ms, plain 4 ms, the copy neither
    assert run.reader("kernels.device_ms_per_frame").read(rec) == pytest.approx(4 / 60)
    assert run.reader("plain.device_ms_per_frame").read(rec) == pytest.approx(4 / 60)
    assert run.reader("engine.host_calls_per_gop").read(rec) == 11 + 7
    # 58 P frames of 8160 MBs x 1089 x 256 abs-diffs, 4 a lane, at
    # 132 x 128 x 1.98e9 lane issues a second, against 2 ms of search
    least = 8160 * 1089 * 256 / 4 / (132 * 128 * 1.98e9) * 58
    assert run.reader("full_search.roofline").read(rec) == pytest.approx(
        100 * least / 2e-3)
    assert run.reader("engine.host_calls_per_gop").read(
        record(traced=traced(ops, {"launch": 22, "finish.wait": 4}), gop_batch=4)
    ) == pytest.approx((11 + 4) / 4)


def test_traced_readers_are_silent_without_their_work():
    rec = record(traced=traced([(PLAIN, 0, 10)]))
    assert run.reader("full_search.roofline").read(rec) is None
    assert run.reader("kernels.device_ms_per_frame").read(rec) is None
    assert run.reader("engine.host_calls_per_gop").read(rec) is None
    for name in ("full_search.roofline", "plain.device_ms_per_frame",
                 "engine.host_calls_per_gop", "kernels.device_ms_per_frame"):
        assert run.reader(name).read(record()) is None
    assert run.reader("full_search.roofline").read(
        record(traced=traced([(KERNEL, 0, 10)]), device_name="cpu")) is None


def test_roofline_cannot_pass_100_for_the_least_time():
    """A search that took exactly the least time reads 100 %."""
    mod = run.reader("full_search.roofline")
    peak = run.load_json(f"{run.HERE}/peaks.json")["NVIDIA H100 80GB HBM3"]
    least_ns = mod.least_s_per_p_frame(peak, 1088, 1920) * 29 * 1e9
    rec = record(traced=traced([(KERNEL, 0, least_ns)], launches=1, finishes=1))
    assert run.reader("full_search.roofline").read(rec) == pytest.approx(100.0)


def test_summarise_attributes_calls_and_gaps_to_spans():
    spans = [(0, 100, "launch"), (100, 300, "finish.wait"),
             (300, 500, "finish.download"), (500, 600, "launch")]
    ops = [("a", 0, 50), ("b", 40, 120), ("c", 400, 450), ("a", 520, 600)]
    out = tracing.summarise(ops, spans, [10, 20, 150, 350, 550, 700],
                            launches=2, finishes=1, frames_per_launch=30,
                            p_frames_per_launch=29, window_s=1.0)
    assert out["calls_by_span"] == {"launch": 3, "finish.wait": 1,
                                    "finish.download": 1, "outside spans": 1}
    assert out["busy_s"] == pytest.approx((120 + 50 + 80) / 1e9)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"finish.wait": 280 / 1e9,
                                  "finish.download": 70 / 1e9})
    top = out["breakdown"]["device_ops"]
    assert top[0] == ["a", pytest.approx(130 / 1e9)]
    assert out["frames"] == 60 and out["p_frames"] == 58


def test_name_lists():
    own = lists.load("port_kernels.txt")
    search = lists.load("full_search_kernels.txt")
    assert lists.matches(KERNEL, search) and not lists.matches(MAP, search)
    assert lists.matches(MAP, own) and lists.matches(PACK, own)
    assert not lists.matches(PLAIN, own) and not lists.is_kernel(COPY)
    assert lists.kernel_base(PLAIN) == "vectorized_elementwise_kernel"
