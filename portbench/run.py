#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of `workloads` in
BENCHMARK.json) names a configuration (`configs/<config>.json`: the
EncoderConfig fields, the source and the plain reference that states its
output) and a traffic mix (`traffic/<mix>.json`: the content recipe, the
GOPs in lockstep, the pool and the launches traced). The run makes the
cell's input pool on the card from the seed, warms the GOP engine up
(its CUDA graph captured, the finish path run), and then drives a closed
loop for `--seconds`: GOP (or batch) k + 1 is launched before GOP k is
finished, as the CLI's `encode_gop_resident` does, and each finish checks
the overflow flag (rerunning at the worst-case capacities where it is
set), downloads, builds the frame packets and muxes them into an
in-memory stream, whose bytes are kept for a sample of the GOPs drawn
from the seed. Once the window has closed the engine is freed, the
reference encodes every pool GOP, the sampled GOPs are compared with it
byte for byte and every frame of the window by its SSE, exactly.

The last line of standard output is one JSON object: `correct`,
`attempted` and `failed` (GOPs), `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `check`, each number compared beside its
limit. Each metric is read by its own reader, `metrics/<name>.py`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "video_encoder_tpu")
# the CUDA API calls by which the host submits device work, as
# torch.profiler names them (chip_smoke.py SUBMITS)
SUBMITS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
           "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
SPANS = ("launch", "finish.wait", "finish.download", "finish.packets",
         "finish.mux")
# the share of the window's launches whose muxed bytes are kept and
# compared, drawn from the seed; the first launch of each pool batch is
# always kept, and every frame's SSE is compared
BYTES_SAMPLE = 1 / 32
# the parts of set-up's imports that main times: torch's import and the
# card check, whose cudaGetDeviceCount starts the CUDA driver
IMPORTS: dict[str, float] = {}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str):
    """(BENCHMARK.json, the cell's entry, its configuration file, its
    traffic mix file)."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return bench, cell, config, mix


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The entries of `kind` (end_to_end or per_layer) that this cell
    reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The module `metrics/<name>.py`, whose read(rec) gives the metric or
    None where the run holds nothing for it to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_check(chips: int) -> str | None:
    """Why this machine cannot run the cell, or None."""
    import torch

    if not torch.cuda.is_available():
        return "CUDA is not available"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} found")
    return None


class Sink:
    """The mux's output. While `keep` is set each write's bytes are kept,
    in order, for the comparison after the window; otherwise they are
    counted and let go, as a stream sent on would be: a run keeps the
    bytes of a sample of its GOPs and not the whole stream, which at
    about 100 MB/s would grow the process by gigabytes in the window."""

    def __init__(self):
        self.parts: list[bytes] = []
        self.keep = True
        self.bytes = 0

    def write(self, data: bytes) -> None:
        self.bytes += len(data)
        if self.keep:
            self.parts.append(data)


class Geometry:
    """What `GopEngine.gop_packets` reads of a GOP's frames: the padded
    plane shapes, with no samples behind them."""

    def __init__(self, h: int, w: int):
        import numpy as np

        self.y = np.broadcast_to(np.uint8(0), (h, w))
        self.cb = np.broadcast_to(np.uint8(0), (h // 2, w // 2))


class HostEvent:
    """torch.cuda.Event's interface on the host clock, for CPU runs."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """The harness's host spans: (name, seconds) totals per GOP record and,
    while `traced`, a torch.profiler record_function of the same name."""

    def __init__(self):
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str, into: dict):
        import torch

        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(name) if self.traced
               else contextlib.nullcontext())
        with ctx:
            yield
        into[name] = into.get(name, 0.0) + time.perf_counter() - t0


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides=None):
    """One run of the cell: the result's fields and the numbers compared.
    `overrides` ({"encoder": {...}, "mix": {...}}) replaces entries of the
    configuration and the mix (the CPU tests' small shapes)."""
    import torch

    from video_encoder_tpu_torch.codec.bitstream import OrderedMux
    from video_encoder_tpu_torch.codec.config import config_from_dict
    from video_encoder_tpu_torch.pipeline import gop_engine

    sys.path.insert(0, ROOT)
    from portbench import content
    from portbench import tracing

    bench, cell, config, mix = cell_spec(workload)
    enc = dict(config["encoder"], **(overrides or {}).get("encoder", {}))
    mix = dict(mix, **(overrides or {}).get("mix", {}))
    cuda = device == "cuda"
    dev = torch.device(device)
    g_n, n_b, t_len = mix["gop_batch"], mix["pool_batches"], enc["gop_n"]
    refmod = importlib.import_module(f"portbench.reference.{config['reference']}")

    # ---- set-up: the pool, the engine, its graph and the finish path ----
    phases = dict(imports_s=time.perf_counter() - T_START, **IMPORTS)
    t = time.perf_counter()
    pool = content.make_pool(mix, enc, seed, dev)
    if cuda:
        torch.cuda.synchronize()
    phases["pool_s"] = time.perf_counter() - t
    pool_bytes = sum(p.numel() for p in pool)
    hp, wp = pool[0].shape[-2:]
    cfg = config_from_dict(enc)
    eng = gop_engine.GopEngine(cfg, device=dev)
    geom = [Geometry(hp, wp)] * t_len
    spans = Spans()
    reruns = [0]
    sample = random.Random(seed)

    def run(b: int, xl: bool = False):
        y, cb, cr = (p[b] for p in pool)
        if g_n > 1:
            return eng.run_batch(y, cb, cr, [cfg.base_qp] * g_n, xl=xl)
        return eng.run(y, cb, cr, cfg.base_qp, xl=xl)

    def new_event():
        return torch.cuda.Event(enable_timing=True) if cuda else HostEvent()

    def launch(k: int) -> dict:
        gop = dict(k=k, b=k % n_b, traced=spans.traced, t_launch=time.perf_counter())
        with spans("launch", gop):
            gop["ev"] = (new_event(), new_event())
            gop["ev"][0].record()
            gop["outs"] = run(gop["b"])
            gop["ev"][1].record()
        return gop

    def finish(gop: dict, mux: OrderedMux, sink: Sink) -> None:
        """encode_gop(s)_finish on run()'s outputs, then the mux."""
        with spans("finish.wait", gop):
            outs = gop.pop("outs")
            if bool(outs["ovf"].any()):       # the GOP's one wait
                reruns[0] += 1
                outs = run(gop["b"], xl=True)
        with spans("finish.download", gop):
            host = eng.download(outs)
        ms = (time.perf_counter() - gop["t_launch"]) * 1e3 / (t_len * g_n)
        with spans("finish.packets", gop):
            packets = [eng.gop_packets(
                geom, (gop["k"] * g_n + g) * t_len,
                host if g_n == 1 else
                {k: v if v is None else v[:, g] for k, v in host.items()}, ms)[0]
                for g in range(g_n)]
        gop["sse"] = host["sse"] if g_n == 1 else [host["sse"][:, g]
                                                   for g in range(g_n)]
        sink.keep = gop["k"] < n_b or sample.random() < BYTES_SAMPLE
        first = len(sink.parts)
        with spans("finish.mux", gop):
            for pk in packets:
                for p in pk:
                    mux.push(p)
        if sink.keep:
            gop["parts"] = (first, len(sink.parts))
        gop["t_done"] = time.perf_counter()

    # warm-up: the key's eager call, its capture, replays; each finished
    warm_sink = Sink()
    warm_mux = OrderedMux(warm_sink, cfg, 0)
    phases["warm_s"] = []
    for k in range(4):
        t = time.perf_counter()
        if k == 3 and cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()   # the eager call's transients
        finish(launch(k), warm_mux, warm_sink)
        phases["warm_s"].append(time.perf_counter() - t)
    del warm_sink, warm_mux
    if trace and cuda:
        t = time.perf_counter()
        tracing.warm_profiler(lambda: run(0)["ovf"].any().item())
        phases["profiler_s"] = time.perf_counter() - t
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    reruns[0] = 0

    # ---- the window: a closed loop, GOP k + 1 launched before k finishes ----
    sink = Sink()
    mux = OrderedMux(sink, cfg, 0)    # a stream whose length is not known
    n_traced = mix["trace_launches"] if trace else 0
    gops, pending, prof, traced_s = [], None, None, None
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds or k < n_traced + 2:
        if k == 0 and n_traced:
            prof = tracing.start()
            spans.traced = True
        gop = launch(k)
        if pending is not None:
            finish(pending, mux, sink)
        pending = gop
        gops.append(gop)
        k += 1
        if prof is not None and k == n_traced:
            traced_s = time.perf_counter() - t0
            prof.stop()
            spans.traced = False
    finish(pending, mux, sink)
    t_end = time.perf_counter()

    # ---- the window has closed ----
    if cuda:
        torch.cuda.synchronize()
    for gop in gops:
        gop["dev_ms"] = gop["ev"][0].elapsed_time(gop["ev"][1])
    loaded = forbidden_modules()
    mem_peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    mem_alloc = torch.cuda.max_memory_allocated(dev) if cuda else 0
    traced = None
    if prof is not None:
        traced = tracing.read(
            prof, spans=SPANS, submits=SUBMITS, launches=n_traced,
            finishes=n_traced - 1, frames_per_launch=g_n * t_len,
            p_frames_per_launch=g_n * (t_len - 1), window_s=traced_s)
        prof = None
    rec = dict(setup_s=setup_s, window_s=t_end - t0, gop_batch=g_n,
               frames_per_gop=t_len, frames=len(gops) * g_n * t_len,
               gops=[{k: v for k, v in g.items()
                      if k not in ("ev", "outs", "sse", "parts")} for g in gops],
               pool_bytes=pool_bytes, mem_allocated_peak=mem_alloc,
               shape=(hp, wp), traced=traced,
               device_name=torch.cuda.get_device_name(dev) if cuda else "cpu")

    # the program's state goes before the reference runs
    del eng, pending
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = {}
    for b in range(n_b):
        for g in range(g_n):
            y, cb, cr = content.pool_gop(pool, b, g)
            want[b, g] = refmod.encode_gop(enc, y, cb, cr)
    ref_s = time.perf_counter() - t_ref
    check = compare(gops, sink.parts, want, refmod.stream_header(enc, 0), g_n,
                    t_len)
    failed = sum(1 for g in gops if "t_done" not in g) * g_n
    compared = sum(1 for g in gops if "parts" in g) * g_n
    correct = failed == 0 and passes(check)

    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in cell_metrics(bench, workload, kind)}
    metrics = {}
    for name, unit in units.items():
        value = reader(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = dict(correct=correct, attempted=len(gops) * g_n, failed=failed,
                  metrics=metrics)
    info = dict(reference_s=ref_s, reruns=reruns[0], loaded=loaded,
                gops=len(gops), bytes_compared_gops=compared,
                stream_bytes=sink.bytes, window_s=rec["window_s"],
                setup_s=setup_s,
                memory_peak_bytes=mem_peak, setup=phases)
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
        info.update(busy_s=traced["busy_s"], traced_window_s=traced["window_s"])
    return result, check, info


def compare(gops, parts, want, header: bytes, g_n: int, t_len: int) -> dict:
    """The numbers compared, each with its limit: GOPs of the window's
    sample whose muxed bytes differ from the reference's, frames of the
    window whose SSE differs, and whether the stream header differs."""
    import numpy as np

    bytes_differ = sse_differ = 0
    for gop in gops:
        for g in range(g_n):
            packets, sse = want[gop["b"], g]
            if "parts" in gop:
                first, end = gop["parts"]
                if parts[first:end][g * t_len:(g + 1) * t_len] != packets:
                    bytes_differ += 1
            mine = gop["sse"] if g_n == 1 else gop["sse"][g]
            sse_differ += int((np.asarray(mine) != sse.numpy()).any(-1).sum())
    return {"gop_bytes_differ": {"value": bytes_differ, "limit": 0},
            "frame_sse_differ": {"value": sse_differ, "limit": 0},
            "header_differs": {"value": int(parts[0] != header), "limit": 0}}


def passes(check: dict) -> bool:
    """Whether every number compared lies within its limit."""
    return all(c["value"] <= c["limit"] for c in check.values())


def result_line(result: dict, check: dict, device: dict) -> str:
    """The run's last line: correct, attempted, failed, metrics, device,
    breakdown where traced, and check last."""
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = device
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["check"] = check
    return json.dumps(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    _, cell, _, _ = cell_spec(args.workload)
    t = time.perf_counter()
    import torch
    IMPORTS["torch_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    why_not = card_check(cell["chips"])
    IMPORTS["card_check_s"] = time.perf_counter() - t
    if why_not:
        print(f"portbench: {why_not}", file=sys.stderr)
        return 3

    result, check, info = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace))
    loaded = sorted(set(info.pop("loaded")) | set(forbidden_modules()))
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 4
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"],
                  memory_peak_bytes=info.pop("memory_peak_bytes"))
    if "busy_s" in info:
        device.update(busy_s=info.pop("busy_s"),
                      window_s=info.pop("traced_window_s"))
    print(f"portbench: {json.dumps(info, default=str)}", file=sys.stderr)
    for name, c in check.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(result_line(result, check, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
