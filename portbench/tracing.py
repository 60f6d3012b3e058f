"""torch.profiler over the first launches of a traced run, read in memory.

No Chrome trace is exported: the records are read once the window has
closed, from the profiler's own event list (`kineto_results.events()`,
chip_smoke.py `raw_events`), into plain tuples the metric readers take:
the device operations (name, start ns, end ns), the host's submitting
calls counted by the harness span they fell in, the device's busy
seconds, and the breakdown that the result line carries.
"""

from __future__ import annotations

import bisect


def start():
    """A running profiler of the host's calls and the device's work."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def warm_profiler(work) -> None:
    """One throwaway session around `work`, so that the profiler's own
    start-up, and the first kernel that a process's later sessions have
    been seen to lose on the card, fall outside the window."""
    import torch

    prof = start()
    work()
    torch.cuda.synchronize()
    prof.stop()


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_at(spans, starts, t: int) -> str:
    """The name of the host span (start, end, name) that holds time t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return spans[i][2]
    return "outside spans"


def summarise(ops, host_spans, calls, *, launches: int, finishes: int,
              frames_per_launch: int, p_frames_per_launch: int,
              window_s: float) -> dict:
    """The traced window's record from its device operations (name,
    start ns, end ns), the harness's host spans (start ns, end ns, name)
    and the start times of the host's submitting calls."""
    host_spans = sorted(host_spans)
    starts = [s for s, _, _ in host_spans]
    by_span: dict[str, int] = {}
    for t in calls:
        name = span_at(host_spans, starts, t)
        by_span[name] = by_span.get(name, 0) + 1
    busy = merged((s, e) for _, s, e in ops)
    gaps: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = span_at(host_spans, starts, e0)
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e9
    by_op: dict[str, float] = {}
    for name, s, e in ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        launches=launches, finishes=finishes,
        frames=launches * frames_per_launch,
        p_frames=launches * p_frames_per_launch,
        ops=ops, calls_by_span=by_span, window_s=window_s,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        breakdown=dict(
            device_ops=[[n[:120], s] for n, s in top],
            idle_gaps=[[n, s] for n, s in sorted(gaps.items(),
                                                 key=lambda kv: -kv[1])[:10]]))


def read(prof, *, spans, submits, **shape) -> dict:
    """summarise() of a stopped profiler's events: device operations are
    the CUDA-side events, host spans the harness's record_function names
    in `spans`, submitting calls the host events whose names start with
    one of `submits`."""
    from torch.autograd import DeviceType

    ops, host_spans, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in spans:         # on the device too, as an annotation
            if e.device_type() != DeviceType.CUDA:
                host_spans.append((e.start_ns(), e.end_ns(), name))
        elif e.device_type() == DeviceType.CUDA:
            ops.append((name, e.start_ns(), e.end_ns()))
        elif name.startswith(submits):
            calls.append(e.start_ns())
    return summarise(ops, host_spans, calls, **shape)
