"""The program's own record of a run: the spans and counts that the port
writes into its recorder (`video_encoder_tpu_torch/utils/trace.py`
RECORDER, on the harness's time.perf_counter clock), cut to a part of the
run, for the readers of the metrics that read them.

A reader gives None where the program has no recorder (a checkout from
before it had one), where the recorder's ring dropped records that
started in the part read, or where the part holds none of its records.
"""

from __future__ import annotations


def recorder():
    """The program's recorder, or None where it has none."""
    from video_encoder_tpu_torch.utils import trace

    return getattr(trace, "RECORDER", None)


def window_ns(rec) -> tuple[int, int] | None:
    """The window's untraced part in perf_counter ns: the first untraced
    launch to the last GOP muxed. A span of set-up, or of a traced launch,
    starts before it; the finish of the last traced launch starts inside
    it, after the profiler has stopped."""
    starts = [g["t_launch"] for g in rec["gops"] if not g["traced"]]
    ends = [g["t_done"] for g in rec["gops"] if "t_done" in g]
    if not starts or not ends:
        return None
    return round(min(starts) * 1e9), round(max(ends) * 1e9)


def run_ns(rec) -> tuple[int, int] | None:
    """The whole run in perf_counter ns, set-up included: the window's
    first launch less set-up's seconds (microseconds after the run's first
    statement, before any of the program's work) to the last GOP muxed."""
    window = window_ns(rec)
    if window is None or not rec["gops"]:
        return None
    start = rec["gops"][0]["t_launch"] - rec["setup_s"]
    return round(start * 1e9), window[1]


def records(part):
    """The recorder's records (seq, name, start ns, end ns, parent seq,
    value: None for a span, the count for a count) that start inside
    `part` (lo, hi); None where there is no recorder or no part, or where
    the ring dropped a record that may have started inside it."""
    rec = recorder()
    if rec is None or part is None:
        return None
    lo, hi = part
    if rec.dropped and (rec.oldest_ns() or hi) > lo:
        return None
    return [r for r in rec.records() if lo <= r[2] <= hi]


def spans(part, name: str):
    """The spans of `name` that start inside `part`, or None."""
    recs = records(part)
    if recs is None:
        return None
    return [r for r in recs if r[1] == name and r[5] is None] or None


def ms_per_gop(rec, name: str, gops_per_span: int):
    """The mean host milliseconds of the window's `name` spans, over the
    GOPs one such span serves."""
    found = spans(window_ns(rec), name)
    if found is None:
        return None
    return sum(r[3] - r[2] for r in found) / len(found) / 1e6 / gops_per_span


def count_total(rec, name: str):
    """The sum of the run's counts of `name`, or None where it has none."""
    recs = records(run_ns(rec))
    if recs is None:
        return None
    values = [r[5] for r in recs if r[1] == name and r[5] is not None]
    return sum(values) if values else None
