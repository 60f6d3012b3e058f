"""Tracing, stage timing and structured events.

- StageTimer: per-stage wall-clock accumulation for the host pipeline.
- trace(): context manager around torch.profiler, writing one
  Chrome/TensorBoard trace of the host's ops and, where CUDA is
  available, the device's kernels into a directory.
- EventLog: JSONL structured event stream ({ts, event, **fields}) so runs
  are machine-parseable.

StageTimer and EventLog are the port's own copies of the reference's
(`video_encoder_tpu/utils/trace.py`), held equal to them by
tests/test_torch_copies.py. Unlike the reference's trace(), which
swallows profiler errors, this one raises if the profiler cannot start
or stop or if no trace file was written: a traced run that writes no
trace must not pass for one that did.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import defaultdict
from typing import IO


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (single-writer host pipeline, SURVEY.md §5 race-detection row)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"total_s": round(t, 4), "count": self.counts[name],
                   "mean_ms": round(1e3 * t / max(self.counts[name], 1), 3)}
            for name, t in sorted(self.totals.items())
        }

    def to_json(self) -> str:
        return json.dumps(self.report())


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block, written to log_dir as
    `<host>_<pid>.<ns>.pt.trace.json` (the name TensorBoard's PyTorch
    profiler plugin reads; chrome://tracing and Perfetto open it too).
    No-op if log_dir is None or empty. CUDA kernels are recorded when
    CUDA is available."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            # every profiler session of a process after its first loses the
            # first kernel launched in it (seen on an H100 with torch 2.11):
            # let that be a throwaway fill, not the encode's first kernel
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if not os.path.isfile(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"the profiler wrote no trace to {path}")


class EventLog:
    """JSONL event stream; one line per event, flushed eagerly."""

    def __init__(self, sink: IO[str]):
        self._sink = sink
        self._t0 = time.time()

    def emit(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time() - self._t0, 4), "event": event, **fields}
        self._sink.write(json.dumps(rec) + "\n")
        self._sink.flush()
