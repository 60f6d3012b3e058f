"""Tracing, stage timing and structured events.

- StageTimer: per-stage wall-clock accumulation for the host pipeline.
- Recorder, and its one process-wide instance RECORDER: the program's own
  spans and counters, kept in a ring in memory (the GOP engine, its graph
  cache and the finish record into it; the benchmark's readers and the
  CLI's `--stage-timers` summary read it).
- trace(): context manager around torch.profiler, writing one
  Chrome/TensorBoard trace of the host's ops, the recorder's spans and,
  where CUDA is available, the device's kernels into a directory.
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


class Recorder(StageTimer):
    """The program's spans and counters, kept in memory.

    `with RECORDER.span(name):` times the block: as StageTimer.stage does,
    it adds the span's seconds and one call to `totals` and `counts` (so
    report() keeps StageTimer's format), and it writes the span into a
    ring as a record (seq, name, start, end, parent, None): its start and
    end in time.perf_counter_ns (the clock the benchmark's harness stamps
    its GOPs with) and `parent`, the seq of the span open around it, or
    -1. span() hands back the recorder itself, whose __enter__ opens the
    span just named: the fewest objects made per span, as the engine
    opens some 8 spans a GOP. `count(name, n)` adds n to `counters[name]`
    and writes the record (seq, name, t, t, parent, n), so a reader can
    tell which span's work it counts.

    The ring is a list of `size` slots allocated once. A record takes
    slot seq % size in the order its span opened (a span's slot is empty
    while it is open), so once the ring has gone round (`dropped` > 0)
    every record it still holds started at or after `oldest_ns()`, and
    every record it dropped started before it. Its size: the densest
    window of the benchmark, rcmb1080.g1 (one 30-frame GOP a launch, at
    most about 2,300 frames/s on an H100, 77 GOPs/s), writes 12 records a
    GOP (engine.launch, engine.copy_in, engine.replay, engine.copy_out,
    finish.copy, finish.copy.meta, finish.copy.words, finish.packets, and
    the counts engine.replays, engine.frame_budget_fill_ppm,
    finish.copy_staged and finish.copy_bytes): 51 s x 77 x 12 = 47,124
    records. 2**16 = 65,536 slots hold 1.39 times that.

    `anchor` is a (perf_counter_ns, time_ns) pair taken when the
    recorder starts (or is reset): epoch_ns() puts a time onto the
    Unix-epoch clock that torch.profiler's events are stamped on.

    `enabled` (default on) records nothing while false. `annotate`, set
    only by trace(), also opens a torch.profiler.record_function of each
    span's name, so a written trace shows the spans on the host's row;
    off, the recorder leaves no event in a profiler that someone else
    runs (the benchmark's traced window counts every device-side event
    as device work, and a record_function makes one on the device's row).
    One writer: the host pipeline's thread, as StageTimer's."""

    SIZE = 1 << 16
    # the open entry of a span begun while the recorder was off
    _OFF = (-1, None, -1, None, 0)

    def __init__(self, size: int = SIZE):
        super().__init__()
        if size & (size - 1):
            raise ValueError(f"the ring's size must be a power of 2: {size}")
        self.size, self.mask = size, size - 1
        self.ring: list = [None] * size
        self.enabled = True
        self.annotate = False
        self._name = None     # the span that span() named and __enter__ opens
        self.reset()

    def reset(self) -> None:
        """Forget every span and count, and take the anchor again."""
        self.totals.clear()
        self.counts.clear()
        self.counters: dict[str, int] = defaultdict(int)
        self.written = 0      # records ever written; the ring keeps the last
        # the open spans, innermost last: (seq, name, parent, annotation,
        # start ns)
        self.open: list[tuple] = []
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def span(self, name: str) -> "Recorder":
        """The span `name`, to be opened at once by `with`."""
        self._name = name
        return self

    def __enter__(self):
        opened = self.open
        if not self.enabled:
            opened.append(self._OFF)
            return self
        seq = self.written
        self.written = seq + 1
        self.ring[seq & self.mask] = None
        annotation = None
        if self.annotate:
            from torch.profiler import record_function
            annotation = record_function(self._name)
            annotation.__enter__()
        opened.append((seq, self._name, opened[-1][0] if opened else -1,
                       annotation, time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        seq, name, parent, annotation, t0 = self.open.pop()
        if seq < 0:
            return
        t1 = time.perf_counter_ns()
        if annotation is not None:
            annotation.__exit__(*exc)
        if self.written - seq <= self.size:     # its slot not taken again
            self.ring[seq & self.mask] = (seq, name, t0, t1, parent, None)
        self.totals[name] += (t1 - t0) / 1e9
        self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counters[name] and write the count into the ring."""
        if not self.enabled:
            return
        self.counters[name] += n
        seq = self.written
        self.written = seq + 1
        t = time.perf_counter_ns()
        opened = self.open
        self.ring[seq & self.mask] = (seq, name, t, t,
                                      opened[-1][0] if opened else -1, n)

    @property
    def dropped(self) -> int:
        """Records the ring has written over."""
        return max(0, self.written - self.size)

    def records(self) -> list[tuple]:
        """The closed records the ring holds, oldest first: (seq, name,
        start_ns, end_ns, parent seq or -1, value), value None for a span
        and the count for a count."""
        ring, mask = self.ring, self.mask
        return [r for r in (ring[seq & mask]
                            for seq in range(self.dropped, self.written))
                if r is not None]

    def oldest_ns(self) -> int | None:
        """The start of the oldest closed record the ring holds (None if
        it holds none)."""
        for seq in range(self.dropped, self.written):
            r = self.ring[seq & self.mask]
            if r is not None:
                return r[2]
        return None

    def epoch_ns(self, t: int) -> int:
        """A perf_counter_ns time on the Unix-epoch clock, by the anchor."""
        return t - self.anchor[0] + self.anchor[1]


# the process-wide recorder that the program's spans and counts go to
RECORDER = Recorder()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block, written to log_dir as
    `<host>_<pid>.<ns>.pt.trace.json` (the name TensorBoard's PyTorch
    profiler plugin reads; chrome://tracing and Perfetto open it too).
    No-op if log_dir is None or empty. CUDA kernels are recorded when
    CUDA is available, and RECORDER's spans as record_functions on the
    host's row."""
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
        RECORDER.annotate = True
        try:
            yield
        finally:
            RECORDER.annotate = False
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
