"""engine.capture_s: host seconds the program counts in
`engine.capture_ns` over the whole run: each graph key's eager first call
and its capture (GraphCache), in set-up unless an overflow rerun warms
its key in the window. None where no key was warmed (the CPU)."""

from portbench import program_spans


def read(rec):
    ns = program_spans.count_total(rec, "engine.capture_ns")
    return None if ns is None else ns / 1e9
