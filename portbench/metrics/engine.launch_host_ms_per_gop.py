"""engine.launch_host_ms_per_gop: host milliseconds per GOP of the
program's span `engine.launch` (GraphCache.launch on a replay: the input
copies and qp fill, graph.replay() and the output clones), over the
window's untraced part, a launch serving gop_batch GOPs. None where no
graph replayed (the CPU)."""

from portbench import program_spans


def read(rec):
    return program_spans.ms_per_gop(rec, "engine.launch", rec["gop_batch"])
