"""engine.rerun_share: the share of the window's launches that overflowed
their budgeted capacities and were encoded again at the worst case, in %:
the program's count `engine.overflow_reruns` (GopEngine.run / run_batch
with xl) over its downloads (the `finish.copy` spans of
GopEngine.download, one per launch finished), both over the records that
start in the window's untraced part. None where the part holds no
download, or where the recorder's ring dropped records of that part."""

from portbench import program_spans


def read(rec):
    part = program_spans.window_ns(rec)
    downloads = program_spans.spans(part, "finish.copy")
    if downloads is None:
        return None
    reruns = sum(r[5] for r in program_spans.records(part)
                 if r[1] == "engine.overflow_reruns" and r[5] is not None)
    return 100 * reruns / len(downloads)
