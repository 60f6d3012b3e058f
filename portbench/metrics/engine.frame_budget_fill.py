"""engine.frame_budget_fill: how full the budgeted frame capacity is, in %:
the mean over the downloads of the window's untraced part of the
program's count `engine.frame_budget_fill_ppm`, which GopEngine.download
makes inside its `finish.copy` span: the download's largest frame payload
over the budgeted frame capacity of the engine's launch, in parts per
million, also where the download is a worst-case rerun's. Above 100 %
the budgeted launch could not hold the GOP's largest frame. None where
the program makes no such count (a program without it), or where the
recorder's ring dropped records of that part."""

from portbench import program_spans


def read(rec):
    recs = program_spans.records(program_spans.window_ns(rec))
    if recs is None:
        return None
    fills = [r[5] for r in recs
             if r[1] == "engine.frame_budget_fill_ppm" and r[5] is not None]
    if not fills:
        return None
    return sum(fills) / len(fills) / 1e4
