"""device.idle_share: the share of the window (its GOPs not traced, first
launch to last packet muxed) in which the card runs no GOP's encode. A
GOP's device span runs from a CUDA event recorded on the engine's stream
before its launch to one recorded after it, so the profiler's stretch of
graph replays does not enter; the finishes' own device work (the flag's
reduction, the downloads) counts as idle, as the card waits for the
host there."""


def read(rec):
    gops = [g for g in rec["gops"] if not g["traced"] and "t_done" in g]
    if len(gops) < 2:
        return None
    window = max(g["t_done"] for g in gops) - min(g["t_launch"] for g in gops)
    busy = sum(g["dev_ms"] for g in gops) / 1e3
    return 100 * max(0.0, 1 - busy / window)
