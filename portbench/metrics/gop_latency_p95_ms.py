"""gop_latency_p95_ms: the 95th percentile over the window's GOPs (not
traced) of the time from a GOP's launch to its last packet muxed."""

import statistics


def read(rec):
    lat = [(g["t_done"] - g["t_launch"]) * 1e3 for g in rec["gops"]
           if not g["traced"] and "t_done" in g]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
