"""engine.host_calls_per_gop: the host's calls that submit device work
(kernel and graph launches, copies, fills) per GOP in the traced launches
and finishes, each call counted in the harness span it fell in."""


def read(rec):
    tr = rec["traced"]
    if not tr or tr["launches"] < 1 or tr["finishes"] < 1:
        return None
    by = tr["calls_by_span"]
    launch = by.get("launch", 0)
    finish = sum(n for s, n in by.items() if s.startswith("finish."))
    if not launch:
        return None
    return (launch / tr["launches"] + finish / tr["finishes"]) / rec["gop_batch"]
