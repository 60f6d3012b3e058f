"""full_search.roofline: the least time of the exhaustive ±16 search's
work in the traced launches over the device time of the kernels that do
it (full_search_kernels.txt), in %. Per P frame the work is every MB x
1089 candidates x 256 byte abs-diffs, at most four of them per lane of an
issued instruction (two 32-bit operands hold four byte pairs), at the
card's issue rate (peaks.json: SMs x lanes issued per SM per clock x the
highest SM clock); and the two 8-bit planes read once at the memory's
rate. The larger of the two bounds is the least time. PERF.md derives it.
"""

import json
import os

from portbench import lists

HERE = os.path.dirname(os.path.abspath(__file__))
CANDIDATES, MB = 33 * 33, 16


def least_s_per_p_frame(peak: dict, h: int, w: int) -> float:
    mbs = (h // MB) * (w // MB)
    lane_ops = mbs * CANDIDATES * MB * MB / 4
    issue = peak["sms"] * peak["issue_lanes_per_sm_per_clock"] * peak["max_sm_clock_hz"]
    return max(lane_ops / issue, 2 * h * w / peak["hbm_bytes_per_s"])


def read(rec):
    tr = rec["traced"]
    if not tr or not tr["p_frames"]:
        return None
    with open(os.path.join(os.path.dirname(HERE), "peaks.json")) as f:
        peak = json.load(f).get(rec.get("device_name"))
    if peak is None:
        return None
    search = lists.load("full_search_kernels.txt")
    ns = sum(e - s for n, s, e in tr["ops"] if lists.matches(n, search))
    if not ns:
        return None
    least = least_s_per_p_frame(peak, *rec["shape"]) * tr["p_frames"]
    return 100 * least / (ns / 1e9)
