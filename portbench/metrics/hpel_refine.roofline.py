"""hpel_refine.roofline: the least time of format 4's half-pel refine in
the traced launches over the device time of the kernels that do it
(hpel_refine_kernels.txt), in %. Per P frame the refine needs at least the
current luma and the reconstructed reference luma read once, one byte a
sample (2 H W bytes at the memory's rate), and every MB x 9 candidates x
256 byte abs-diffs at four per lane of an issued instruction (at the
card's issue rate, as full_search.roofline counts them). The larger of the
two bounds is the least time: the bytes, at 1088x1920. A kernel that
builds the parity planes on the fly reads no more than that, so no
implementation can pass 100 %."""

import json
import os

from portbench import lists

HERE = os.path.dirname(os.path.abspath(__file__))
CANDIDATES, MB = 9, 16


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
    refine = lists.load("hpel_refine_kernels.txt")
    ns = sum(e - s for n, s, e in tr["ops"] if lists.matches(n, refine))
    if not ns:
        return None
    least = least_s_per_p_frame(peak, *rec["shape"]) * tr["p_frames"]
    return 100 * least / (ns / 1e9)
