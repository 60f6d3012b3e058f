"""descent.device_ms_per_frame: device milliseconds per frame of the
kernel that does the diamond search's descent (descent_kernels.txt: the
walk over the even SAD map and the final ±1 step of every MB, one launch a
P step) in the traced launches. Its time also counts in
plain.device_ms_per_frame, whose list of the port's own kernels
(port_kernels.txt) does not name it. None where the traced launches ran
no such kernel: a full-search cell, or a program whose descent is plain
ops."""

from portbench import lists


def read(rec):
    tr = rec["traced"]
    if not tr or not tr["frames"]:
        return None
    descent = lists.load("descent_kernels.txt")
    ns = sum(e - s for n, s, e in tr["ops"] if lists.matches(n, descent))
    return ns / 1e6 / tr["frames"] if ns else None
