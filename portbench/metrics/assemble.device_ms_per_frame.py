"""assemble.device_ms_per_frame: device milliseconds per frame of the
kernels of the frame pack's tail (assemble_kernels.txt: the MB headers and
totals, and the placement of the pieces into the frame's words; rc mb's
first pass launches the headers alone) in the traced launches. Their time
also counts in plain.device_ms_per_frame, whose list of the port's own
kernels (port_kernels.txt) does not name them. None where the traced
launches ran no such kernel: a program whose tail is plain ops."""

from portbench import lists


def read(rec):
    tr = rec["traced"]
    if not tr or not tr["frames"]:
        return None
    tail = lists.load("assemble_kernels.txt")
    ns = sum(e - s for n, s, e in tr["ops"] if lists.matches(n, tail))
    return ns / 1e6 / tr["frames"] if ns else None
