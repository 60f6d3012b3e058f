"""kernels.device_ms_per_frame: device milliseconds per frame of the
port's own kernels (port_kernels.txt) in the traced launches."""

from portbench import lists


def read(rec):
    tr = rec["traced"]
    if not tr or not tr["frames"]:
        return None
    own = lists.load("port_kernels.txt")
    ns = sum(e - s for n, s, e in tr["ops"] if lists.matches(n, own))
    return ns / 1e6 / tr["frames"] if ns else None
