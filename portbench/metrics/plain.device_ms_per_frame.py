"""plain.device_ms_per_frame: device milliseconds per frame of every
kernel in the traced launches that is not one of the port's own
(port_kernels.txt): the plain PyTorch ops."""

from portbench import lists


def read(rec):
    tr = rec["traced"]
    if not tr or not tr["frames"]:
        return None
    own = lists.load("port_kernels.txt")
    ns = sum(e - s for n, s, e in tr["ops"]
             if lists.is_kernel(n) and not lists.matches(n, own))
    return ns / 1e6 / tr["frames"] if ns else None
