"""work_mem_peak_mib: the card memory the program holds in the window: the
caching allocator's peak of allocated bytes over the window, less the
harness's own input pool. (Its peak of reserved bytes, which also holds
the graphs' private pool and the allocator's cached segments, moves with
the payload sizes by whole segments from seed to seed; the result line
gives it as device.memory_peak_bytes.)"""


def read(rec):
    if not rec["mem_allocated_peak"]:
        return None
    return (rec["mem_allocated_peak"] - rec["pool_bytes"]) / 2**20
