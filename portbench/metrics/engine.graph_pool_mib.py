"""engine.graph_pool_mib: the card memory that the caching allocator has
reserved in the CUDA graphs' private pool after the run's last capture,
from the program's `engine.graph_pool_bytes` counts (each the change in
the pool's reserved bytes at a capture, so their sum is the pool's size).
work_mem_peak_mib, the peak of allocated bytes, leaves out what a captured
body freed inside its capture; this pool holds it. None off CUDA."""

from portbench import program_spans


def read(rec):
    n = program_spans.count_total(rec, "engine.graph_pool_bytes")
    return None if n is None else n / 2**20
