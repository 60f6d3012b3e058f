"""setup_s: process start (the harness's first statement) to the first
timed launch: imports, CUDA start, the kernel library, the pool, the
engine's eager call and capture, the warm finishes."""


def read(rec):
    return rec["setup_s"]
