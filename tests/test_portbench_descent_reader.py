"""The benchmark's reader of the descent kernel's time,
`descent.device_ms_per_frame`, on hand-made traces: it reads the kernel
that csrc/diamond.cu defines and nothing else, is silent where the traced
launches ran no descent kernel (a full-search cell, or a program whose
descent is plain ops), and its time still counts among the plain ops of
`plain.device_ms_per_frame`, whose list does not name it. The entry that
reports it lists the two config-3 cells."""

import json
import os
import re

import pytest

from portbench import lists, run
from video_encoder_tpu_torch.ops.kernels import build

DESCENT = ("void (anonymous namespace)::descent_kernel(int const*, int const*,"
           " int const*, int, int, int, int*, int*, int*)")
EVEN_MAP = "void (anonymous namespace)::even_map_kernel<true>(int const*, int)"
SAD_AT = "void (anonymous namespace)::sad_at_kernel<16>(int const*, int)"
GATHER = "void at::native::_scatter_gather_elementwise_kernel<128, 8>(int)"
MS = 1_000_000        # ns


def record(ops=None, frames=120):
    traced = None if ops is None else dict(
        launches=4, finishes=3, frames=frames, p_frames=frames - 4, ops=ops,
        calls_by_span={}, window_s=0.2, busy_s=0.1, breakdown={})
    return dict(setup_s=2.0, window_s=0.8, gop_batch=1, frames_per_gop=30,
                frames=frames, gops=[], pool_bytes=0, mem_allocated_peak=0,
                shape=(1088, 1920), traced=traced,
                device_name="NVIDIA H100 80GB HBM3")


def read(name, rec):
    return run.reader(name).read(rec)


def test_reads_the_descent_kernel_only():
    ops = [(EVEN_MAP, 0, 2 * MS), (DESCENT, 2 * MS, 3 * MS),
           (DESCENT, 4 * MS, 5 * MS), (SAD_AT, 5 * MS, 6 * MS),
           (GATHER, 6 * MS, 9 * MS)]
    assert read("descent.device_ms_per_frame", record(ops)) == pytest.approx(
        2 / 120)
    # the kernel is not among the port's own of the older list: its time
    # is in the plain ops' metric too
    assert read("plain.device_ms_per_frame", record(ops)) == pytest.approx(
        5 / 120)
    assert read("kernels.device_ms_per_frame", record(ops)) == pytest.approx(
        3 / 120)


def test_is_silent_without_the_kernel():
    assert read("descent.device_ms_per_frame", record()) is None
    assert read("descent.device_ms_per_frame", record([])) is None
    assert read("descent.device_ms_per_frame",
                record([(EVEN_MAP, 0, MS), (SAD_AT, MS, 2 * MS),
                        (GATHER, 2 * MS, 3 * MS)])) is None
    assert read("descent.device_ms_per_frame",
                record([(DESCENT, 0, MS)], frames=0)) is None


def test_the_list_names_the_kernel_of_the_source():
    """descent_kernels.txt names a __global__ function of csrc/diamond.cu,
    and one that port_kernels.txt does not."""
    with open(os.path.join(build.CSRC_DIR, "diamond.cu")) as f:
        src = f.read()
    names = lists.load("descent_kernels.txt")
    assert names == ["descent_kernel"]
    assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)\s*)?"
                     r"descent_kernel\(", src)
    assert not lists.matches(DESCENT, lists.load("port_kernels.txt"))


def test_the_entry_lists_the_config3_cells():
    with open(os.path.join(run.HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "descent.device_ms_per_frame"]
    assert entry["workloads"] == ["rcmb1080.g1", "rcmb1080.g4"]
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    assert {cells[c] for c in entry["workloads"]} == {"tvc1-1080-diamond-rcmb"}
    assert entry["moves"] == "encode_fps" and entry["source"] == "device_trace"
