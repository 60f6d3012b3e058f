"""The benchmark's reader of the frame pack's tail, `assemble.device_ms_
per_frame`, on hand-made traces: it reads the two kernels that
csrc/frame_pack.cu defines and nothing else, is silent where the traced
launches ran neither (a program whose tail is plain ops), and their time
still counts among the plain ops of `plain.device_ms_per_frame`, whose list
does not name them. The entry that reports it lists the five cells."""

import json
import os
import re

import pytest

from portbench import lists, run
from video_encoder_tpu_torch.ops.kernels import build

HEADERS = ("void (anonymous namespace)::mb_header_kernel<false>(int const*, "
           "unsigned char const*, int const*, int const*, int const*, "
           "int const*, int const*, int, int, int, int, bool, unsigned int*, "
           "int*, int*, int*, unsigned int*, long long, unsigned char*)")
HEADERS_V2 = HEADERS.replace("<false>", "<true>")
PLACE = ("(anonymous namespace)::frame_place_kernel((anonymous namespace)::"
         "Pieces, int const*, int const*, int, int, int, int, unsigned int*, "
         "long long*, unsigned char*)")
BLOCK_PACK = ("void (anonymous namespace)::block_pack_kernel<false>(int const*, "
              "int const*, int, int, unsigned int*, int*)")
CUMSUM = "void at_cuda_detail::cub::DeviceScanKernel<int64>(long*, long*)"
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


def test_reads_the_tail_kernels_only():
    ops = [(BLOCK_PACK, 0, 2 * MS), (HEADERS, 2 * MS, 3 * MS),
           (PLACE, 3 * MS, 5 * MS), (HEADERS_V2, 5 * MS, 6 * MS),
           (CUMSUM, 6 * MS, 9 * MS)]
    assert read("assemble.device_ms_per_frame", record(ops)) == pytest.approx(
        4 / 120)
    # the kernels are not among the port's own of the older list: their
    # time is in the plain ops' metric too
    assert read("plain.device_ms_per_frame", record(ops)) == pytest.approx(
        7 / 120)
    assert read("kernels.device_ms_per_frame", record(ops)) == pytest.approx(
        2 / 120)


def test_is_silent_without_the_kernels():
    assert read("assemble.device_ms_per_frame", record()) is None
    assert read("assemble.device_ms_per_frame", record([])) is None
    assert read("assemble.device_ms_per_frame",
                record([(BLOCK_PACK, 0, MS), (CUMSUM, MS, 2 * MS)])) is None
    assert read("assemble.device_ms_per_frame",
                record([(PLACE, 0, MS)], frames=0)) is None


def test_the_list_names_the_kernels_of_the_source():
    """assemble_kernels.txt names the two __global__ functions of
    csrc/frame_pack.cu, which port_kernels.txt does not."""
    with open(os.path.join(build.CSRC_DIR, "frame_pack.cu")) as f:
        src = f.read()
    names = lists.load("assemble_kernels.txt")
    assert names == ["mb_header_kernel", "frame_place_kernel"]
    for name in names:
        assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)\s*)?\n?"
                         + name + r"\(", src)
    for op in (HEADERS, HEADERS_V2, PLACE):
        assert not lists.matches(op, lists.load("port_kernels.txt"))


def test_the_entry_lists_every_cell():
    with open(os.path.join(run.HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "assemble.device_ms_per_frame"]
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    assert entry["moves"] == "encode_fps" and entry["source"] == "device_trace"
    assert entry["layer"] == "kernels"
    assert bench["per_layer"][-1] is entry
