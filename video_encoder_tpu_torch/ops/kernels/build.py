"""Build and load the port's CUDA kernels.

At first use every `csrc/*.cu` is compiled by nvcc, one process per source
and all started together, then linked into one shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c -o build/torch_kernels/obj_<hash>/<name>.o csrc/<name>.cu   (each)
    nvcc -shared -o build/torch_kernels/libtvc_<hash>.so build/torch_kernels/obj_<hash>/*.o

The library name carries a hash of the sources, so an edited source is
rebuilt. Each C entry point launches on the stream it is given (the
wrapper passes `torch.cuda.current_stream()`), does not synchronise, and
returns `cudaGetLastError()`; `check` raises on anything but 0.

`LAUNCHES` counts kernel launches per wrapper. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"full_search": 0, "sad_map_even": 0, "sad_at_mv": 0,
            "sad_at_mv_chroma": 0, "mc_fetch_luma": 0, "mc_fetch_chroma": 0,
            "code_plane": 0, "code_plane_qmat": 0, "block_pack": 0,
            "block_pack_v2": 0, "span_merge_mb": 0, "span_merge": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
# C signatures: pointers, ints, then the stream; every entry returns an int
_SIGNATURES = {
    "tvc_full_search": [_P, _P, _I, _I, _P, _P, _P, _P],
    "tvc_sad_map_even": [_P, _P, _I, _I, _P, _P],
    "tvc_sad_at_mv": [_P, _P, _P, _P, _I, _I, _I, _U64, _P, _P],
    "tvc_sad_at_mv_chroma": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "tvc_mc_fetch": [_P, _P, _P, _I, _I, _I, _P, _P],
    "tvc_code_plane": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "tvc_block_pack": [_P, _P, _I, _I, _I, _P, _P, _P],
    "tvc_span_merge_mb": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P],
    "tvc_span_merge": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}

_lib = None
build_seconds = 0.0
build_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    tag = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libtvc_{tag}.so")
    if not os.path.exists(so_path):
        obj_dir = os.path.join(BUILD_DIR, f"obj_{tag}.{os.getpid()}")
        os.makedirs(obj_dir, exist_ok=True)
        t0 = time.perf_counter()
        objs, procs = [], []
        for path in sources:
            obj = os.path.join(obj_dir, os.path.basename(path)[:-3] + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [s for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = f"{so_path}.{os.getpid()}.tmp"
        r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{build_log}")
        os.replace(tmp, so_path)
        shutil.rmtree(obj_dir, ignore_errors=True)
    dll = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = dll
    return dll


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t, dtype, shape, name: str) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
