"""ctypes bindings to the C++ codec library: the port's own copy of
`video_encoder_tpu/codec/native.py`.

The serial entropy decode is byte-stream-bound and runs on the host in
C++. The library is built on first use from `oracle/oracle.cpp` with the
local g++ into `build/oracle/liboracle.so` (gitignored), never into
`oracle/`, so the port leaves the reference's tree as it found it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_ORACLE_SRC = os.path.join(_ROOT, "oracle", "oracle.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "oracle", "liboracle.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # rebuilt when oracle.cpp is newer than the library, as make would
    if (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_ORACLE_SRC) > os.path.getmtime(_LIB_PATH)):
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        r = subprocess.run(
            ["g++", "-O2", "-std=c++17", "-pthread", "-shared", "-fPIC",
             "-o", tmp, _ORACLE_SRC], capture_output=True
        )
        if r.returncode != 0:
            raise RuntimeError(f"liboracle.so build failed: {r.stderr.decode()[:300]}")
        os.replace(tmp, _LIB_PATH)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.tvc_parse_frame.restype = ctypes.c_int
    lib.tvc_parse_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.tvc_decode_stream.restype = ctypes.c_int
    lib.tvc_decode_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.tvc_parse_gop_planes.restype = ctypes.c_int
    lib.tvc_parse_gop_planes.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tvc_parse_frame_planes.restype = ctypes.c_int
    lib.tvc_parse_frame_planes.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def parse_frame(payload: bytes, nbits: int, is_p: bool, base_qp: int,
                nby: int, nbx: int, version: int = 1, cqpo: int = 0):
    """Entropy-decode one frame payload → (levels_zz [nby,nbx,6,64],
    dy, dx, is_inter, qp_mb) numpy arrays. version>=2 applies the SPEC.md
    §12 predictors during the parse (cqpo is resolved by the caller's
    reconstruction, not here)."""
    lib = _load()
    n = nby * nbx
    levels = np.zeros(n * 6 * 64, dtype=np.int32)
    mvs = np.zeros(n * 2, dtype=np.int32)
    inter = np.zeros(n, dtype=np.uint8)
    qps = np.zeros(n, dtype=np.int32)
    rc = lib.tvc_parse_frame(
        payload, nbits, int(is_p), base_qp, nby, nbx,
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mvs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        version,
    )
    if rc != 0:
        raise ValueError(f"corrupt TVC1 frame payload (code {rc})")
    mvs = mvs.reshape(nby, nbx, 2)
    return (
        levels.reshape(nby, nbx, 6, 64),
        mvs[:, :, 0],
        mvs[:, :, 1],
        inter.reshape(nby, nbx).astype(bool),
        qps.reshape(nby, nbx),
    )


def parse_frame_planes(
    payload: bytes, nbits: int, is_p: bool, base_qp: int, nby: int, nbx: int,
    version: int = 1,
):
    """Entropy-decode one frame payload into the per-plane int16 layout the
    device GOP decoder consumes: (ly [2nby,2nbx,64] i16, lcb, lcr
    [nby,nbx,64] i16, dy, dx, is_inter, qp_mb)."""
    lib = _load()
    n = nby * nbx
    ly = np.zeros((2 * nby, 2 * nbx, 64), dtype=np.int16)
    lcb = np.zeros((nby, nbx, 64), dtype=np.int16)
    lcr = np.zeros((nby, nbx, 64), dtype=np.int16)
    mvs = np.zeros(n * 2, dtype=np.int32)
    inter = np.zeros(n, dtype=np.uint8)
    qps = np.zeros(n, dtype=np.int32)
    rc = lib.tvc_parse_frame_planes(
        payload, nbits, int(is_p), base_qp, nby, nbx,
        ly.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lcb.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lcr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        mvs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        version,
    )
    if rc != 0:
        raise ValueError(f"corrupt TVC1 frame payload (code {rc})")
    mvs = mvs.reshape(nby, nbx, 2)
    return (
        ly, lcb, lcr, mvs[:, :, 0], mvs[:, :, 1],
        inter.reshape(nby, nbx).astype(bool), qps.reshape(nby, nbx),
    )


def parse_gop_planes(
    payloads: list[bytes],
    nbits: list[int],
    is_p: list[bool],
    base_qp: list[int],
    nby: int,
    nbx: int,
    nthreads: int = 0,
    version: int = 1,
):
    """Threaded entropy decode of a whole GOP (frame payloads parse
    independently — the reference's threaded demux stage done natively).
    Returns [T, ...]-stacked per-plane arrays matching parse_frame_planes."""
    lib = _load()
    t_frames = len(payloads)
    n = nby * nbx
    blob = b"".join(payloads)
    offs = np.zeros(t_frames + 1, dtype=np.uint64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    nb = np.asarray(nbits, dtype=np.uint64)
    isp = np.asarray(is_p, dtype=np.uint8)
    bqp = np.asarray(base_qp, dtype=np.int32)
    ly = np.zeros((t_frames, 2 * nby, 2 * nbx, 64), dtype=np.int16)
    lcb = np.zeros((t_frames, nby, nbx, 64), dtype=np.int16)
    lcr = np.zeros((t_frames, nby, nbx, 64), dtype=np.int16)
    mvs = np.zeros((t_frames, n, 2), dtype=np.int32)
    inter = np.zeros((t_frames, n), dtype=np.uint8)
    qps = np.zeros((t_frames, n), dtype=np.int32)
    if nthreads <= 0:
        # the combined decode path is parse-bound (BASELINE.md decode
        # table), so the thread count is the e2e throughput lever;
        # TVC_PARSE_THREADS overrides the all-cores default
        nthreads = int(os.environ.get("TVC_PARSE_THREADS", 0)) or min(
            t_frames, os.cpu_count() or 1
        )
    rc = lib.tvc_parse_gop_planes(
        blob,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        isp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        bqp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_frames, nby, nbx,
        ly.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lcb.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lcr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        mvs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nthreads, version,
    )
    if rc != 0:
        raise ValueError(f"corrupt TVC1 frame payload in GOP (code {rc})")
    return (
        ly, lcb, lcr,
        mvs[:, :, 0].reshape(t_frames, nby, nbx),
        mvs[:, :, 1].reshape(t_frames, nby, nbx),
        inter.reshape(t_frames, nby, nbx).astype(bool),
        qps.reshape(t_frames, nby, nbx),
    )


def decode_stream(data: bytes, width: int, height: int, nframes: int) -> np.ndarray:
    """Full native decode → uint8 array [nframes, w*h*3/2]."""
    lib = _load()
    fsz = width * height * 3 // 2
    out = np.zeros(nframes * fsz, dtype=np.uint8)
    rc = lib.tvc_decode_stream(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size
    )
    if rc < 0:
        raise ValueError(f"native decode failed (code {rc})")
    return out.reshape(nframes, fsz)
