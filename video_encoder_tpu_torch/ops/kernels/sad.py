"""Wrappers of the motion kernels (csrc/full_search.cu, csrc/sad_at.cu,
csrc/mc_fetch.cu).

A CPU tensor takes the plain version in `ops/motion.py`; a CUDA tensor
launches the kernel, which is built at first use.
"""

from __future__ import annotations

import torch

from .. import motion
from . import build


def full_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Exhaustive ±16 SAD search: (dy, dx, sad) per 16x16 MB, int32.
    cur_y, ref_y: [H, W] int32 with H, W multiples of 16."""
    if cur_y.device.type == "cpu":
        return motion.full_search(cur_y, ref_y)
    h, w = _require_planes(cur_y, ref_y, "full_search")
    dy, dx, sad = (torch.empty((h // 16, w // 16), dtype=torch.int32,
                               device=cur_y.device) for _ in range(3))
    err = build.lib().tvc_full_search(
        cur_y.data_ptr(), ref_y.data_ptr(), h, w, dy.data_ptr(),
        dx.data_ptr(), sad.data_ptr(), build.stream_ptr(cur_y.device))
    build.check(err, "full_search")
    build.LAUNCHES["full_search"] += 1
    return dy, dx, sad


def _require_planes(cur_y, ref_y, name: str):
    h, w = cur_y.shape
    if h % 16 or w % 16:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of 16")
    build.require(cur_y, torch.int32, (h, w), f"{name} cur")
    build.require(ref_y, torch.int32, (h, w), f"{name} ref")
    return h, w


def sad_map_even(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """SADs of the 289 even-even mvs per MB, [H/16, W/16, 289] int32,
    candidate ((dy+16)/2)*17 + (dx+16)/2. cur_y, ref_y: [H, W] int32."""
    if cur_y.device.type == "cpu":
        return motion.sad_map_even(cur_y, ref_y)
    h, w = _require_planes(cur_y, ref_y, "sad_map_even")
    out = torch.empty((h // 16, w // 16, motion.NE * motion.NE),
                      dtype=torch.int32, device=cur_y.device)
    err = build.lib().tvc_sad_map_even(
        cur_y.data_ptr(), ref_y.data_ptr(), h, w, out.data_ptr(),
        build.stream_ptr(cur_y.device))
    build.check(err, "sad_map_even")
    build.LAUNCHES["sad_map_even"] += 1
    return out


def _require_mvs(dy, dx, h: int, w: int, bs: int, name: str):
    shape = tuple(dy.shape)
    if shape[-2:] != (h // bs, w // bs) or len(shape) not in (2, 3):
        raise ValueError(f"{name}: mvs of shape {shape} for a {h}x{w} plane")
    build.require(dy, torch.int32, shape, f"{name} dy")
    build.require(dx, torch.int32, shape, f"{name} dx")
    return shape, shape[0] if len(shape) == 3 else 1


def sad_at_mv(cur_y: torch.Tensor, ref_y: torch.Tensor, dy: torch.Tensor,
              dx: torch.Tensor, plane_of=None) -> torch.Tensor:
    """Per-MB 16x16 SAD at integer mvs dy, dx [K, H/16, W/16] or
    [H/16, W/16] int32 (|mv| <= 16): one launch for all K candidates.
    With plane_of (K <= 16 Python ints) ref_y is a stack of planes
    [P, H, W], P <= 16, and candidate k reads ref_y[plane_of[k]]."""
    if cur_y.device.type == "cpu":
        return motion.sad_at(cur_y, ref_y, dy, dx, plane_of=plane_of)
    h, w = cur_y.shape
    if h % 16 or w % 16:
        raise ValueError(f"sad_at_mv: {h}x{w} is not a multiple of 16")
    build.require(cur_y, torch.int32, (h, w), "sad_at_mv cur")
    shape, k = _require_mvs(dy, dx, h, w, 16, "sad_at_mv")
    code = 0
    if plane_of is None:
        build.require(ref_y, torch.int32, (h, w), "sad_at_mv ref")
    else:
        p = ref_y.shape[0]
        build.require(ref_y, torch.int32, (p, h, w), "sad_at_mv planes")
        if len(shape) != 3 or k != len(plane_of) or k > 16 or not all(
                0 <= q < min(p, 16) for q in plane_of):
            raise ValueError(f"sad_at_mv: planes {list(plane_of)} for {k} "
                             f"candidates on {p} planes")
        code = sum(q << (4 * j) for j, q in enumerate(plane_of))
    sad = torch.empty(shape, dtype=torch.int32, device=cur_y.device)
    err = build.lib().tvc_sad_at_mv(
        cur_y.data_ptr(), ref_y.data_ptr(), dy.data_ptr(), dx.data_ptr(), k,
        h, w, code, sad.data_ptr(), build.stream_ptr(cur_y.device))
    build.check(err, "sad_at_mv")
    build.LAUNCHES["sad_at_mv"] += 1
    return sad


def sad_at_mv_chroma(cur_c: torch.Tensor, ref_c: torch.Tensor,
                     dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Per-block 8x8 SAD of a chroma plane at integer chroma mvs dy, dx
    [K, H/8, W/8] or [H/8, W/8] int32 (|mv| <= 8): one launch."""
    if cur_c.device.type == "cpu":
        return motion.sad_at(cur_c, ref_c, dy, dx, 8)
    h, w = cur_c.shape
    if h % 8 or w % 8:
        raise ValueError(f"sad_at_mv_chroma: {h}x{w} is not a multiple of 8")
    build.require(cur_c, torch.int32, (h, w), "sad_at_mv_chroma cur")
    build.require(ref_c, torch.int32, (h, w), "sad_at_mv_chroma ref")
    shape, k = _require_mvs(dy, dx, h, w, 8, "sad_at_mv_chroma")
    sad = torch.empty(shape, dtype=torch.int32, device=cur_c.device)
    err = build.lib().tvc_sad_at_mv_chroma(
        cur_c.data_ptr(), ref_c.data_ptr(), dy.data_ptr(), dx.data_ptr(), k,
        h, w, sad.data_ptr(), build.stream_ptr(cur_c.device))
    build.check(err, "sad_at_mv_chroma")
    build.LAUNCHES["sad_at_mv_chroma"] += 1
    return sad


def _mc_fetch(ref: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
              bs: int, counter: str) -> torch.Tensor:
    h, w = ref.shape
    if h % bs or w % bs:
        raise ValueError(f"mc_fetch: {h}x{w} is not a multiple of {bs}")
    build.require(ref, torch.int32, (h, w), "mc_fetch ref")
    build.require(dy, torch.int32, (h // bs, w // bs), "mc_fetch dy")
    build.require(dx, torch.int32, (h // bs, w // bs), "mc_fetch dx")
    out = torch.empty_like(ref)
    err = build.lib().tvc_mc_fetch(
        ref.data_ptr(), dy.data_ptr(), dx.data_ptr(), h, w, bs,
        out.data_ptr(), build.stream_ptr(ref.device))
    build.check(err, "mc_fetch")
    build.LAUNCHES[counter] += 1
    return out


def mc_fetch_plane(ref_y: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor):
    """[H, W] luma predictor from per-MB mvs (|mv| <= 16)."""
    if ref_y.device.type == "cpu":
        return motion.mc_fetch_plane(ref_y, dy, dx, 16)
    return _mc_fetch(ref_y, dy, dx, 16, "mc_fetch_luma")


def mc_fetch_plane_chroma(ref_c: torch.Tensor, cdy: torch.Tensor,
                          cdx: torch.Tensor):
    """[H/2, W/2] chroma predictor from per-MB chroma mvs (|mv| <= 8)."""
    if ref_c.device.type == "cpu":
        return motion.mc_fetch_plane(ref_c, cdy, cdx, 8)
    return _mc_fetch(ref_c, cdy, cdx, 8, "mc_fetch_chroma")
