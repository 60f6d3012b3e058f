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


def sad_at_mv(cur_y: torch.Tensor, ref_y: torch.Tensor, dy: torch.Tensor,
              dx: torch.Tensor) -> torch.Tensor:
    """Per-MB 16x16 SAD at integer mvs dy, dx [K, H/16, W/16] or
    [H/16, W/16] int32 (|mv| <= 16): one launch for all K candidates."""
    if cur_y.device.type == "cpu":
        return motion.sad_at(cur_y, ref_y, dy, dx)
    h, w = _require_planes(cur_y, ref_y, "sad_at_mv")
    shape = tuple(dy.shape)
    if shape[-2:] != (h // 16, w // 16) or len(shape) not in (2, 3):
        raise ValueError(f"sad_at_mv: mvs of shape {shape} for a {h}x{w} plane")
    build.require(dy, torch.int32, shape, "sad_at_mv dy")
    build.require(dx, torch.int32, shape, "sad_at_mv dx")
    k = shape[0] if len(shape) == 3 else 1
    sad = torch.empty(shape, dtype=torch.int32, device=cur_y.device)
    err = build.lib().tvc_sad_at_mv(
        cur_y.data_ptr(), ref_y.data_ptr(), dy.data_ptr(), dx.data_ptr(), k,
        h, w, sad.data_ptr(), build.stream_ptr(cur_y.device))
    build.check(err, "sad_at_mv")
    build.LAUNCHES["sad_at_mv"] += 1
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
