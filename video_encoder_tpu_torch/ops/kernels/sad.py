"""Wrappers of the motion kernels (csrc/full_search.cu, csrc/sad_at.cu,
csrc/mc_fetch.cu).

A CPU tensor takes the plain version in `ops/motion.py`; a CUDA tensor
launches the kernel, which is built at first use. The `_g` wrappers take
the planes of G GOPs encoded in lockstep, [G, H, W], and launch one
G-batched kernel for all of them. Each kernel has one private launcher
for both forms: `lead` is () for a single plane and (G,) for a batch, and
stands in front of every shape and, as the entry's `g`, in its arguments.
"""

from __future__ import annotations

import torch

from .. import motion
from . import build


def _require_plane(t, batched: bool, mult: int, name: str):
    """(lead, h, w) of a contiguous int32 CUDA plane [H, W] or, batched,
    stack of planes [G, H, W], H and W multiples of mult."""
    *lead, h, w = t.shape
    if len(lead) != int(batched):
        raise ValueError(f"{name}: expected {2 + int(batched)} dimensions, "
                         f"got shape {tuple(t.shape)}")
    if h % mult or w % mult:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of {mult}")
    build.require(t, torch.int32, (*lead, h, w), name)
    return tuple(lead), h, w


def _launch(name: str, *args) -> None:
    """Launch entry tvc_<name>; raises unless it returns 0."""
    build.check(getattr(build.lib(), "tvc_" + name)(*args), name)


def _full_search(cur_y, ref_y, name: str, batched: bool):
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    build.require(ref_y, torch.int32, (*lead, h, w), f"{name} ref")
    dy, dx, sad = (torch.empty((*lead, h // 16, w // 16), dtype=torch.int32,
                               device=cur_y.device) for _ in range(3))
    _launch(name, cur_y.data_ptr(), ref_y.data_ptr(), *lead, h, w,
            dy.data_ptr(), dx.data_ptr(), sad.data_ptr(),
            build.stream_ptr(cur_y.device))
    build.LAUNCHES[name] += 1
    return dy, dx, sad


def full_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Exhaustive ±16 SAD search: (dy, dx, sad) per 16x16 MB, int32.
    cur_y, ref_y: [H, W] int32 with H, W multiples of 16."""
    if cur_y.device.type == "cpu":
        return motion.full_search(cur_y, ref_y)
    return _full_search(cur_y, ref_y, "full_search", False)


def full_search_g(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """full_search of each of G plane pairs in one launch: cur_y, ref_y
    [G, H, W] int32 -> (dy, dx, sad) [G, H/16, W/16] int32."""
    if cur_y.device.type == "cpu":
        return motion.full_search(cur_y, ref_y)
    return _full_search(cur_y, ref_y, "full_search_g", True)


def _sad_map_even(cur_y, ref_y, name: str, batched: bool):
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    build.require(ref_y, torch.int32, (*lead, h, w), f"{name} ref")
    out = torch.empty((*lead, h // 16, w // 16, motion.NE * motion.NE),
                      dtype=torch.int32, device=cur_y.device)
    _launch(name, cur_y.data_ptr(), ref_y.data_ptr(), *lead, h, w,
            out.data_ptr(), build.stream_ptr(cur_y.device))
    build.LAUNCHES[name] += 1
    return out


def sad_map_even(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """SADs of the 289 even-even mvs per MB, [H/16, W/16, 289] int32,
    candidate ((dy+16)/2)*17 + (dx+16)/2. cur_y, ref_y: [H, W] int32."""
    if cur_y.device.type == "cpu":
        return motion.sad_map_even(cur_y, ref_y)
    return _sad_map_even(cur_y, ref_y, "sad_map_even", False)


def sad_map_even_g(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """sad_map_even of each of G plane pairs in one launch: [G, H, W]
    int32 -> [G, H/16, W/16, 289] int32."""
    if cur_y.device.type == "cpu":
        return motion.sad_map_even(cur_y, ref_y)
    return _sad_map_even(cur_y, ref_y, "sad_map_even_g", True)


def _require_mvs(dy, dx, lead, h: int, w: int, bs: int, name: str):
    """(shape, K) of candidate mvs [*lead, K, H/bs, W/bs] or
    [*lead, H/bs, W/bs] (K = 1)."""
    shape = tuple(dy.shape)
    rest = shape[len(lead):]
    if (shape[:len(lead)] != lead or rest[-2:] != (h // bs, w // bs)
            or len(rest) not in (2, 3)):
        raise ValueError(f"{name}: mvs of shape {shape} for a "
                         f"{(*lead, h, w)} plane")
    build.require(dy, torch.int32, shape, f"{name} dy")
    build.require(dx, torch.int32, shape, f"{name} dx")
    return shape, rest[0] if len(rest) == 3 else 1


def _sad_at_mv(cur_y, ref_y, dy, dx, plane_of, name: str, batched: bool):
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    shape, k = _require_mvs(dy, dx, lead, h, w, 16, name)
    code, p = 0, 1
    if plane_of is None:
        build.require(ref_y, torch.int32, (*lead, h, w), f"{name} ref")
    else:
        p = ref_y.shape[-3]
        build.require(ref_y, torch.int32, (*lead, p, h, w), f"{name} planes")
        if (len(shape) != len(lead) + 3 or k != len(plane_of) or k > 16
                or not all(0 <= q < min(p, 16) for q in plane_of)):
            raise ValueError(f"{name}: planes {list(plane_of)} for {k} "
                             f"candidates on {p} planes")
        code = sum(q << (4 * j) for j, q in enumerate(plane_of))
    sad = torch.empty(shape, dtype=torch.int32, device=cur_y.device)
    _launch(name, cur_y.data_ptr(), ref_y.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), *lead, k, p, h, w, code, sad.data_ptr(),
            build.stream_ptr(cur_y.device))
    build.LAUNCHES[name] += 1
    return sad


def sad_at_mv(cur_y: torch.Tensor, ref_y: torch.Tensor, dy: torch.Tensor,
              dx: torch.Tensor, plane_of=None) -> torch.Tensor:
    """Per-MB 16x16 SAD at integer mvs dy, dx [K, H/16, W/16] or
    [H/16, W/16] int32 (|mv| <= 16): one launch for all K candidates.
    With plane_of (K <= 16 Python ints) ref_y is a stack of planes
    [P, H, W], P <= 16, and candidate k reads ref_y[plane_of[k]]."""
    if cur_y.device.type == "cpu":
        return motion.sad_at(cur_y, ref_y, dy, dx, plane_of=plane_of)
    return _sad_at_mv(cur_y, ref_y, dy, dx, plane_of, "sad_at_mv", False)


def sad_at_mv_g(cur_y: torch.Tensor, ref_y: torch.Tensor, dy: torch.Tensor,
                dx: torch.Tensor, plane_of=None) -> torch.Tensor:
    """sad_at_mv of G GOPs in one launch: cur_y [G, H, W], dy, dx
    [G, K, H/16, W/16] or [G, H/16, W/16] int32 (|mv| <= 16). With
    plane_of (K <= 16 Python ints, the same for every GOP) ref_y is
    [G, P, H, W], P <= 16, and candidate k of GOP g reads
    ref_y[g, plane_of[k]]; else ref_y is [G, H, W]."""
    if cur_y.device.type == "cpu":
        return motion.sad_at(cur_y, ref_y, dy, dx, plane_of=plane_of)
    return _sad_at_mv(cur_y, ref_y, dy, dx, plane_of, "sad_at_mv_g", True)


def _sad_at_mv_chroma(cur_c, ref_c, dy, dx, name: str, batched: bool):
    lead, h, w = _require_plane(cur_c, batched, 8, f"{name} cur")
    build.require(ref_c, torch.int32, (*lead, h, w), f"{name} ref")
    shape, k = _require_mvs(dy, dx, lead, h, w, 8, name)
    sad = torch.empty(shape, dtype=torch.int32, device=cur_c.device)
    _launch(name, cur_c.data_ptr(), ref_c.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), *lead, k, h, w, sad.data_ptr(),
            build.stream_ptr(cur_c.device))
    build.LAUNCHES[name] += 1
    return sad


def sad_at_mv_chroma(cur_c: torch.Tensor, ref_c: torch.Tensor,
                     dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Per-block 8x8 SAD of a chroma plane at integer chroma mvs dy, dx
    [K, H/8, W/8] or [H/8, W/8] int32 (|mv| <= 8): one launch."""
    if cur_c.device.type == "cpu":
        return motion.sad_at(cur_c, ref_c, dy, dx, 8)
    return _sad_at_mv_chroma(cur_c, ref_c, dy, dx, "sad_at_mv_chroma", False)


def sad_at_mv_chroma_g(cur_c: torch.Tensor, ref_c: torch.Tensor,
                       dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """sad_at_mv_chroma of G GOPs in one launch: cur_c, ref_c [G, H, W],
    dy, dx [G, K, H/8, W/8] or [G, H/8, W/8] int32 (|mv| <= 8)."""
    if cur_c.device.type == "cpu":
        return motion.sad_at(cur_c, ref_c, dy, dx, 8)
    return _sad_at_mv_chroma(cur_c, ref_c, dy, dx, "sad_at_mv_chroma_g", True)


def _mc_fetch(ref, dy, dx, bs: int, counter: str, batched: bool):
    """Entry tvc_mc_fetch(_g) at block size bs, counted under `counter`."""
    name = "mc_fetch_g" if batched else "mc_fetch"
    lead, h, w = _require_plane(ref, batched, bs, f"{name} ref")
    build.require(dy, torch.int32, (*lead, h // bs, w // bs), f"{name} dy")
    build.require(dx, torch.int32, (*lead, h // bs, w // bs), f"{name} dx")
    out = torch.empty_like(ref)
    _launch(name, ref.data_ptr(), dy.data_ptr(), dx.data_ptr(), *lead, h, w,
            bs, out.data_ptr(), build.stream_ptr(ref.device))
    build.LAUNCHES[counter] += 1
    return out


def mc_fetch_plane(ref_y: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor):
    """[H, W] luma predictor from per-MB mvs (|mv| <= 16)."""
    if ref_y.device.type == "cpu":
        return motion.mc_fetch_plane(ref_y, dy, dx, 16)
    return _mc_fetch(ref_y, dy, dx, 16, "mc_fetch_luma", False)


def mc_fetch_plane_chroma(ref_c: torch.Tensor, cdy: torch.Tensor,
                          cdx: torch.Tensor):
    """[H/2, W/2] chroma predictor from per-MB chroma mvs (|mv| <= 8)."""
    if ref_c.device.type == "cpu":
        return motion.mc_fetch_plane(ref_c, cdy, cdx, 8)
    return _mc_fetch(ref_c, cdy, cdx, 8, "mc_fetch_chroma", False)


def mc_fetch_plane_g(ref_y: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor):
    """[G, H, W] luma predictors from per-GOP, per-MB mvs [G, H/16, W/16]
    (|mv| <= 16), one launch."""
    if ref_y.device.type == "cpu":
        return motion.mc_fetch_plane(ref_y, dy, dx, 16)
    return _mc_fetch(ref_y, dy, dx, 16, "mc_fetch_luma_g", True)


def mc_fetch_plane_chroma_g(ref_c: torch.Tensor, cdy: torch.Tensor,
                            cdx: torch.Tensor):
    """[G, H/2, W/2] chroma predictors from per-GOP chroma mvs
    [G, H/16, W/16] (|mv| <= 8), one launch."""
    if ref_c.device.type == "cpu":
        return motion.mc_fetch_plane(ref_c, cdy, cdx, 8)
    return _mc_fetch(ref_c, cdy, cdx, 8, "mc_fetch_chroma_g", True)
