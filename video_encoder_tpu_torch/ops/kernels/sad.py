"""Wrappers of the motion kernels (csrc/full_search.cu, csrc/sad_at.cu,
csrc/diamond.cu, csrc/mc_fetch.cu).

A CPU tensor takes the plain version in `ops/motion.py`; a CUDA tensor
launches the kernel, which is built at first use. The `_g` wrappers take
the planes of G GOPs encoded in lockstep, [G, H, W], and launch one
G-batched kernel for all of them. Each kernel has one private launcher
for both forms: `lead` is () for a single plane and (G,) for a batch, and
stands in front of every shape and, as the entry's `g`, in its arguments.

The `_pre_haloed` wrappers are the tile-sharded encode's: the current
plane is a shard [h, w] (or B shards, [B, h, w]) and the reference
`ref_ext` already carries the neighbour shards' pixels, [.., h + 2r, w]
(row halo; the columns edge-replicate) or [.., h + 2r, w + 2r] (both
halos, a 2-D tile grid). They go through the same private launchers
with `halo` = r; a single shard launches the batched entry with B = 1.

With TVC_SEA=1 in the environment, read at every call, the three full
search wrappers (`full_search`, `full_search_g`, `full_search_pre_haloed`)
launch the successive-elimination entry of their form instead of the
exhaustive one, with the same result, as the reference's Pallas wrappers
do (`_sea_enabled`); a CPU tensor takes the plain exhaustive search
whatever the variable says, as the reference's jnp path does. The SEA
kernel evaluates its rows on words of four 8-bit samples, so its planes
hold samples 0-255, as every plane of the codec does (`sad_map_even`
takes the same).
"""

from __future__ import annotations

import ctypes
import os

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


def _require_ref(ref, lead, h: int, w: int, halo: int, name: str,
                 planes: int | None = None):
    """Checks a contiguous int32 CUDA reference [*lead, (planes,) rh, rw]
    for an [h, w] plane and returns the arguments its entry takes for it:
    () with halo 0, where (rh, rw) must be (h, w); else (rh, rw), with rh
    = h + 2 halo and rw = w or w + 2 halo."""
    rh, rw = ref.shape[-2:]
    if rh != h + 2 * halo or rw not in (w, w + 2 * halo):
        raise ValueError(f"{name}: a reference of {rh}x{rw} is not a "
                         f"{h}x{w} plane with a halo of {halo}")
    mid = () if planes is None else (planes,)
    build.require(ref, torch.int32, (*lead, *mid, rh, rw), name)
    return (rh, rw) if halo else ()


def _launch(name: str, *args) -> None:
    """Launch entry tvc_<name>; raises unless it returns 0."""
    build.check(getattr(build.lib(), "tvc_" + name)(*args), name)


def _sea_enabled() -> bool:
    """Successive-elimination pruning for the full search (opt-in:
    TVC_SEA=1), read at every call as the reference reads it.

    Both variants give identical (dy, dx, sad): SEA only skips dy rows
    whose exact column-sum lower bound already exceeds the best SAD found,
    so the packed-key minimum (and the spec's first-occurrence tie-break)
    is unchanged. Off by default, as in the reference, whose TPU
    measurement found that on clean panning references it prunes most
    rows, but that against the previous recon, which the engine searches,
    the quantization noise puts a floor under the best SAD while the
    column-sum bound cancels that noise, so it pruned nothing and cost its
    bound. On an H100 the port's kernel (its rows in two batches, on words
    of four 8-bit samples) prunes about half the rows against a qp-28
    recon and takes 0.36x the exhaustive kernel's time there, 0.25x on a
    clean reference and 0.50x on noise, where nothing prunes; the full
    cell's search fell from 6.0 to 1.8 ms of device time per GOP (PERF.md,
    sections 6 and 7). Part of that is the packed arithmetic, which the
    exhaustive kernel does not use yet, so the default stays the
    reference's until content of several kinds has been measured."""
    return os.environ.get("TVC_SEA", "0") == "1"


def _full_search(cur_y, ref_y, name: str, batched: bool, halo: int = 0,
                 rows: bool | None = None):
    """Entry tvc_<name> (full_search, full_search_g, full_search_haloed or
    their SEA twins full_search_sea, _sea_g, _sea_haloed), counted under
    its name. rows: None for an entry without a rows output; for
    tvc_full_search_sea, whether to fill it with the dy rows each MB
    evaluated (the stats form) or pass null."""
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    ext = _require_ref(ref_y, lead, h, w, halo, f"{name} ref")
    outs = [torch.empty((*lead, h // 16, w // 16), dtype=torch.int32,
                        device=cur_y.device) for _ in range(3 + bool(rows))]
    rows_arg = () if rows is None else (outs[3].data_ptr() if rows else None,)
    _launch(name, cur_y.data_ptr(), ref_y.data_ptr(),
            *(lead or (1,) if halo else lead), h, w, *ext,
            *(t.data_ptr() for t in outs[:3]), *rows_arg,
            build.stream_ptr(cur_y.device))
    build.LAUNCHES[name] += 1
    return tuple(outs)


def full_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Exhaustive ±16 SAD search: (dy, dx, sad) per 16x16 MB, int32.
    cur_y, ref_y: [H, W] int32 with H, W multiples of 16. With TVC_SEA=1
    a CUDA tensor launches the SEA kernel: the same result for samples
    0-255."""
    if cur_y.device.type == "cpu":
        return motion.full_search(cur_y, ref_y)
    if _sea_enabled():
        return _full_search(cur_y, ref_y, "full_search_sea", False, rows=False)
    return _full_search(cur_y, ref_y, "full_search", False)


def full_search_g(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """full_search of each of G plane pairs in one launch: cur_y, ref_y
    [G, H, W] int32 -> (dy, dx, sad) [G, H/16, W/16] int32."""
    if cur_y.device.type == "cpu":
        return motion.full_search(cur_y, ref_y)
    return _full_search(cur_y, ref_y, "full_search_sea_g" if _sea_enabled()
                        else "full_search_g", True)


def full_search_sea_stats(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """The SEA full search whatever TVC_SEA says, with the count of dy
    rows each MB evaluated exactly: (dy, dx, sad, rows) [H/16, W/16] int32
    of planes [H, W] int32 of samples 0-255; (dy, dx, sad) equal
    full_search's. The
    reference counts per tile of MBs: its count of a tile is the number of
    rows in the OR of its MBs' masks (motion.full_search_sea's mask)."""
    if cur_y.device.type == "cpu":
        return motion.full_search_sea(cur_y, ref_y)
    return _full_search(cur_y, ref_y, "full_search_sea", False, rows=True)


def _sad_map(cur_y, ref_y, name: str, batched: bool):
    """Entry tvc_<name>: sad_map(_g) (1089 candidates per MB) or
    sad_map_even(_g) (289)."""
    nds = motion.NE if "even" in name else motion.ND
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    build.require(ref_y, torch.int32, (*lead, h, w), f"{name} ref")
    out = torch.empty((*lead, h // 16, w // 16, nds * nds),
                      dtype=torch.int32, device=cur_y.device)
    _launch(name, cur_y.data_ptr(), ref_y.data_ptr(), *lead, h, w,
            out.data_ptr(), build.stream_ptr(cur_y.device))
    build.LAUNCHES[name] += 1
    return out


def sad_map_even(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """SADs of the 289 even-even mvs per MB, [H/16, W/16, 289] int32,
    candidate ((dy+16)/2)*17 + (dx+16)/2. cur_y, ref_y: [H, W] int32 of
    8-bit samples (0-255, as every plane of the codec holds: the kernel
    packs four to a word)."""
    if cur_y.device.type == "cpu":
        return motion.sad_map_even(cur_y, ref_y)
    return _sad_map(cur_y, ref_y, "sad_map_even", False)


def sad_map_even_g(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """sad_map_even of each of G plane pairs in one launch: [G, H, W]
    int32 of 8-bit samples -> [G, H/16, W/16, 289] int32."""
    if cur_y.device.type == "cpu":
        return motion.sad_map_even(cur_y, ref_y)
    return _sad_map(cur_y, ref_y, "sad_map_even_g", True)


def sad_map(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """SADs of all 1089 mvs per MB, [H/16, W/16, 1089] int32, candidate
    (dy+16)*33 + (dx+16). cur_y, ref_y: [H, W] int32."""
    if cur_y.device.type == "cpu":
        return motion.sad_map(cur_y, ref_y)
    return _sad_map(cur_y, ref_y, "sad_map", False)


def sad_map_g(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """sad_map of each of G plane pairs in one launch: [G, H, W] int32 ->
    [G, H/16, W/16, 1089] int32."""
    if cur_y.device.type == "cpu":
        return motion.sad_map(cur_y, ref_y)
    return _sad_map(cur_y, ref_y, "sad_map_g", True)


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


def _sad_at_mv(cur_y, ref_y, dy, dx, plane_of, name: str, batched: bool,
               halo: int = 0):
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    shape, k = _require_mvs(dy, dx, lead, h, w, 16, name)
    code, p = 0, None
    if plane_of is not None:
        p = ref_y.shape[-3]
        if (len(shape) != len(lead) + 3 or k != len(plane_of) or k > 16
                or not all(0 <= q < min(p, 16) for q in plane_of)):
            raise ValueError(f"{name}: planes {list(plane_of)} for {k} "
                             f"candidates on {p} planes")
        code = sum(q << (4 * j) for j, q in enumerate(plane_of))
    ext = _require_ref(ref_y, lead, h, w, halo, f"{name} ref", p)
    sad = torch.empty(shape, dtype=torch.int32, device=cur_y.device)
    _launch(name, cur_y.data_ptr(), ref_y.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), *(lead or (1,) if halo else lead), k, p or 1, h, w,
            *ext, code, sad.data_ptr(), build.stream_ptr(cur_y.device))
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


def diamond_descent(cur_y: torch.Tensor, ref_y: torch.Tensor,
                    meven: torch.Tensor):
    """The diamond search of planes [(G,) H, W] int32 over their even SAD
    map meven [(G,) H/16, W/16, 289] int32 (sad_map_even's): the
    large-diamond walk and the final ±1 step of every MB of every GOP in
    one launch, counted under diamond_descent or, with a G axis,
    diamond_descent_g. Returns (dy, dx, sad) [(G,) H/16, W/16] int32."""
    if cur_y.device.type == "cpu":
        return motion.diamond_descent(cur_y, ref_y, meven)
    batched = cur_y.ndim == 3
    name = "diamond_descent_g" if batched else "diamond_descent"
    lead, h, w = _require_plane(cur_y, batched, 16, f"{name} cur")
    build.require(ref_y, torch.int32, (*lead, h, w), f"{name} ref")
    build.require(meven, torch.int32,
                  (*lead, h // 16, w // 16, motion.NE * motion.NE),
                  f"{name} map")
    outs = [torch.empty((*lead, h // 16, w // 16), dtype=torch.int32,
                        device=cur_y.device) for _ in range(3)]
    _launch("diamond_descent", cur_y.data_ptr(), ref_y.data_ptr(),
            meven.data_ptr(), *(lead or (1,)), h, w,
            *(t.data_ptr() for t in outs), build.stream_ptr(cur_y.device))
    build.LAUNCHES[name] += 1
    return tuple(outs)


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


def _mc_fetch(ref, dy, dx, bs: int, counter: str, batched: bool,
              halo: int = 0):
    """Entry tvc_mc_fetch(_g) or, with a halo, tvc_mc_fetch_haloed at
    block size bs, counted under `counter`. The predictor's extents are
    the mv grid's times bs."""
    name = "mc_fetch_haloed" if halo else "mc_fetch_g" if batched else "mc_fetch"
    *lead, nby, nbx = dy.shape
    if len(lead) != int(batched):
        raise ValueError(f"{name}: expected mvs of {2 + int(batched)} "
                         f"dimensions, got shape {tuple(dy.shape)}")
    lead, h, w = tuple(lead), nby * bs, nbx * bs
    ext = _require_ref(ref, lead, h, w, halo, f"{name} ref")
    build.require(dy, torch.int32, (*lead, nby, nbx), f"{name} dy")
    build.require(dx, torch.int32, (*lead, nby, nbx), f"{name} dx")
    out = torch.empty((*lead, h, w), dtype=torch.int32, device=ref.device)
    _launch(name, ref.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            *(lead or (1,) if halo else lead), h, w, *ext, bs, out.data_ptr(),
            build.stream_ptr(ref.device))
    build.LAUNCHES[counter] += 1
    return out


# the predictor's launch geometry by (vector shape, luma and chroma
# reference shapes, halo): (output size, the address of the entry's
# int[8] geometry, the three output views' as_strided arguments,
# the counter, the int array that holds the geometry)
_PREDICT_GEOMETRY = {}


def _predict_geometry(key):
    """The launch geometry of tvc_mc_predict for these shapes (see
    _mc_predict); raises on shapes the kernel does not take."""
    shape, y_shape, c_shape, halo = key
    *lead, nby, nbx = shape
    *ly, p, rh, rw = y_shape
    *lc, pc, crh, crw = c_shape
    h, w = nby * 16, nbx * 16
    if not (len(lead) <= 1 and ly == lc == lead and p == pc and p in (1, 4)
            and rh == h + 32 * halo and crh == h // 2 + 16 * halo
            and rw in (w, w + 32 * halo) and crw == w // 2 + (rw - w) // 2):
        raise ValueError(
            f"mc_predict: references {tuple(y_shape)} and {tuple(c_shape)} "
            f"are not stacks of one plane or four parity planes for "
            f"vectors {tuple(shape)}{' with a halo' if halo else ''}")
    b = lead[0] if lead else 1
    n, k = b * h * w, len(lead) + 2
    ints = (ctypes.c_int * 8)(b, p, h, w, rh, rw, crh, crw)
    chroma = (*lead, h // 2, w // 2), (h * w // 4, w // 2, 1)[-k:]
    geo = (n + n // 2, ctypes.addressof(ints),
           ((*lead, h, w), (h * w, w, 1)[-k:], 0), (*chroma, n),
           (*chroma, n + n // 4),
           "mc_predict_haloed" if halo else "mc_predict_g" if lead
           else "mc_predict", ints)
    _PREDICT_GEOMETRY[key] = geo
    return geo


def _mc_predict(refs, dy, dx, is_inter, halo: bool):
    """Entry tvc_mc_predict: the three predictors of a P frame step in
    one launch, counted under mc_predict, mc_predict_g or, with a halo,
    mc_predict_haloed. One output buffer, luma then cb then cr, each view
    contiguous. At about 0.01 ms of device time per launch the host's
    time per call is the cost: the geometry is kept per shape and passed
    as one pointer, the rest is plain attribute comparisons, and the
    stream is read once."""
    ref_y, ref_cb, ref_cr = refs
    shape = dy.shape
    key = (shape, ref_y.shape, ref_cb.shape, halo)
    size, geometry, vy, vcb, vcr, name, _ = (_PREDICT_GEOMETRY.get(key)
                                             or _predict_geometry(key))
    d, i32 = dy.get_device(), torch.int32     # -1 off the card
    if not (d >= 0 and ref_cr.shape == ref_cb.shape
            and dx.shape == shape and is_inter.shape == shape
            and dy.dtype == i32 and dx.dtype == i32 and ref_y.dtype == i32
            and ref_cb.dtype == i32 and ref_cr.dtype == i32
            and is_inter.dtype == torch.bool
            and dx.get_device() == d and is_inter.get_device() == d
            and ref_y.get_device() == d and ref_cb.get_device() == d
            and ref_cr.get_device() == d
            and dy.is_contiguous() and dx.is_contiguous()
            and is_inter.is_contiguous() and ref_y.is_contiguous()
            and ref_cb.is_contiguous() and ref_cr.is_contiguous()):
        raise ValueError(
            f"mc_predict: references {[tuple(r.shape) for r in refs]} "
            f"{[r.dtype for r in refs]} on {[str(r.device) for r in refs]}, "
            f"vectors {tuple(shape)} {dy.dtype}/{dx.dtype}, modes "
            f"{tuple(is_inter.shape)} {is_inter.dtype}: not contiguous int32 "
            f"CUDA tensors of one device")
    out = torch.empty(size, dtype=i32, device=d)
    err = build.lib().tvc_mc_predict(
        ref_y.data_ptr(), ref_cb.data_ptr(), ref_cr.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), is_inter.data_ptr(), geometry, out.data_ptr(),
        build.stream_ptr(d))
    if err:
        build.check(err, "mc_predict")
    build.LAUNCHES[name] += 1
    return out.as_strided(*vy), out.as_strided(*vcb), out.as_strided(*vcr)


def mc_predict(refs, dy: torch.Tensor, dx: torch.Tensor,
               is_inter: torch.Tensor):
    """(pred_y, pred_cb, pred_cr) of a P frame step in one launch: refs
    (luma, cb, cr) are stacks [(G,) P, H, W], [(G,) P, H/2, W/2] int32
    with P = 1, or P = 4 parity planes (motion.hpel_stack order) and the
    vectors in half-pels; dy, dx [(G,) H/16, W/16] int32 per MB in luma
    units (the chroma vector is dy >> 1); is_inter [(G,) H/16, W/16]
    bool, an intra MB predicting 128."""
    if not dy.is_cuda:
        return motion.mc_predict(refs, dy, dx, is_inter)
    return _mc_predict(refs, dy, dx, is_inter, False)


def mc_predict_pre_haloed(refs_ext, dy: torch.Tensor, dx: torch.Tensor,
                          is_inter: torch.Tensor):
    """mc_predict of B shards [B, h, w] (or one, [h, w]) from pre-haloed
    reference stacks: luma [.., P, h + 32, w or w + 32], chroma
    [.., P, h/2 + 16, w/2 or w/2 + 16]; one launch."""
    if not dy.is_cuda:
        return motion.mc_predict(refs_ext, dy, dx, is_inter, halo=True)
    return _mc_predict(refs_ext, dy, dx, is_inter, True)


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


def full_search_pre_haloed(cur_y: torch.Tensor, ref_ext: torch.Tensor):
    """full_search of a shard against its pre-haloed reference: cur_y
    [h, w] or [B, h, w] int32, ref_ext [.., h + 32, w or w + 32] int32 ->
    (dy, dx, sad) [.., h/16, w/16] int32, one launch."""
    if cur_y.device.type == "cpu":
        return motion.full_search_pre_haloed(cur_y, ref_ext)
    return _full_search(cur_y, ref_ext, "full_search_sea_haloed"
                        if _sea_enabled() else "full_search_haloed",
                        cur_y.ndim == 3, motion.R)


def mc_fetch_pre_haloed(ref_ext: torch.Tensor, dy: torch.Tensor,
                        dx: torch.Tensor, bs: int, r: int):
    """[.., h, w] predictor of a shard from its pre-haloed reference
    ref_ext [h + 2r, w or w + 2r] or [B, ...] int32 at mvs dy, dx
    [.., h/bs, w/bs] int32 (|mv| <= r): luma (bs, r) = (16, 16), chroma
    (8, 8); one launch."""
    if ref_ext.device.type == "cpu":
        return motion.mc_fetch_pre_haloed(ref_ext, dy, dx, bs, r)
    if (bs, r) not in ((16, 16), (8, 8)):
        raise ValueError(f"mc_fetch_haloed: block {bs} with radius {r}")
    return _mc_fetch(ref_ext, dy, dx, bs,
                     "mc_fetch_haloed_" + ("luma" if bs == 16 else "chroma"),
                     dy.ndim == 3, r)


def sad_at_mv_pre_haloed(cur_y: torch.Tensor, ref_ext: torch.Tensor,
                         dy: torch.Tensor, dx: torch.Tensor, plane_of=None):
    """sad_at_mv of a luma shard against pre-haloed planes: cur_y [h, w]
    or [B, h, w] int32; ref_ext [.., h + 32, w or w + 32] or, with
    plane_of (K <= 16 ints), a stack [.., P, h + 32, .], P <= 16; dy, dx
    [.., K, h/16, w/16] or [.., h/16, w/16] int32 (|mv| <= 16). One
    launch for all K candidates."""
    if cur_y.device.type == "cpu":
        return motion.sad_at_pre_haloed(cur_y, ref_ext, dy, dx, plane_of)
    return _sad_at_mv(cur_y, ref_ext, dy, dx, plane_of, "sad_at_mv_haloed",
                      cur_y.ndim == 3, motion.R)
