"""The one dispatch rule of the port.

Every kernel wrapper launches its CUDA kernel for a CUDA tensor and takes
its plain PyTorch version for a CPU tensor; nothing falls back from the
kernel to the plain version. `force("plain")` routes CUDA tensors to the
plain versions too, so a kernel can be compared with its plain version on
the card (chip_smoke.py); it mirrors the reference's `force("jnp")`.
"""

from __future__ import annotations

import torch

from ..codec import pack
from . import motion, transform
from .kernels import codec as kcodec
from .kernels import entropy_pack as kpack
from .kernels import pack as kspan
from .kernels import sad as ksad

_FORCE: str | None = None  # None | "plain"


def force(mode: str | None) -> None:
    global _FORCE
    if mode not in (None, "plain"):
        raise ValueError(f"unknown dispatch mode {mode!r}")
    _FORCE = mode


def full_search(cur_y, ref_y):
    if _FORCE == "plain":
        return motion.full_search(cur_y, ref_y)
    return ksad.full_search(cur_y, ref_y)


def sad_map_even(cur_y, ref_y):
    """[nby, nbx, 289] SADs of the even-even mvs."""
    if _FORCE == "plain":
        return motion.sad_map_even(cur_y, ref_y)
    return ksad.sad_map_even(cur_y, ref_y)


def sad_at_mv(cur_y, ref_y, dy, dx, plane_of=None):
    """Per-MB SADs at mvs [..., nby, nbx]. With plane_of (K ints) ref_y is
    a stack [P, H, W] and candidate k of [K, nby, nbx] reads
    ref_y[plane_of[k]]: still one launch."""
    if _FORCE == "plain":
        return motion.sad_at(cur_y, ref_y, dy, dx, plane_of=plane_of)
    return ksad.sad_at_mv(cur_y, ref_y, dy, dx, plane_of)


def sad_at_mv_chroma(cur_c, ref_c, dy, dx):
    """Per-8x8-block SADs of a chroma plane at chroma mvs (|mv| <= 8)."""
    if _FORCE == "plain":
        return motion.sad_at(cur_c, ref_c, dy, dx, 8)
    return ksad.sad_at_mv_chroma(cur_c, ref_c, dy, dx)


def diamond_search(cur_y, ref_y):
    """Diamond search (SPEC.md §9) as a descent over the even-lattice SAD
    map: one sad_map_even pass, then every large-diamond candidate is a
    torch.gather from the map (the loop only visits even-even mvs), and
    the final ±1 step is one sad_at_mv launch for its four candidates. The
    descent is motion.diamond_search_with on both routes; only the two SAD
    sources switch. Returns (dy, dx, sad) int32."""
    meven = sad_map_even(cur_y, ref_y)
    nby, nbx, _ = meven.shape
    r = motion.R

    def sad_even(dy, dx):
        k = ((dy + r) >> 1) * motion.NE + ((dx + r) >> 1)
        kk = k.reshape(-1, nby, nbx).permute(1, 2, 0).long()
        return torch.gather(meven, 2, kk).permute(2, 0, 1).reshape(k.shape)

    def sad_small(dy, dx):
        return sad_at_mv(cur_y, ref_y, dy, dx)

    return motion.diamond_search_with(cur_y, sad_even, sad_small)


def mc_fetch_luma_plane(ref_y, dy, dx):
    """[H, W] luma predictor plane from per-MB mvs."""
    if _FORCE == "plain":
        return motion.mc_fetch_plane(ref_y, dy, dx, 16)
    return ksad.mc_fetch_plane(ref_y, dy, dx)


def mc_fetch_chroma_plane(ref_c, cdy, cdx):
    """[H/2, W/2] chroma predictor plane from per-MB chroma mvs."""
    if _FORCE == "plain":
        return motion.mc_fetch_plane(ref_c, cdy, cdx, 8)
    return ksad.mc_fetch_plane_chroma(ref_c, cdy, cdx)


def hpel_refine(cur_y, ref_y, dy, dx, planes=None):
    """Half-pel refinement of format 4 (SPEC.md §14.4): the nine
    candidates (2dy+u, 2dx+v), u, v in -1..1 row-major, first minimum.
    Candidate (u, v) has parity (|u|, |v|), so its SAD is an integer-mv
    SAD on that parity plane: one sad_at_mv launch for all nine. A
    candidate beyond ±32 half-pels is invalid (its integer part is
    clipped for the SAD). `planes` is motion.hpel_stack(ref_y), made here
    unless given. Returns (d2y, d2x, sad) int32, vectors in half-pels."""
    if planes is None:
        planes = motion.hpel_stack(ref_y)
    r, r2 = motion.R, 2 * motion.R
    uv = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
    k = torch.arange(9, device=cur_y.device)[:, None, None]
    u = torch.div(k, 3, rounding_mode="floor").int() - 1
    v = (k % 3).int() - 1
    d2y, d2x = 2 * dy + u, 2 * dx + v                     # [9, nby, nbx]
    valid = (d2y.abs() <= r2) & (d2x.abs() <= r2)
    sads = sad_at_mv(
        cur_y, planes, (d2y >> 1).clamp(-r, r), (d2x >> 1).clamp(-r, r),
        [abs(a) * 2 + abs(b) for a, b in uv])
    # packed int64 key cost * 16 + index: its minimum is the first minimum
    key = torch.where(valid, sads, motion.BIG).long() * 16 + k
    best = key.amin(0)
    pick = (best & 15)[None]
    return (d2y.gather(0, pick)[0], d2x.gather(0, pick)[0],
            (best >> 4).int())


def _hpel_mc(plane, d2y, d2x, fetch, px: int, planes=None):
    """Half-pel MC (SPEC.md §14.2): an integer fetch from each of the four
    parity planes, then a per-block select by (d2y & 1) * 2 + (d2x & 1)
    expanded to pixels."""
    if planes is None:
        planes = motion.hpel_stack(plane)
    iy, ix = d2y >> 1, d2x >> 1
    sel = (d2y & 1) * 2 + (d2x & 1)
    sel_px = sel.repeat_interleave(px, 0).repeat_interleave(px, 1)
    fetched = torch.stack([fetch(p, iy, ix) for p in planes])
    return fetched.gather(0, sel_px.long()[None])[0]


def mc_fetch_luma_plane_hpel(ref_y, d2y, d2x, planes=None):
    """[H, W] luma predictor plane from per-MB half-pel mvs."""
    return _hpel_mc(ref_y, d2y, d2x, mc_fetch_luma_plane, 16, planes)


def mc_fetch_chroma_plane_hpel(ref_c, cd2y, cd2x, planes=None):
    """[H/2, W/2] chroma predictor plane from per-MB chroma half-pel mvs."""
    return _hpel_mc(ref_c, cd2y, cd2x, mc_fetch_chroma_plane, 8, planes)


def code_plane(cur, pred, q_blk, qbias: int = 8, qmat: bool = False):
    """(levels [H/8, W/8, 64] zigzag order, recon [H, W]) of one plane;
    qmat applies the v3 quant matrix."""
    if _FORCE == "plain":
        return transform.code_plane(cur, pred, q_blk, qbias, qmat)
    return kcodec.code_plane(cur, pred, q_blk, qbias, qmat)


def intra_rows_code_plane(cur, q_blk, qbias: int = 8, reset_rows: int = 0,
                          qmat: bool = False):
    """v3 I-frame row scan of one plane, each [8, W] stripe through
    code_plane (one kernel launch per stripe on the GPU)."""
    return transform.intra_rows_code_plane(cur, q_blk, qbias, reset_rows,
                                           qmat, code=code_plane)


def block_pack(levels_zz, n_words: int, dc_pred=None, fmt: int = 1):
    """Per-block strings in the format-1 syntax, or with fmt >= 2 the
    format-2 syntax against dc_pred [n]: (words [n, W] int64, bits [n]
    int32)."""
    if _FORCE == "plain":
        return kpack.plain_block_pack(levels_zz, n_words, dc_pred, fmt)
    return kpack.block_pack(levels_zz, n_words, dc_pred, fmt)


def span_merge_mb(hw, yw, cbw, crw, piece_bits, m: int, cw: int,
                  n_strings: int):
    """Stage-1 span strings from per-MB piece sources: (words, bits, ovf)."""
    if _FORCE == "plain":
        return pack.span_merge_mb(hw, yw, cbw, crw, piece_bits, m, cw,
                                  n_strings)
    return kspan.span_merge_mb(hw, yw, cbw, crw, piece_bits, m, cw, n_strings)


def span_merge(strings, bits, g: int, stop: int, cw: int):
    """Stage-2 span strings from groups of stage-1 strings."""
    if _FORCE == "plain":
        return pack.span_merge(strings, bits, g, stop, cw)
    return kspan.span_merge(strings, bits, g, stop, cw)
