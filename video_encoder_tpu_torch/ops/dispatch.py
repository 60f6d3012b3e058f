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


def sad_at_mv(cur_y, ref_y, dy, dx):
    """Per-MB SADs at mvs [..., nby, nbx]."""
    if _FORCE == "plain":
        return motion.sad_at(cur_y, ref_y, dy, dx)
    return ksad.sad_at_mv(cur_y, ref_y, dy, dx)


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


def code_plane(cur, pred, q_blk, qbias: int = 8):
    """(levels [H/8, W/8, 64] zigzag order, recon [H, W]) of one plane."""
    if _FORCE == "plain":
        return transform.code_plane(cur, pred, q_blk, qbias)
    return kcodec.code_plane(cur, pred, q_blk, qbias)


def block_pack(levels_zz, n_words: int):
    """Format-1 per-block strings: (words [n, W] int64, bits [n] int32)."""
    if _FORCE == "plain":
        return kpack.plain_block_pack(levels_zz, n_words)
    return kpack.block_pack(levels_zz, n_words)


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
