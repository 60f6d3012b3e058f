"""The one dispatch rule of the port.

Every kernel wrapper launches its CUDA kernel for a CUDA tensor and takes
its plain PyTorch version for a CPU tensor; nothing falls back from the
kernel to the plain version. `force("plain")` routes CUDA tensors to the
plain versions too, so a kernel can be compared with its plain version on
the card (chip_smoke.py); it mirrors the reference's `force("jnp")`.
"""

from __future__ import annotations

from . import motion, transform
from .kernels import codec as kcodec
from .kernels import entropy_pack as kpack
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
