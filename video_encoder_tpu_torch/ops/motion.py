"""Motion estimation and compensation in plain PyTorch (SPEC.md §9).

Twin of `video_encoder_tpu/ops/motion.py` for the full-search path. These
are the plain versions the `full_search` and `mc_fetch` kernels are held
against, and the CPU path of the port.
"""

from __future__ import annotations

import torch

from ..codec import tables
from .transform import unblockify

R = tables.SEARCH_R
ND = 2 * R + 1  # 33 offsets per axis, 1089 candidates


def pad_ref(plane: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate pad a [H, W] plane by r on all sides (SPEC.md §2)."""
    h, w = plane.shape
    dev = plane.device
    rows = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    return plane[rows][:, cols]


def _mb_sums(x: torch.Tensor, n: int) -> torch.Tensor:
    """Per-n x n-block sums of a [..., H, W] array -> [..., H/n, W/n] int32."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // n, n, w // n, n).sum(dim=(-3, -1),
                                                      dtype=torch.int32)


def full_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Exhaustive ±16 SAD search. Returns (dy, dx, best_sad) per MB, int32.

    Candidate k = (dy+R)*33 + (dx+R) in row-major order; the minimum of
    the packed key sad*2048 + k is the strict-< first minimum of the
    reference (sad <= 65280 and k < 2048, so the key fits int32). One dy
    row of 33 candidates is evaluated per step."""
    h, w = cur_y.shape
    refpad = pad_ref(ref_y, R)
    best = None
    for ky in range(ND):
        rows = refpad[ky:ky + h]
        shifted = torch.stack([rows[:, kx:kx + w] for kx in range(ND)])
        sad = _mb_sums((cur_y - shifted).abs(), tables.MB)   # [33, nby, nbx]
        k = ky * ND + torch.arange(ND, dtype=torch.int32, device=cur_y.device)
        key = (sad * 2048 + k[:, None, None]).amin(0)
        best = key if best is None else torch.minimum(best, key)
    k = best & 2047
    return k // ND - R, k % ND - R, best >> 11


def mc_fetch(refpad: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
             bs: int, r: int) -> torch.Tensor:
    """Per-block predictor gather [nby, nbx, bs, bs] from refpad (padded
    by r) at the per-block integer mvs."""
    nby, nbx = dy.shape
    dev = refpad.device
    my = torch.arange(nby, device=dev)[:, None, None, None] * bs
    mx = torch.arange(nbx, device=dev)[None, :, None, None] * bs
    ii = torch.arange(bs, device=dev)[None, None, :, None]
    jj = torch.arange(bs, device=dev)[None, None, None, :]
    rows = r + my + dy.long()[:, :, None, None] + ii
    cols = r + mx + dx.long()[:, :, None, None] + jj
    return refpad[rows, cols]


def mc_fetch_plane(ref: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   bs: int) -> torch.Tensor:
    """[H, W] predictor plane from per-block mvs; |mv| <= bs, the pad
    radius (16 for luma MBs, 8 for chroma blocks)."""
    return unblockify(mc_fetch(pad_ref(ref, bs), dy, dx, bs, bs))


def intra_cost_and_dc(cur_y: torch.Tensor):
    """Per-MB DC and SAD against that DC (SPEC.md §9/§10), int32."""
    dc = (_mb_sums(cur_y, tables.MB) + 128) >> 8
    dc_px = dc.repeat_interleave(tables.MB, 0).repeat_interleave(tables.MB, 1)
    return dc, _mb_sums((cur_y - dc_px).abs(), tables.MB)
