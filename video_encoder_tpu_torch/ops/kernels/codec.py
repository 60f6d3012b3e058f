"""Wrapper of the fused transform/quant/recon kernel (csrc/code_plane.cu).

A CPU tensor takes the plain version in `ops/transform.py`; a CUDA tensor
launches the kernel, which is built at first use. `code_plane_g` codes
the planes of G GOPs, [G, H, W], in one launch. Both forms share one
private launcher: `lead` is () for a single plane and (G,) for a batch.
"""

from __future__ import annotations

import torch

from .. import transform
from . import build


def _code_plane(cur, pred, q_blk, qbias: int, qmat: bool, name: str,
                batched: bool):
    """Entry tvc_<name>, counted under "code_plane[_qmat][_g]"."""
    *lead, h, w = cur.shape
    if len(lead) != int(batched):
        raise ValueError(f"{name}: expected {2 + int(batched)} dimensions, "
                         f"got shape {tuple(cur.shape)}")
    if h % 8 or w % 8:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of 8")
    if not 1 <= qbias <= 8:
        raise ValueError(f"{name}: qbias {qbias} outside [1, 8]")
    build.require(cur, torch.int32, (*lead, h, w), f"{name} cur")
    build.require(pred, torch.int32, (*lead, h, w), f"{name} pred")
    build.require(q_blk, torch.int32, (*lead, h // 8, w // 8), f"{name} q_blk")
    levels = torch.empty((*lead, h // 8, w // 8, 64), dtype=torch.int32,
                         device=cur.device)
    rec = torch.empty_like(cur)
    err = getattr(build.lib(), "tvc_" + name)(
        cur.data_ptr(), pred.data_ptr(), q_blk.data_ptr(), *lead, h, w, qbias,
        int(qmat), levels.data_ptr(), rec.data_ptr(),
        build.stream_ptr(cur.device))
    build.check(err, name)
    build.LAUNCHES[("code_plane_qmat" if qmat else "code_plane")
                   + ("_g" if batched else "")] += 1
    return levels, rec


def code_plane(cur: torch.Tensor, pred: torch.Tensor, q_blk: torch.Tensor,
               qbias: int = 8, qmat: bool = False):
    """Residual -> ITX8 -> quantize -> zigzag and clipped recon of one plane.

    cur, pred: [H, W] int32 (H, W multiples of 8); q_blk: [H/8, W/8] int32
    steps, scaled per position by the v3 quant matrix when qmat (counted
    as "code_plane_qmat"). Returns (levels [H/8, W/8, 64] int32 zigzag order, recon [H, W]
    int32)."""
    if cur.device.type == "cpu":
        return transform.code_plane(cur, pred, q_blk, qbias, qmat)
    return _code_plane(cur, pred, q_blk, qbias, qmat, "code_plane", False)


def code_plane_g(cur: torch.Tensor, pred: torch.Tensor, q_blk: torch.Tensor,
                 qbias: int = 8, qmat: bool = False):
    """code_plane of the planes of G GOPs in one launch: cur, pred
    [G, H, W] int32 (whole planes, or the [G, 8, W] stripes of the I-frame
    row scan), q_blk [G, H/8, W/8] int32, each GOP at its own steps
    (counted as "code_plane_g", or "code_plane_qmat_g" with qmat). Returns
    (levels [G, H/8, W/8, 64] int32 zigzag order, recon [G, H, W] int32)."""
    if cur.device.type == "cpu":
        return transform.code_plane(cur, pred, q_blk, qbias, qmat)
    return _code_plane(cur, pred, q_blk, qbias, qmat, "code_plane_g", True)
