"""Wrapper of the fused transform/quant/recon kernel (csrc/code_plane.cu).

A CPU tensor takes the plain version in `ops/transform.py`; a CUDA tensor
launches the kernel, which is built at first use.
"""

from __future__ import annotations

import torch

from .. import transform
from . import build


def code_plane(cur: torch.Tensor, pred: torch.Tensor, q_blk: torch.Tensor,
               qbias: int = 8, qmat: bool = False):
    """Residual -> ITX8 -> quantize -> zigzag and clipped recon of one plane.

    cur, pred: [H, W] int32 (H, W multiples of 8); q_blk: [H/8, W/8] int32
    steps, scaled per position by the v3 quant matrix when qmat (counted
    as "code_plane_qmat"). Returns (levels [H/8, W/8, 64] int32 zigzag order, recon [H, W]
    int32)."""
    if cur.device.type == "cpu":
        return transform.code_plane(cur, pred, q_blk, qbias, qmat)
    h, w = cur.shape
    if h % 8 or w % 8:
        raise ValueError(f"code_plane: {h}x{w} is not a multiple of 8")
    if not 1 <= qbias <= 8:
        raise ValueError(f"code_plane: qbias {qbias} outside [1, 8]")
    build.require(cur, torch.int32, (h, w), "code_plane cur")
    build.require(pred, torch.int32, (h, w), "code_plane pred")
    build.require(q_blk, torch.int32, (h // 8, w // 8), "code_plane q_blk")
    levels = torch.empty((h // 8, w // 8, 64), dtype=torch.int32,
                         device=cur.device)
    rec = torch.empty_like(cur)
    err = build.lib().tvc_code_plane(
        cur.data_ptr(), pred.data_ptr(), q_blk.data_ptr(), h, w, qbias,
        int(qmat), levels.data_ptr(), rec.data_ptr(), build.stream_ptr(cur.device))
    build.check(err, "code_plane")
    build.LAUNCHES["code_plane_qmat" if qmat else "code_plane"] += 1
    return levels, rec
