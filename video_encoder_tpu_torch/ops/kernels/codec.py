"""Wrappers of the fused transform/quant/recon kernel (csrc/code_plane.cu).

A CPU tensor takes the plain version in `ops/transform.py`; a CUDA tensor
launches the kernel, which is built at first use. `code_plane_g` codes
the planes of G GOPs, [G, H, W], in one launch; both share one private
launcher: `lead` is () for a single plane and (G,) for a batch.
`code_plane_rows` is the format-3/4 I-frame row scan of a whole plane, or
of B planes [B, H, W], in one launch. `recon_plane` and `recon_plane_rows`
are the decoders' recon-only twins: the inter recon of a plane, and the
format-3/4 I-frame recon. Both may also write the recon as bytes into a
uint8 plane, the decoded output, so that no cast follows them.
"""

from __future__ import annotations

import torch

from .. import transform
from . import build


def _check(cur, q_blk, qbias: int, name: str, batched: bool):
    """(lead, h, w) of cur [(B,) H, W] and q_blk [(B,) H/8, W/8]; raises on
    what the kernels do not take."""
    *lead, h, w = cur.shape
    if len(lead) != int(batched):
        raise ValueError(f"{name}: expected {2 + int(batched)} dimensions, "
                         f"got shape {tuple(cur.shape)}")
    if h % 8 or w % 8 or not h or not w:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of 8")
    if not 1 <= qbias <= 8:
        raise ValueError(f"{name}: qbias {qbias} outside [1, 8]")
    build.require(cur, torch.int32, (*lead, h, w), f"{name} cur")
    build.require_aligned(cur, f"{name} cur")
    build.require(q_blk, torch.int32, (*lead, h // 8, w // 8), f"{name} q_blk")
    return lead, h, w


def _code_plane(cur, pred, q_blk, qbias: int, qmat: bool, name: str,
                batched: bool):
    """Entry tvc_<name>, counted under "code_plane[_qmat][_g]"."""
    lead, h, w = _check(cur, q_blk, qbias, name, batched)
    build.require(pred, torch.int32, (*lead, h, w), f"{name} pred")
    build.require_aligned(pred, f"{name} pred")
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
    [G, H, W] int32, q_blk [G, H/8, W/8] int32, each GOP at its own steps
    (counted as "code_plane_g", or "code_plane_qmat_g" with qmat). Returns
    (levels [G, H/8, W/8, 64] int32 zigzag order, recon [G, H, W] int32)."""
    if cur.device.type == "cpu":
        return transform.code_plane(cur, pred, q_blk, qbias, qmat)
    return _code_plane(cur, pred, q_blk, qbias, qmat, "code_plane_g", True)


def code_plane_rows(cur: torch.Tensor, q_blk: torch.Tensor, qbias: int = 8,
                    reset_rows: int = 0, qmat: bool = False):
    """The v3 I-frame vertical-intra row scan (SPEC.md §13.1) of a whole
    plane [H, W], or of B planes [B, H, W] (G GOPs in lockstep, or the
    G x S shards of the tile path), in one launch: block row j predicts
    from the recon's last pixel row above it, 128 at row 0 and every
    reset_rows-th row. q_blk [(B,) H/8, W/8] int32. Counted as
    "code_plane_rows", or "code_plane_rows_g" with the B axis. Returns
    (levels [(B,) H/8, W/8, 64] int32 zigzag order, recon [(B,) H, W])."""
    if cur.device.type == "cpu":
        return transform.intra_rows_code_plane(cur, q_blk, qbias, reset_rows,
                                               qmat)
    batched = cur.ndim == 3
    lead, h, w = _check(cur, q_blk, qbias, "code_plane_rows", batched)
    if reset_rows < 0:
        raise ValueError(f"code_plane_rows: reset_rows {reset_rows} < 0")
    levels = torch.empty((*lead, h // 8, w // 8, 64), dtype=torch.int32,
                         device=cur.device)
    rec = torch.empty_like(cur)
    err = build.lib().tvc_code_plane_rows(
        cur.data_ptr(), q_blk.data_ptr(), *(lead or [1]), h, w, qbias,
        int(qmat), reset_rows, levels.data_ptr(), rec.data_ptr(),
        build.stream_ptr(cur.device))
    build.check(err, "code_plane_rows")
    build.LAUNCHES["code_plane_rows_g" if batched else "code_plane_rows"] += 1
    return levels, rec


def to_out8(rec: torch.Tensor, out8):
    """The plain versions' byte output: rec copied into out8 unless None;
    returns rec."""
    if out8 is not None:
        out8.copy_(rec)
    return rec


def _check_levels(levels_zz, q_blk, name: str, batched: bool):
    """(lead, h, w) of levels [(B,) H/8, W/8, 64] int16 and q_blk [(B,)
    H/8, W/8] int32; raises on what the recon kernels do not take."""
    *lead, nby, nbx, n = levels_zz.shape
    if len(lead) != int(batched) or n != 64 or not nby or not nbx:
        raise ValueError(f"{name}: expected levels [{'B, ' if batched else ''}"
                         f"H/8, W/8, 64], got {tuple(levels_zz.shape)}")
    build.require(levels_zz, torch.int16, (*lead, nby, nbx, 64),
                  f"{name} levels")
    build.require_aligned(levels_zz, f"{name} levels")
    build.require(q_blk, torch.int32, (*lead, nby, nbx), f"{name} q_blk")
    return lead, 8 * nby, 8 * nbx


def _out8_ptr(out8, shape, name: str):
    if out8 is None:
        return None
    build.require(out8, torch.uint8, shape, f"{name} out8")
    build.require_aligned(out8, f"{name} out8")
    return out8.data_ptr()


def recon_plane(levels_zz: torch.Tensor, pred, q_blk: torch.Tensor,
                qmat: bool = False, out8=None) -> torch.Tensor:
    """The decoders' inter recon of one plane: levels_zz [H/8, W/8, 64]
    int16 in zigzag order, pred [H, W] int32 or None for a flat 128,
    q_blk [H/8, W/8] int32 steps (scaled by the v3 quant matrix when
    qmat). Returns the recon clip(inverse(deq) + pred) [H, W] int32 and,
    with out8 a uint8 [H, W] tensor, writes the same values there.
    Counted as "recon_plane"."""
    if levels_zz.device.type == "cpu":
        return to_out8(transform.recon_plane(levels_zz, pred, q_blk, qmat),
                       out8)
    _, h, w = _check_levels(levels_zz, q_blk, "recon_plane", False)
    if pred is not None:
        build.require(pred, torch.int32, (h, w), "recon_plane pred")
        build.require_aligned(pred, "recon_plane pred")
    rec = torch.empty((h, w), dtype=torch.int32, device=levels_zz.device)
    err = build.lib().tvc_recon_plane(
        levels_zz.data_ptr(), None if pred is None else pred.data_ptr(),
        q_blk.data_ptr(), h, w, int(qmat), rec.data_ptr(),
        _out8_ptr(out8, (h, w), "recon_plane"),
        build.stream_ptr(levels_zz.device))
    build.check(err, "recon_plane")
    build.LAUNCHES["recon_plane"] += 1
    return rec


def recon_plane_rows(levels_zz: torch.Tensor, q_blk: torch.Tensor,
                     reset_rows: int = 0, qmat: bool = False,
                     out8=None) -> torch.Tensor:
    """The format-3/4 I-frame recon (SPEC.md §13.1) of a whole plane, or of
    B planes, in one launch: levels_zz [(B,) H/8, W/8, 64] int16 in
    zigzag order, q_blk [(B,) H/8, W/8] int32; block row j predicts from
    the recon's last pixel row above it, 128 at row 0 and every
    reset_rows-th row. Returns the recon [(B,) H, W] int32 and, with out8
    a uint8 tensor of that shape, writes the same values there. Counted
    as "recon_plane_rows"."""
    if levels_zz.device.type == "cpu":
        return to_out8(transform.intra_rows_recon_plane(
            levels_zz, q_blk, reset_rows, qmat), out8)
    batched = levels_zz.ndim == 4
    lead, h, w = _check_levels(levels_zz, q_blk, "recon_plane_rows", batched)
    if reset_rows < 0:
        raise ValueError(f"recon_plane_rows: reset_rows {reset_rows} < 0")
    rec = torch.empty((*lead, h, w), dtype=torch.int32,
                      device=levels_zz.device)
    err = build.lib().tvc_recon_plane_rows(
        levels_zz.data_ptr(), q_blk.data_ptr(), *(lead or [1]), h, w,
        int(qmat), reset_rows, rec.data_ptr(),
        _out8_ptr(out8, (*lead, h, w), "recon_plane_rows"),
        build.stream_ptr(levels_zz.device))
    build.check(err, "recon_plane_rows")
    build.LAUNCHES["recon_plane_rows"] += 1
    return rec
