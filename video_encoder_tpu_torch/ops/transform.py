"""Integer transform and quantization in plain PyTorch (SPEC.md §3-4).

Twin of `video_encoder_tpu/ops/transform.py`, int32 throughout and
bit-exact with `codec/spec.py`. The 8x8 products are broadcast
multiply-sums in int32, never float matmuls: CUDA has no integer GEMM and
a float path would have to be proven exact (TF32 is on by default for
cuDNN). These functions are the plain version the `code_plane` kernel is
held against.
"""

from __future__ import annotations

import torch

from ..codec import tables


def qstep(qp: torch.Tensor) -> torch.Tensor:
    """QSTEP table lookup (int32)."""
    return tables.load(qp.device).QSTEP[qp.long()]


def rshift_round(v: torch.Tensor, s: int) -> torch.Tensor:
    """sign(v) * ((|v| + 2^(s-1)) >> s): round half away from zero."""
    mag = (v.abs() + (1 << (s - 1))) >> s
    return torch.where(v < 0, -mag, mag)


def _left(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m @ x over the last two axes of x [..., 8, 8], in int32."""
    return (m[:, :, None] * x[..., None, :, :]).sum(-2, dtype=torch.int32)


def forward_transform(x: torch.Tensor) -> torch.Tensor:
    """ITX8 forward transform of int32 blocks [..., 8, 8]: B x B^T."""
    b = tables.load(x.device).B
    t1r = rshift_round(_left(b, x), tables.TX_SHIFT)
    t2 = _left(b, t1r.transpose(-1, -2)).transpose(-1, -2)   # t1r @ B^T
    return rshift_round(t2, tables.TX_SHIFT)


def inverse_transform(c: torch.Tensor) -> torch.Tensor:
    """ITX8 inverse transform of int32 coefficient blocks: B^T c B."""
    b = tables.load(c.device).B
    u1r = rshift_round(_left(b.t(), c), tables.TX_SHIFT)
    u2 = _left(b.t(), u1r.transpose(-1, -2)).transpose(-1, -2)  # u1r @ B
    return rshift_round(u2, tables.TX_SHIFT)


def quantize(c: torch.Tensor, q: torch.Tensor, bias16_ac: int = 8) -> torch.Tensor:
    """level = sign(C) * ((16|C| + bias*q) // (16q)) on [..., 8, 8] blocks;
    bias 8 (midpoint) at DC, bias16_ac at the ACs. 16|C| <= 65520 and
    16q <= 23168, so int32 is safe."""
    if bias16_ac == 8:
        mag = (2 * c.abs() + q) // (2 * q)
    else:
        bias = torch.full((8, 8), int(bias16_ac), dtype=torch.int32,
                          device=c.device)
        bias[0, 0] = 8
        mag = (16 * c.abs() + bias * q) // (16 * q)
    return torch.where(c < 0, -mag, mag)


def dequantize(level: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return level * q


def blockify(plane: torch.Tensor, n: int) -> torch.Tensor:
    """[..., H, W] -> [..., H/n, W/n, n, n]."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // n, n, w // n, n).transpose(-3, -2)


def unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """[..., by, bx, n, n] -> [..., by*n, bx*n]."""
    *lead, by, bx, n, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, by * n, bx * n)


def zigzag(levels_8x8: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] -> [..., 64] in zigzag scan order."""
    flat = levels_8x8.reshape(*levels_8x8.shape[:-2], 64)
    return flat[..., tables.load(flat.device).ZIGZAG.long()]


def unzigzag(levels_zz: torch.Tensor) -> torch.Tensor:
    """[..., 64] zigzag order -> [..., 8, 8] raster blocks."""
    flat = levels_zz[..., tables.load(levels_zz.device).UNZIGZAG.long()]
    return flat.reshape(*levels_zz.shape[:-1], 8, 8)


def qsteps_pos(q: torch.Tensor, use_matrix: bool) -> torch.Tensor:
    """Per-position steps [..., 8, 8] from per-block steps [...] under the
    v3 quant matrix, max(1, (q * QMAT + 8) >> 4) (SPEC.md §13.2), or the
    flat [..., 1, 1] broadcast when the matrix is off."""
    if not use_matrix:
        return q[..., None, None]
    qmat = tables.load(q.device).QMAT
    return ((q[..., None, None] * qmat + 8) >> 4).clamp(min=1)


def code_plane(cur: torch.Tensor, pred: torch.Tensor, q_blk: torch.Tensor,
               qbias: int = 8, qmat: bool = False):
    """Residual -> ITX8 -> quantize -> zigzag, and the clipped recon, of one
    plane. cur, pred [H, W] int32; q_blk [H/8, W/8] int32 steps, scaled
    per position by the v3 quant matrix when qmat. Returns (levels [H/8,
    W/8, 64] zigzag order, recon [H, W]) as the reference's
    `dispatch.code_plane` does. With a leading G axis on all three
    (planes of G GOPs) each g is coded on its own: the plain version of
    the `code_plane_g` kernel."""
    q = qsteps_pos(q_blk, qmat)
    coefs = forward_transform(blockify(cur - pred, 8))
    lz = zigzag(quantize(coefs, q, qbias))
    deq = dequantize(unzigzag(lz), q)
    rec = (unblockify(inverse_transform(deq)) + pred).clamp(0, 255)
    return lz, rec


def intra_rows_code_plane(cur: torch.Tensor, q_blk: torch.Tensor, qbias: int,
                          reset_rows: int = 0, qmat: bool = False):
    """v3 I-frame vertical intra coding of one plane (SPEC.md §13.1), twin
    of the reference's `transform.intra_rows_code_plane`: block row j
    predicts every pixel from the reconstructed pixel row above it (128
    above row 0 and, with reset_rows > 0, above every reset_rows-th block
    row, §13.3). Each stripe is code_plane on an [8, W] plane whose pred
    is that row broadcast to eight rows: the plain version of the
    `code_plane_rows` kernel. cur [H, W] int32, q_blk [H/8, W/8] int32.
    Returns (levels [H/8, W/8, 64] zigzag order, recon [H, W]). With a
    leading axis the planes advance in lockstep, one [B, 8, W] stripe per
    step, each plane's pred its own previous recon row."""
    *lead, h, w = cur.shape
    flat = torch.full((*lead, 8, w), 128, dtype=cur.dtype, device=cur.device)
    # stripe axis leading, so that each step's [..., 8, W] stripe and its
    # [..., 1, W/8] steps are contiguous (no copy without a leading axis)
    stripes = cur.reshape(*lead, h // 8, 8, w).movedim(-3, 0).contiguous()
    steps = q_blk.unsqueeze(-2).movedim(-3, 0).contiguous()
    levels, recs = [], []
    pred = flat
    for j in range(h // 8):
        if j == 0 or (reset_rows and j % reset_rows == 0):
            pred = flat
        lv, rec = code_plane(stripes[j], pred, steps[j], qbias, qmat)
        pred = rec[..., -1:, :].expand(*lead, 8, w)
        levels.append(lv)
        recs.append(rec)
    return torch.cat(levels, -3), torch.cat(recs, -2)


def recon_plane(levels_zz: torch.Tensor, pred, q_blk: torch.Tensor,
                qmat: bool = False) -> torch.Tensor:
    """The decoders' inter recon of one plane, twin of `recon_plane` in
    the reference's `_decode_gop_jit` (pipeline/decoder.py): unzigzag,
    dequantize at qsteps_pos(q_blk, qmat), inverse ITX8, unblockify, add
    pred, clip to 0-255. levels_zz [(B,) H/8, W/8, 64] in zigzag order,
    int16 (the parser's layout) or int32; pred [(B,) H, W] int32, or None
    for the flat 128 of an I frame at formats 1-2; q_blk [(B,) H/8, W/8]
    int32 steps. All arithmetic is int32 and wraps as the reference's
    does on levels no encoder writes. Returns the recon [(B,) H, W] int32:
    the plain version of the `recon_plane` kernel."""
    q = qsteps_pos(q_blk, qmat)
    deq = dequantize(unzigzag(levels_zz.to(torch.int32)), q)
    res = unblockify(inverse_transform(deq))
    return (res + (128 if pred is None else pred)).clamp(0, 255)


def intra_rows_recon_plane(levels_zz: torch.Tensor, q_blk: torch.Tensor,
                           reset_rows: int = 0,
                           qmat: bool = False) -> torch.Tensor:
    """Format-3/4 I-frame recon of one plane (SPEC.md §13.1, decoder
    side), twin of the reference's `transform.intra_rows_recon_plane`:
    block row j predicts every pixel from the recon's last pixel row
    above it, 128 at row 0 and, with reset_rows > 0, at every reset_rows-th
    block row (§13.3). Each [(B,) 8, W] stripe is recon_plane against that
    row broadcast to eight rows: the plain version of the
    `recon_plane_rows` kernel. levels_zz [(B,) H/8, W/8, 64] (int16 or
    int32), q_blk [(B,) H/8, W/8] int32. Returns the recon [(B,) H, W]
    int32; with a leading axis the planes advance in lockstep."""
    *lead, nby, nbx, _ = levels_zz.shape
    w = nbx * 8
    flat = torch.full((*lead, 8, w), 128, dtype=torch.int32,
                      device=levels_zz.device)
    stripes = levels_zz.movedim(-3, 0)          # [nby, (B,) nbx, 64]
    steps = q_blk.movedim(-2, 0)                # [nby, (B,) nbx]
    recs = []
    pred = flat
    for j in range(nby):
        if j == 0 or (reset_rows and j % reset_rows == 0):
            pred = flat
        rec = recon_plane(stripes[j].unsqueeze(-3), pred,
                          steps[j].unsqueeze(-2), qmat)
        pred = rec[..., -1:, :].expand(*lead, 8, w)
        recs.append(rec)
    return torch.cat(recs, -2)
