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
    """[H, W] -> [H/n, W/n, n, n]."""
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3)


def unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """[by, bx, n, n] -> [by*n, bx*n]."""
    by, bx, n, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(by * n, bx * n)


def zigzag(levels_8x8: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] -> [..., 64] in zigzag scan order."""
    flat = levels_8x8.reshape(*levels_8x8.shape[:-2], 64)
    return flat[..., tables.load(flat.device).ZIGZAG.long()]


def unzigzag(levels_zz: torch.Tensor) -> torch.Tensor:
    """[..., 64] zigzag order -> [..., 8, 8] raster blocks."""
    flat = levels_zz[..., tables.load(levels_zz.device).UNZIGZAG.long()]
    return flat.reshape(*levels_zz.shape[:-1], 8, 8)


def code_plane(cur: torch.Tensor, pred: torch.Tensor, q_blk: torch.Tensor,
               qbias: int = 8):
    """Residual -> ITX8 -> quantize -> zigzag, and the clipped recon, of one
    plane. cur, pred [H, W] int32; q_blk [H/8, W/8] int32 steps. Returns
    (levels [H/8, W/8, 64] zigzag order, recon [H, W]) as the reference's
    `dispatch.code_plane` does."""
    q = q_blk[..., None, None]
    coefs = forward_transform(blockify(cur - pred, 8))
    lz = zigzag(quantize(coefs, q, qbias))
    deq = dequantize(unzigzag(lz), q)
    rec = (unblockify(inverse_transform(deq)) + pred).clamp(0, 255)
    return lz, rec
