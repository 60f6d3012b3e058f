"""The input pool of a cell, made on the device from the seed.

One general generator for every traffic mix (`traffic/<mix>.json`): each
GOP of the pool is a panning texture with a moving random patch and mild
noise over flat chroma, the recipe of `chip_smoke.py`'s `texture` and
`synth_clip` rewritten in torch so that it is made on the card. The mix
file gives the recipe's parameters; the pool holds `pool_batches` batches
of `gop_batch` distinct GOPs, so that no batch reuses the planes of the
batch before it. Planes are edge-padded to the macroblock grid as
`Frame.from_planes` pads them (luma to 16, chroma to 8).
"""

from __future__ import annotations

import torch

def gop_seed(seed: int, index: int) -> int:
    """The generator seed of pool GOP `index` under the run's seed."""
    return (seed * 1_000_003 + 7_919 * index + 1) % (1 << 63)


def texture(gen, h: int, w: int, passes: int, stretch: bool, device):
    """Smoothed random texture [h, w] int32 in [0, 255]: `passes` rounds
    of the five-tap mean (the sample, its neighbours one and two rows
    above and columns left, wrapping), stretched back to 0-255 if asked."""
    base = torch.randint(0, 256, (h, w), generator=gen, device=device,
                         dtype=torch.int32)
    for _ in range(passes):
        base = (base + base.roll(1, 0) + base.roll(1, 1) + base.roll(2, 0)
                + base.roll(2, 1)) // 5
    if stretch:
        lo, hi = int(base.min()), int(base.max())
        base = (base - lo) * 255 // max(hi - lo, 1)
    return base


def make_gop(mix: dict, seed: int, index: int, t_len: int, h: int, w: int,
             device):
    """One GOP of the mix: (y [T, H, W], cb, cr [T, H/2, W/2]) uint8 of the
    unpadded size."""
    gen = torch.Generator(device=device)
    gen.manual_seed(gop_seed(seed, index))
    (py, px), (oy, ox), (sy, sx) = mix["pan"], mix["patch_origin"], mix["patch_step"]
    margin = 2 * max(abs(py), abs(px)) * t_len + 2
    base = texture(gen, h + margin, w + margin, mix["passes"], mix["stretch"],
                   device)
    n, p = mix["noise"], min(mix["patch"], h, w)
    ys = torch.empty((t_len, h, w), dtype=torch.uint8, device=device)
    for k in range(t_len):
        y = base[py * k: py * k + h, px * k: px * k + w] + torch.randint(
            -n, n + 1, (h, w), generator=gen, device=device, dtype=torch.int32)
        ry, rx = (oy + sy * k) % max(h - p, 1), (ox + sx * k) % max(w - p, 1)
        y[ry: ry + p, rx: rx + p] = torch.randint(
            0, 256, (p, p), generator=gen, device=device, dtype=torch.int32)
        ys[k] = y.clamp(0, 255)
    ks = torch.arange(t_len, device=device, dtype=torch.int32).view(-1, 1, 1)
    cb = (mix["cb"] + mix["cb_step"] * ks).expand(t_len, h // 2, w // 2)
    cr = torch.full((t_len, h // 2, w // 2), mix["cr"], dtype=torch.int32,
                    device=device)
    return ys, cb.clamp(0, 255).to(torch.uint8), cr.to(torch.uint8)


def pad_to(planes: torch.Tensor, mult: int) -> torch.Tensor:
    """[..., H, W] edge-replicated at the bottom and right to multiples of
    `mult`."""
    h, w = planes.shape[-2:]
    rows = torch.arange(-(-h // mult) * mult, device=planes.device).clamp(max=h - 1)
    cols = torch.arange(-(-w // mult) * mult, device=planes.device).clamp(max=w - 1)
    return planes[..., rows, :][..., cols]


def make_pool(mix: dict, enc: dict, seed: int, device):
    """The cell's inputs: padded uint8 planes (y, cb, cr), each
    [pool_batches, T, H, W] for one GOP at a time, or [pool_batches, T, G,
    H, W] for G GOPs in lockstep, the frame axis before the GOP axis as
    `GopEngine.run_batch` takes them. GOP g of batch b is pool GOP b G + g."""
    g_n, n_b = mix["gop_batch"], mix["pool_batches"]
    t_len, h, w = enc["gop_n"], enc["height"], enc["width"]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    shape = (n_b, t_len, g_n) if g_n > 1 else (n_b, t_len)
    y = torch.empty((*shape, hp, wp), dtype=torch.uint8, device=device)
    cb = torch.empty((*shape, hp // 2, wp // 2), dtype=torch.uint8,
                     device=device)
    cr = torch.empty_like(cb)
    for b in range(n_b):
        for g in range(g_n):
            planes = make_gop(mix, seed, b * g_n + g, t_len, h, w, device)
            for dst, src, mult in zip((y, cb, cr), planes, (16, 8, 8)):
                if g_n > 1:
                    dst[b, :, g] = pad_to(src, mult)
                else:
                    dst[b] = pad_to(src, mult)
    return y, cb, cr


def pool_gop(pool, batch: int, g: int):
    """Pool GOP g of batch `batch` as [T, H, W] planes."""
    return tuple(p[batch, :, g] if p.dim() == 5 else p[batch] for p in pool)
