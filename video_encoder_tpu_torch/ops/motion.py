"""Motion estimation and compensation in plain PyTorch (SPEC.md §9).

Twin of `video_encoder_tpu/ops/motion.py` for the full and diamond
searches. These are the plain versions the `full_search`, `sad_map_even`,
`sad_at_mv` and `mc_fetch` kernels are held against, and the CPU path of
the port.
"""

from __future__ import annotations

import torch

from ..codec import spec, tables
from ..codec.entropy import bitlen
from .transform import unblockify

R = tables.SEARCH_R
ND = 2 * R + 1  # 33 offsets per axis, 1089 candidates
NE = R + 1      # 17 even offsets per axis, 289 even-lattice candidates
BIG = 1 << 30   # cost of a candidate outside the ±R window


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


def sad_map_even(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """SADs of every even-even mv, [nby, nbx, 289] int32: candidate
    kE = ((dy+R)/2)*17 + (dx+R)/2, the values full_search sees there (same
    edge padding). One even dy row of 17 candidates per step."""
    h, w = cur_y.shape
    refpad = pad_ref(ref_y, R)
    rows_of_sads = []
    for ky in range(NE):
        rows = refpad[2 * ky:2 * ky + h]
        shifted = torch.stack([rows[:, 2 * kx:2 * kx + w] for kx in range(NE)])
        rows_of_sads.append(_mb_sums((cur_y - shifted).abs(), tables.MB))
    return torch.cat(rows_of_sads).permute(1, 2, 0).contiguous()


def sad_at(cur_y: torch.Tensor, ref_y: torch.Tensor, dy: torch.Tensor,
           dx: torch.Tensor, bs: int = tables.MB, plane_of=None) -> torch.Tensor:
    """Per-block bs x bs SAD at integer mvs dy, dx [..., nby, nbx]
    (|mv| <= bs, the pad radius: 16 for luma MBs, 8 for chroma blocks; any
    number of leading candidate axes). With plane_of (K Python ints) ref_y
    is a stack of planes [P, H, W] and candidate k of dy, dx [K, nby, nbx]
    reads ref_y[plane_of[k]]. Returns int32 of dy's shape."""
    if plane_of is not None:
        return torch.stack([sad_at(cur_y, ref_y[p], dy[k], dx[k], bs)
                            for k, p in enumerate(plane_of)])
    h, w = cur_y.shape
    cur_b = cur_y.reshape(h // bs, bs, w // bs, bs).permute(0, 2, 1, 3)
    pred = mc_fetch(pad_ref(ref_y, bs), dy, dx, bs, bs)
    return (cur_b - pred).abs().sum(dim=(-2, -1), dtype=torch.int32)


def diamond_search_with(cur_y: torch.Tensor, sad_fn, sad_fn_small):
    """Masked diamond search (SPEC.md §9) over per-MB SAD evaluators that
    take mvs [..., nby, nbx]: sad_fn for the even-lattice large-diamond
    loop, sad_fn_small for the final ±1 step. Returns (dy, dx, sad) int32.

    The loop runs the fixed budget of DIAMOND_MAX_STEPS steps and never
    reads a device value on the host. The reference's while-loop stops
    once every MB is frozen, and a step where every MB is frozen is the
    identity, so the two agree bit for bit. Candidates are ranked by the
    packed int64 key cost * 8 + index (invalid ones cost BIG), whose
    minimum is the first minimum in the order current, up, left, right,
    down."""
    nby, nbx = cur_y.shape[0] // tables.MB, cur_y.shape[1] // tables.MB
    dev = cur_y.device
    dy = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    dx = torch.zeros_like(dy)
    cost = sad_fn(dy, dx)
    frozen = cost < spec.DIAMOND_EARLY_SAD

    # unit steps up, left, right, down, made on the device: a host tensor
    # copied there would make the host wait for the stream
    k = torch.arange(4, device=dev)[:, None, None]
    unit = ((k == 3).int() - (k == 0).int(), (k == 2).int() - (k == 1).int())
    large = (2 * unit[0], 2 * unit[1])
    idx = torch.arange(5, device=dev)[:, None, None]

    def evaluate(dy, dx, cost, frozen, offs, fn):
        ndy, ndx = dy + offs[0], dx + offs[1]                  # [4, nby, nbx]
        valid = (ndy.abs() <= R) & (ndx.abs() <= R)
        cs = torch.where(valid, fn(ndy.clamp(-R, R), ndx.clamp(-R, R)), BIG)
        cc = torch.cat([cost[None], cs]).long()                # [5, nby, nbx]
        widx = (cc * 8 + idx).amin(0) & 7
        cand_dy = torch.cat([dy[None], ndy])
        cand_dx = torch.cat([dx[None], ndx])
        pick = widx[None]
        wdy = cand_dy.gather(0, pick)[0]
        wdx = cand_dx.gather(0, pick)[0]
        wcost = cc.gather(0, pick)[0].int()
        return (torch.where(frozen, dy, wdy), torch.where(frozen, dx, wdx),
                torch.where(frozen, cost, wcost), (widx != 0) & ~frozen)

    for _ in range(spec.DIAMOND_MAX_STEPS):
        dy, dx, cost, moved = evaluate(dy, dx, cost, frozen, large, sad_fn)
        frozen = frozen | ~moved | (cost < spec.DIAMOND_EARLY_SAD)
    dy, dx, cost, _ = evaluate(dy, dx, cost, torch.zeros_like(frozen), unit,
                               sad_fn_small)
    return dy, dx, cost


def diamond_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Diamond search with every SAD from sad_at: the plain route."""
    def fn(dy, dx):
        return sad_at(cur_y, ref_y, dy, dx)
    return diamond_search_with(cur_y, fn, fn)


def mc_fetch(refpad: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
             bs: int, r: int) -> torch.Tensor:
    """Per-block predictor gather [..., nby, nbx, bs, bs] from refpad
    (padded by r) at the per-block integer mvs [..., nby, nbx]."""
    nby, nbx = dy.shape[-2:]
    dev = refpad.device
    my = torch.arange(nby, device=dev)[:, None, None, None] * bs
    mx = torch.arange(nbx, device=dev)[None, :, None, None] * bs
    ii = torch.arange(bs, device=dev)[None, None, :, None]
    jj = torch.arange(bs, device=dev)[None, None, None, :]
    rows = r + my + dy.long()[..., None, None] + ii
    cols = r + mx + dx.long()[..., None, None] + jj
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


def adaptive_qp(base_qp: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """rc=adaptive per-MB qp (SPEC.md §10): base_qp + bitlen(act) - 10,
    clipped to the qp range, from the per-MB intra cost [nby, nbx]."""
    return (base_qp + (bitlen(act) - 10)).clamp(
        tables.QP_MIN, tables.QP_MAX).int()


def hpel_planes(p: torch.Tensor):
    """SPEC.md §14.2 parity planes (H, V, D) on the plane grid, the +1
    reads clamped at the edge."""
    b = torch.cat([p[:, 1:], p[:, -1:]], 1)   # p[y, x+1]
    c = torch.cat([p[1:], p[-1:]], 0)         # p[y+1, x]
    d = torch.cat([b[1:], b[-1:]], 0)         # p[y+1, x+1]
    return (p + b + 1) >> 1, (p + c + 1) >> 1, (p + b + c + d + 2) >> 2


def hpel_stack(p: torch.Tensor) -> torch.Tensor:
    """[4, H, W]: the plane and its H, V, D parity planes, indexed by
    (d2y & 1) * 2 + (d2x & 1)."""
    return torch.stack([p, *hpel_planes(p)])
