"""Motion estimation and compensation in plain PyTorch (SPEC.md §9).

Twin of `video_encoder_tpu/ops/motion.py` for the full, diamond and
hierarchical searches and motion compensation. These are the plain
versions the `full_search` (exhaustive and SEA), `sad_map`,
`sad_map_even`, `sad_at_mv`, `diamond_descent`, `mc_fetch` and
`mc_predict` kernels are held against, and the CPU path of the port.

Every function takes planes [H, W] or, for G GOPs encoded in lockstep,
[G, H, W], and gives for each g exactly what it gives for that plane
alone: the plain versions of the G-batched kernels. A candidate axis K,
where there is one, stands just before the MB grid: [..., K, nby, nbx].
"""

from __future__ import annotations

import torch

from ..codec import spec, tables
from ..codec.entropy import bitlen
from .transform import blockify, unblockify

R = tables.SEARCH_R
ND = 2 * R + 1  # 33 offsets per axis, 1089 candidates
NE = R + 1      # 17 even offsets per axis, 289 even-lattice candidates
BIG = 1 << 30   # cost of a candidate outside the ±R window


def pad_ref(plane: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate pad a [..., H, W] plane by r on all sides (SPEC.md §2)."""
    h, w = plane.shape[-2:]
    dev = plane.device
    rows = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    return plane[..., rows, :][..., cols]


def _mb_sums(x: torch.Tensor, n: int) -> torch.Tensor:
    """Per-n x n-block sums of a [..., H, W] array -> [..., H/n, W/n] int32."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // n, n, w // n, n).sum(dim=(-3, -1),
                                                      dtype=torch.int32)


def pad_cols(ref_ext: torch.Tensor, cur_w: int, r: int) -> torch.Tensor:
    """A pre-haloed reference [..., h + 2r, w or w + 2r] as the fully
    padded plane [..., h + 2r, w + 2r] of a [.., h, cur_w] shard: where the
    column halo is absent (row sharding) the columns edge-replicate, as
    pad_ref's do."""
    w = ref_ext.shape[-1]
    if w == cur_w + 2 * r:
        return ref_ext
    if w != cur_w:
        raise ValueError(f"pre-haloed reference of width {w} for a plane of "
                         f"width {cur_w} and radius {r}")
    cols = torch.arange(-r, w + r, device=ref_ext.device).clamp(0, w - 1)
    return ref_ext[..., cols]


def full_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Exhaustive ±16 SAD search. Returns (dy, dx, best_sad) per MB, int32.

    Candidate k = (dy+R)*33 + (dx+R) in row-major order; the minimum of
    the packed key sad*2048 + k is the strict-< first minimum of the
    reference (sad <= 65280 and k < 2048, so the key fits int32). One dy
    row of 33 candidates is evaluated per step."""
    return _full_search_padded(cur_y, pad_ref(ref_y, R))


def full_search_pre_haloed(cur_y: torch.Tensor, ref_ext: torch.Tensor):
    """full_search of a shard cur_y [..., h, w] whose reference ref_ext
    [..., h + 32, w] (row halo; columns edge-replicate) or [..., h + 32,
    w + 32] (both halos, a 2-D tile) already carries its neighbours'
    pixels: the halo replaces pad_ref's replication. Same first minimum."""
    h, w = cur_y.shape[-2:]
    if ref_ext.shape[-2] != h + 2 * R:
        raise ValueError(f"pre-haloed reference of {ref_ext.shape[-2]} rows "
                         f"for a shard of {h}")
    return _full_search_padded(cur_y, pad_cols(ref_ext, w, R))


def _full_search_padded(cur_y: torch.Tensor, refpad: torch.Tensor):
    h, w = cur_y.shape[-2:]
    best = None
    for ky in range(ND):
        rows = refpad[..., ky:ky + h, :]
        shifted = torch.stack([rows[..., kx:kx + w] for kx in range(ND)])
        sad = _mb_sums((cur_y - shifted).abs(), tables.MB)   # [33, ..., nby, nbx]
        k = ky * ND + torch.arange(ND, dtype=torch.int32, device=cur_y.device)
        key = (sad * 2048 + k.reshape(ND, *[1] * (sad.ndim - 1))).amin(0)
        best = key if best is None else torch.minimum(best, key)
    k = best & 2047
    return k // ND - R, k % ND - R, best >> 11


def _sad_map_padded(cur_y: torch.Tensor, refpad: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """SADs of every mv whose components are multiples of `stride`,
    [..., nby, nbx, nds * nds] int32 with nds = ceil(33 / stride):
    candidate ((dy+R)/stride)*nds + (dx+R)/stride. One dy row of nds
    candidates per step."""
    h, w = cur_y.shape[-2:]
    nds = -(-ND // stride)
    rows_of_sads = []
    for ky in range(nds):
        rows = refpad[..., stride * ky:stride * ky + h, :]
        shifted = torch.stack([rows[..., stride * kx:stride * kx + w]
                               for kx in range(nds)])
        rows_of_sads.append(_mb_sums((cur_y - shifted).abs(), tables.MB))
    return torch.cat(rows_of_sads).movedim(0, -1).contiguous()


def sad_map(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """The whole ±16 SAD volume, [..., nby, nbx, 1089] int32: candidate
    k = (dy+R)*33 + (dx+R), the values full_search sees there (same edge
    padding), so the first minimum of sad*2048 + k is full_search's."""
    return _sad_map_padded(cur_y, pad_ref(ref_y, R), 1)


def sad_map_even(cur_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """SADs of every even-even mv, [..., nby, nbx, 289] int32: candidate
    kE = ((dy+R)/2)*17 + (dx+R)/2, the values full_search sees there."""
    return _sad_map_padded(cur_y, pad_ref(ref_y, R), 2)


# Successive elimination (SEA): the order in which the search visits its dy
# rows, centre-out as the reference's kernel does: row index ky = dy + R
# for dy = 0, -1, +1, -2, +2, ... (sad.py, sea_body).
SEA_ORDER = tuple(R + ((s + 1) >> 1) * (1 - 2 * (s & 1)) for s in range(ND))


def full_search_sea(cur_y: torch.Tensor, ref_y: torch.Tensor,
                    with_mask: bool = False):
    """full_search with successive elimination: (dy, dx, sad, rows) int32
    [..., nby, nbx], where rows counts the dy rows each MB evaluated
    exactly (1..33). (dy, dx, sad) equal full_search's bit for bit.

    with_mask: also the rows themselves, [33, ..., nby, nbx] bool, whether
    the search evaluates dy row ky = dy + R of each MB exactly. The
    reference counts rows per tile of MBs, where a tile evaluates a row
    iff one of its MBs needs it: its count is the number of rows set in
    the OR of its MBs' masks."""
    dy, dx, sad, mask = _sea_padded(cur_y, pad_ref(ref_y, R))
    rows = mask.sum(0, dtype=torch.int32)
    return (dy, dx, sad, rows, mask) if with_mask else (dy, dx, sad, rows)


def full_search_sea_pre_haloed(cur_y: torch.Tensor, ref_ext: torch.Tensor):
    """full_search_sea of a shard against its pre-haloed reference (the
    geometry of full_search_pre_haloed): the column-sum bound reads the
    same halo'd and edge-replicated pixels as the exact SADs."""
    h, w = cur_y.shape[-2:]
    if ref_ext.shape[-2] != h + 2 * R:
        raise ValueError(f"pre-haloed reference of {ref_ext.shape[-2]} rows "
                         f"for a shard of {h}")
    dy, dx, sad, mask = _sea_padded(cur_y, pad_cols(ref_ext, w, R))
    return dy, dx, sad, mask.sum(0, dtype=torch.int32)


def _sea_padded(cur_y: torch.Tensor, refpad: torch.Tensor):
    """The SEA search against a padded reference [..., h + 32, w + 32].

    The lower bound of candidate (dy, dx) is the column-sum one,
    LB = sum_c |sum_r cur[y0+r, x0+c] - sum_r refpad[y0+dy+r, x0+dx+c]|
    over the MB's 16 columns c and rows r, which SAD >= LB by the triangle
    inequality. Rows are visited in SEA_ORDER; a row is evaluated iff its
    smallest LB is <= the MB's best SAD so far (the first row always:
    the best starts at the largest key). A pruned candidate then has
    SAD >= LB > best >= the final SAD, so the packed-key first minimum,
    ties included, is full_search's. Integer arithmetic throughout."""
    h, w = cur_y.shape[-2:]
    nby, nbx = h // tables.MB, w // tables.MB
    smap = _sad_map_padded(cur_y, refpad, 1).movedim(-1, 0)   # [1089, ..., nby, nbx]
    # 16-row column sums: of cur per MB row, and of the reference at every
    # row offset (an exclusive prefix sum over rows)
    curc = cur_y.reshape(*cur_y.shape[:-2], nby, tables.MB, w).sum(
        -2, dtype=torch.int32)                                  # [..., nby, w]
    cs = torch.nn.functional.pad(refpad.cumsum(-2, dtype=torch.int32),
                                 (0, 0, 1, 0))
    refc = cs[..., tables.MB:, :] - cs[..., :-tables.MB, :]   # [..., h + 17, w + 32]
    key_k = torch.arange(ND, dtype=torch.int32, device=cur_y.device)
    best = torch.full(smap.shape[1:], torch.iinfo(torch.int32).max,
                      dtype=torch.int32, device=cur_y.device)
    mask = torch.zeros((ND, *best.shape), dtype=torch.bool, device=cur_y.device)
    for ky in SEA_ORDER:
        rows = refc[..., ky:ky + h:tables.MB, :]                # [..., nby, w + 32]
        lb = torch.stack([_col_sums((curc - rows[..., kx:kx + w]).abs())
                          for kx in range(ND)])                 # [33, ..., nby, nbx]
        need = lb.amin(0) <= (best >> 11)
        kk = (ky * ND + key_k).reshape(ND, *[1] * best.ndim)
        row_best = (smap[ky * ND:(ky + 1) * ND] * 2048 + kk).amin(0)
        best = torch.where(need, torch.minimum(best, row_best), best)
        mask[ky] = need
    k = best & 2047
    return k // ND - R, k % ND - R, best >> 11, mask


def _col_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-MB sums of 16 consecutive columns of [..., W] -> [..., W/16]."""
    return x.reshape(*x.shape[:-1], -1, tables.MB).sum(-1, dtype=torch.int32)


def sad_at(cur_y: torch.Tensor, ref_y: torch.Tensor, dy: torch.Tensor,
           dx: torch.Tensor, bs: int = tables.MB, plane_of=None) -> torch.Tensor:
    """Per-block bs x bs SAD at integer mvs dy, dx [..., nby, nbx]
    (|mv| <= bs, the pad radius: 16 for luma MBs, 8 for chroma blocks; any
    number of candidate axes after cur_y's leading ones). With plane_of (K
    Python ints) ref_y is a stack of planes [..., P, H, W] and candidate k
    of dy, dx [..., K, nby, nbx] reads ref_y[..., plane_of[k], :, :].
    Returns int32 of dy's shape."""
    if plane_of is not None:
        return torch.stack([
            sad_at(cur_y, ref_y[..., p, :, :], dy[..., k, :, :],
                   dx[..., k, :, :], bs)
            for k, p in enumerate(plane_of)], -3)
    return _sad_at_padded(cur_y, pad_ref(ref_y, bs), dy, dx, bs)


def sad_at_pre_haloed(cur_y: torch.Tensor, ref_ext: torch.Tensor,
                      dy: torch.Tensor, dx: torch.Tensor, plane_of=None):
    """sad_at of a luma shard cur_y [..., h, w] against a pre-haloed
    reference [..., h + 32, w or w + 32] (or, with plane_of, a stack of
    such planes [..., P, h + 32, .]): the halo replaces pad_ref's
    replication."""
    if plane_of is not None:
        return torch.stack([
            sad_at_pre_haloed(cur_y, ref_ext[..., p, :, :], dy[..., k, :, :],
                              dx[..., k, :, :])
            for k, p in enumerate(plane_of)], -3)
    return _sad_at_padded(cur_y, pad_cols(ref_ext, cur_y.shape[-1], R), dy,
                          dx, tables.MB)


def _sad_at_padded(cur_y, refpad, dy, dx, bs: int):
    lead = cur_y.shape[:-2]
    cand = [1] * (dy.ndim - 2 - len(lead))
    cur_b = blockify(cur_y, bs)
    cur_b = cur_b.reshape(*lead, *cand, *cur_b.shape[-4:])
    pred = mc_fetch(refpad, dy, dx, bs, bs)
    return (cur_b - pred).abs().sum(dim=(-2, -1), dtype=torch.int32)


def diamond_search_with(cur_y: torch.Tensor, sad_fn, sad_fn_small):
    """Masked diamond search (SPEC.md §9) over per-MB SAD evaluators that
    take mvs [..., K, nby, nbx]: sad_fn for the even-lattice large-diamond
    loop, sad_fn_small for the final ±1 step. Returns (dy, dx, sad) int32
    of shape [..., nby, nbx], the leading axes being cur_y's.

    The loop runs the fixed budget of DIAMOND_MAX_STEPS steps and never
    reads a device value on the host. The reference's while-loop stops
    once every MB is frozen, and a step where every MB is frozen is the
    identity, so the two agree bit for bit. Candidates are ranked by the
    packed int64 key cost * 8 + index (invalid ones cost BIG), whose
    minimum is the first minimum in the order current, up, left, right,
    down."""
    *lead, h, w = cur_y.shape
    dev = cur_y.device
    dy = torch.zeros((*lead, h // tables.MB, w // tables.MB),
                     dtype=torch.int32, device=dev)
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
        dy1, dx1 = dy.unsqueeze(-3), dx.unsqueeze(-3)
        ndy, ndx = dy1 + offs[0], dx1 + offs[1]             # [..., 4, nby, nbx]
        valid = (ndy.abs() <= R) & (ndx.abs() <= R)
        cs = torch.where(valid, fn(ndy.clamp(-R, R), ndx.clamp(-R, R)), BIG)
        cc = torch.cat([cost.unsqueeze(-3), cs], -3).long()  # [..., 5, nby, nbx]
        widx = (cc * 8 + idx).amin(-3) & 7
        cand_dy = torch.cat([dy1, ndy], -3)
        cand_dx = torch.cat([dx1, ndx], -3)
        pick = widx.unsqueeze(-3)
        wdy = cand_dy.gather(-3, pick).squeeze(-3)
        wdx = cand_dx.gather(-3, pick).squeeze(-3)
        wcost = cc.gather(-3, pick).squeeze(-3).int()
        return (torch.where(frozen, dy, wdy), torch.where(frozen, dx, wdx),
                torch.where(frozen, cost, wcost), (widx != 0) & ~frozen)

    for _ in range(spec.DIAMOND_MAX_STEPS):
        dy, dx, cost, moved = evaluate(dy, dx, cost, frozen, large, sad_fn)
        frozen = frozen | ~moved | (cost < spec.DIAMOND_EARLY_SAD)
    dy, dx, cost, _ = evaluate(dy, dx, cost, torch.zeros_like(frozen), unit,
                               sad_fn_small)
    return dy, dx, cost


def diamond_descent(cur_y: torch.Tensor, ref_y: torch.Tensor,
                    meven: torch.Tensor):
    """Diamond search over the even SAD map meven [..., nby, nbx, 289] of
    the planes (sad_map_even's): every large-diamond candidate is a
    torch.gather from the map (the loop only visits even-even mvs), the
    final ±1 step's four SADs come from sad_at. The plain version of the
    descent kernel (csrc/diamond.cu). Returns (dy, dx, sad) int32
    [..., nby, nbx]."""
    def sad_even(dy, dx):
        k = (((dy + R) >> 1) * NE + ((dx + R) >> 1)).long()
        if k.ndim < meven.ndim:                   # no candidate axis
            return torch.gather(meven, -1, k[..., None])[..., 0]
        return torch.gather(meven, -1, k.movedim(-3, -1)).movedim(-1, -3)

    def sad_small(dy, dx):
        return sad_at(cur_y, ref_y, dy, dx)

    return diamond_search_with(cur_y, sad_even, sad_small)


def diamond_search(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Diamond search with every SAD from sad_at: the plain route."""
    def fn(dy, dx):
        return sad_at(cur_y, ref_y, dy, dx)
    return diamond_search_with(cur_y, fn, fn)


def down2(plane: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample of [..., H, W] (H, W even), round half up:
    (a+b+c+d+2) >> 2 (SPEC.md §9, spec.down2)."""
    *lead, h, w = plane.shape
    q = plane.reshape(*lead, h // 2, 2, w // 2, 2).sum(dim=(-3, -1),
                                                      dtype=torch.int32)
    return (q + 2) >> 2


def hier_coarse(cur_y: torch.Tensor, ref_y: torch.Tensor):
    """Coarse stage of the hier search (SPEC.md §9): the ±HIER_COARSE_R
    full search of each MB's 4x4 block on the 4x-downsampled planes,
    row-major first minimum (packed key sad * 128 + k), scaled by 4.
    Returns (cdy, cdx) [..., nby, nbx] int32. The 4x4 block sums are
    integer reshape-sums."""
    cq = down2(down2(cur_y))
    rqpad = pad_ref(down2(down2(ref_y)), spec.HIER_COARSE_R)
    hq, wq = cq.shape[-2:]
    nd = 2 * spec.HIER_COARSE_R + 1
    best = None
    for k in range(nd * nd):     # sad <= 4080 and k < 81 < 128
        shifted = rqpad[..., k // nd:k // nd + hq, k % nd:k % nd + wq]
        key = _mb_sums((cq - shifted).abs(), 4) * 128 + k
        best = key if best is None else torch.minimum(best, key)
    k = best & 127
    return ((k // nd - spec.HIER_COARSE_R) * 4,
            (k % nd - spec.HIER_COARSE_R) * 4)


def hier_search(cur_y: torch.Tensor, ref_y: torch.Tensor, refine_sad_fn=None):
    """Hierarchical search (SPEC.md §9 "hier"), bit-exact with the
    reference's hier_search and golden.sad_hier_search: hier_coarse, then
    HIER_REFINE_STEPS refinements over the 25 candidates (dy+u, dx+v),
    u, v in ±HIER_REFINE_R, row-major; a candidate beyond ±16 costs BIG
    and each step takes the first minimum. refine_sad_fn(dy, dx) gives
    per-MB SADs at integer mvs; with a true `batched` attribute it takes
    all 25 candidates at once, [..., 25, nby, nbx] (one sad_at_mv launch
    on the card, ops/dispatch.py), else one [..., nby, nbx] candidate per
    call. The default is the plain sad_at, batched. Returns (dy, dx, sad)
    int32 [..., nby, nbx]."""
    dy, dx = hier_coarse(cur_y, ref_y)
    if refine_sad_fn is None:
        refpad = pad_ref(ref_y, R)

        def refine_sad_fn(dy, dx):
            return _sad_at_padded(cur_y, refpad, dy, dx, tables.MB)
        refine_sad_fn.batched = True
    nd = 2 * spec.HIER_REFINE_R + 1
    k = torch.arange(nd * nd, device=cur_y.device)[:, None, None]
    u = torch.div(k, nd, rounding_mode="floor").int() - spec.HIER_REFINE_R
    v = (k % nd).int() - spec.HIER_REFINE_R
    sad = None
    for _ in range(spec.HIER_REFINE_STEPS):
        ndy = dy.unsqueeze(-3) + u                         # [..., 25, nby, nbx]
        ndx = dx.unsqueeze(-3) + v
        valid = (ndy.abs() <= R) & (ndx.abs() <= R)
        cdy, cdx = ndy.clamp(-R, R), ndx.clamp(-R, R)
        if getattr(refine_sad_fn, "batched", False):
            cc = refine_sad_fn(cdy, cdx)
        else:
            cc = torch.stack([refine_sad_fn(cdy[..., j, :, :], cdx[..., j, :, :])
                              for j in range(nd * nd)], -3)
        # packed int64 key cost * 32 + index: its minimum is the first minimum
        best = (torch.where(valid, cc, BIG).long() * 32 + k).amin(-3)
        pick = (best & 31).unsqueeze(-3)
        dy = ndy.gather(-3, pick).squeeze(-3)
        dx = ndx.gather(-3, pick).squeeze(-3)
        sad = (best >> 5).int()
    return dy, dx, sad


def mc_fetch(refpad: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
             bs: int, r: int) -> torch.Tensor:
    """Per-block predictor gather [..., nby, nbx, bs, bs] from refpad
    (padded by r) at the per-block integer mvs [..., nby, nbx]. With
    refpad [G, Hp, Wp] the mvs lead with the same G and block g reads
    refpad[g]."""
    nby, nbx = dy.shape[-2:]
    dev = refpad.device
    *lead, hp, wp = refpad.shape
    my = torch.arange(nby, device=dev)[:, None, None, None] * bs
    mx = torch.arange(nbx, device=dev)[None, :, None, None] * bs
    ii = torch.arange(bs, device=dev)[None, None, :, None]
    jj = torch.arange(bs, device=dev)[None, None, None, :]
    rows = r + my + dy.long()[..., None, None] + ii
    cols = r + mx + dx.long()[..., None, None] + jj
    if not lead:
        return refpad[rows, cols]
    flat = rows * wp + cols
    g = torch.arange(lead[0], device=dev) * (hp * wp)
    return refpad.reshape(-1)[flat + g.reshape(-1, *[1] * (flat.ndim - 1))]


def mc_fetch_plane(ref: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   bs: int) -> torch.Tensor:
    """[..., H, W] predictor plane from per-block mvs; |mv| <= bs, the pad
    radius (16 for luma MBs, 8 for chroma blocks)."""
    return unblockify(mc_fetch(pad_ref(ref, bs), dy, dx, bs, bs))


def mc_fetch_pre_haloed(ref_ext: torch.Tensor, dy: torch.Tensor,
                        dx: torch.Tensor, bs: int, r: int) -> torch.Tensor:
    """[..., h, w] predictor plane of a shard from its pre-haloed reference
    ref_ext [..., h + 2r, w] (columns edge-replicate) or [..., h + 2r,
    w + 2r], at per-block mvs [..., h/bs, w/bs] with |mv| <= r (16 for luma
    MBs, 8 for chroma blocks)."""
    w = dy.shape[-1] * bs
    if ref_ext.shape[-2] != dy.shape[-2] * bs + 2 * r:
        raise ValueError(f"pre-haloed reference of {ref_ext.shape[-2]} rows "
                         f"for {dy.shape[-2]} block rows of {bs}")
    return unblockify(mc_fetch(pad_cols(ref_ext, w, r), dy, dx, bs, r))


def mc_fetch_stack(ref: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   bs: int, halo: bool = False) -> torch.Tensor:
    """[..., h, w] predictor of one plane from its stack ref
    [..., P, rh, rw] at per-block vectors dy, dx [..., h/bs, w/bs]. P = 1:
    the integer fetch mc_fetch_plane, or with halo mc_fetch_pre_haloed
    from a pre-haloed plane of radius bs. P = 4, the parity planes in
    hpel_stack order and the vectors in half-pels: the half-pel MC of
    SPEC.md §14.2, an integer fetch from each parity plane at d >> 1, then
    a per-block select by (dy & 1) * 2 + (dx & 1)."""
    def fetch(plane, vy, vx):
        if halo:
            return mc_fetch_pre_haloed(plane, vy, vx, bs, bs)
        return mc_fetch_plane(plane, vy, vx, bs)

    if ref.shape[-3] == 1:
        return fetch(ref[..., 0, :, :], dy, dx)
    iy, ix = dy >> 1, dx >> 1
    sel = (dy & 1) * 2 + (dx & 1)
    sel_px = sel.repeat_interleave(bs, -2).repeat_interleave(bs, -1)
    fetched = torch.stack([fetch(p.contiguous(), iy, ix)
                           for p in ref.unbind(-3)])
    return fetched.gather(0, sel_px.long()[None])[0]


def mc_predict(refs, dy: torch.Tensor, dx: torch.Tensor,
               is_inter: torch.Tensor, halo: bool = False):
    """(pred_y, pred_cb, pred_cr) of a P frame step: the plain version of
    the predictor kernel. refs (luma, cb, cr) are stacks [..., P, rh, rw]
    of one plane (P = 1, integer vectors) or of the four parity planes
    (P = 4, vectors in half-pels), pre-haloed with halo; dy, dx
    [..., nby, nbx] per MB in luma units, the chroma vector dy >> 1
    (SPEC.md §2); an MB with is_inter False predicts 128. Each plane is
    mc_fetch_stack of its stack."""
    chroma = (dy >> 1, dx >> 1)
    preds = []
    for ref, (vy, vx), bs in zip(refs, ((dy, dx), chroma, chroma),
                                 (tables.MB, tables.BLK, tables.BLK)):
        mask = is_inter.repeat_interleave(bs, -2).repeat_interleave(bs, -1)
        preds.append(torch.where(mask, mc_fetch_stack(ref, vy, vx, bs, halo),
                                 128))
    return tuple(preds)


def intra_cost_and_dc(cur_y: torch.Tensor):
    """Per-MB DC and SAD against that DC (SPEC.md §9/§10), int32."""
    dc = (_mb_sums(cur_y, tables.MB) + 128) >> 8
    dc_px = dc.repeat_interleave(tables.MB, -2).repeat_interleave(tables.MB, -1)
    return dc, _mb_sums((cur_y - dc_px).abs(), tables.MB)


def adaptive_qp(base_qp: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """rc=adaptive per-MB qp (SPEC.md §10): base_qp + bitlen(act) - 10,
    clipped to the qp range, from the per-MB intra cost [..., nby, nbx];
    base_qp is a 0-dim tensor or, with a G axis on act, [G]."""
    return (base_qp[..., None, None] + (bitlen(act) - 10)).clamp(
        tables.QP_MIN, tables.QP_MAX).int()


def hpel_planes(p: torch.Tensor):
    """SPEC.md §14.2 parity planes (H, V, D) on the plane grid, the +1
    reads clamped at the edge."""
    b = torch.cat([p[..., 1:], p[..., -1:]], -1)            # p[y, x+1]
    c = torch.cat([p[..., 1:, :], p[..., -1:, :]], -2)      # p[y+1, x]
    d = torch.cat([b[..., 1:, :], b[..., -1:, :]], -2)      # p[y+1, x+1]
    return (p + b + 1) >> 1, (p + c + 1) >> 1, (p + b + c + d + 2) >> 2


def hpel_stack(p: torch.Tensor) -> torch.Tensor:
    """[..., 4, H, W]: the plane and its H, V, D parity planes, indexed by
    (d2y & 1) * 2 + (d2x & 1)."""
    return torch.stack([p, *hpel_planes(p)], -3)
