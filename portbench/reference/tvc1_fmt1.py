"""Plain PyTorch reference of the TVC1 encoder, format 1 (SPEC.md §§1-10).

The benchmark's own statement of what a GOP encode must give: the frame
packets' bytes and each frame's sum of squared errors, for full (±16) or
diamond search and rc none or mb, on planes already padded to the
macroblock grid. It is written from the spec's integer formulas, runs on
whatever device its planes are on, and imports nothing of the encoder
under test: every table is restated here, and everything the program
derives from the planes (searches, predictors, levels, per-MB qps, bits)
is worked out again.

`transform` selects the dtype of the transform's matrix products: float64
holds every product and partial sum of the ITX8 exactly (the spec's
integer transform); bfloat16 is the control, the tensor-core shortcut
that gives up the spec's exactness.
"""

from __future__ import annotations

import struct
import zlib

import torch

# SPEC.md §3: B = round(1024 * orthonormal DCT-II 8x8), both passes >> 10
B_MATRIX = (
    (362, 362, 362, 362, 362, 362, 362, 362),
    (502, 426, 284, 100, -100, -284, -426, -502),
    (473, 196, -196, -473, -473, -196, 196, 473),
    (426, -100, -502, -284, 284, 502, 100, -426),
    (362, -362, -362, 362, 362, -362, -362, 362),
    (284, -502, 100, 426, -426, -100, 502, -284),
    (196, -473, 473, -196, -196, 473, -473, 196),
    (100, -284, 426, -502, 502, -426, 284, -100),
)
TX_SHIFT = 10
# SPEC.md §4
QSTEP = tuple(max(1, int(2.0 ** (qp / 6.0) + 0.5)) for qp in range(64))
QP_MIN, QP_MAX = 1, 63
# SPEC.md §5: raster index of the k-th scan position
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
MB, BLK, R = 16, 8, 16           # macroblock, transform block, search radius
N_SIDE = 2 * R + 1               # 33 candidates a row: 1089 in all
DIAMOND_MAX_STEPS, DIAMOND_EARLY_SAD = 16, 512
FAR = 1 << 40                    # the cost of a candidate outside the window
SEARCH_ID = {"full": 0, "diamond": 1}


def check_config(enc: dict) -> None:
    """Raise unless the encoder settings are ones this reference states."""
    want = dict(format_version=1, chroma_qp_offset=0, quant_matrix=False,
                intra_slice_mbrows=0, quant_bias=8, gop_devices=1,
                tile_devices=1)
    off = {k: enc.get(k, v) for k, v in want.items() if enc.get(k, v) != v}
    if off or enc.get("search", "full") not in SEARCH_ID or enc.get(
            "rc", "none") not in ("none", "mb"):
        raise ValueError(f"the format-1 reference does not state {off or enc}")


def stream_header(enc: dict, frame_count: int) -> bytes:
    """SPEC.md §8 stream header of a format-1 stream; the config hash is
    the CRC32 of the canonical string."""
    check_config(enc)
    canon = (f"tvc1:w={enc['width']}:h={enc['height']}:gop={enc['gop_n']}"
             f":qp={enc['base_qp']}:search={enc['search']}:rc={enc['rc']}"
             f":kbps={enc.get('target_kbps', 0)}"
             f":fps={enc.get('fps_num', 30)}/{enc.get('fps_den', 1)}")
    return struct.pack("<4sHHHHHBBII", b"TVC1", 1, int(enc["gop_n"] == 1),
                       enc["width"], enc["height"], enc["gop_n"],
                       enc["base_qp"], SEARCH_ID[enc["search"]], frame_count,
                       zlib.crc32(canon.encode()) & 0xFFFFFFFF)


def target_bits(enc: dict) -> int:
    """Bits per frame of the rc=mb target (0 under rc none)."""
    if enc["rc"] != "mb":
        return 0
    return (enc["target_kbps"] * 1000 * enc.get("fps_den", 1)) // enc.get(
        "fps_num", 30)


# ---- geometry -------------------------------------------------------------

def pad_edge(p: torch.Tensor, r: int) -> torch.Tensor:
    """[H, W] edge-replicated by r on every side."""
    h, w = p.shape
    rows = torch.arange(-r, h + r, device=p.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=p.device).clamp(0, w - 1)
    return p[rows][:, cols]


def blockify(p: torch.Tensor, n: int) -> torch.Tensor:
    """[H, W] -> [H/n, W/n, n, n]."""
    h, w = p.shape
    return p.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3)


def unblockify(b: torch.Tensor) -> torch.Tensor:
    """[by, bx, n, n] -> [by n, bx n]."""
    by, bx, n, _ = b.shape
    return b.permute(0, 2, 1, 3).reshape(by * n, bx * n)


def fetch(padded: torch.Tensor, dy, dx, bs: int, r: int) -> torch.Tensor:
    """Blocks [nby, nbx, bs, bs] at per-block integer vectors from a plane
    edge-padded by r."""
    nby, nbx = dy.shape
    dev = padded.device
    ii = torch.arange(bs, device=dev)
    rows = (r + torch.arange(nby, device=dev)[:, None, None, None] * bs
            + dy[:, :, None, None] + ii[None, None, :, None])
    cols = (r + torch.arange(nbx, device=dev)[None, :, None, None] * bs
            + dx[:, :, None, None] + ii[None, None, None, :])
    return padded[rows, cols]


# ---- motion (SPEC.md §9) --------------------------------------------------

def full_search(cur: torch.Tensor, ref: torch.Tensor):
    """±16 exhaustive SAD search per 16x16 MB: candidates dy-major, dx
    inner, the first minimum wins. (dy, dx, sad) [nby, nbx] int64."""
    h, w = cur.shape
    nby, nbx = h // MB, w // MB
    rp = pad_edge(ref.to(torch.int16), R)
    cur16 = cur.to(torch.int16).reshape(h, 1, w)
    k_row = torch.arange(N_SIDE, device=cur.device).view(1, N_SIDE, 1)
    best = torch.full((nby, nbx), FAR, dtype=torch.int64, device=cur.device)
    for i in range(N_SIDE):                      # dy = i - R
        windows = rp[i:i + h].unfold(1, w, 1)    # [h, 33, w]: dx = j - R
        sad = (cur16 - windows).abs().reshape(nby, MB, N_SIDE, nbx, MB).sum(
            (1, 4), dtype=torch.int64)           # [nby, 33, nbx]
        key = sad * 2048 + (i * N_SIDE + k_row)
        best = torch.minimum(best, key.amin(1))
    k = best % 2048
    return k // N_SIDE - R, k % N_SIDE - R, best // 2048


def sad_at(cur_b: torch.Tensor, rp: torch.Tensor, dy, dx) -> torch.Tensor:
    """SAD per MB at per-MB vectors; rp is the reference padded by R."""
    return (cur_b - fetch(rp, dy, dx, MB, R)).abs().sum((2, 3))


def diamond_search(cur: torch.Tensor, ref: torch.Tensor):
    """Large diamond steps from (0, 0), an MB freezing when its centre
    wins or its SAD falls under 512, at most 16 steps, then one small
    diamond step for every MB; first minimum in candidate order."""
    nby, nbx = cur.shape[0] // MB, cur.shape[1] // MB
    cur_b = blockify(cur.long(), MB)
    rp = pad_edge(ref.long(), R)
    dy = torch.zeros((nby, nbx), dtype=torch.int64, device=cur.device)
    dx = torch.zeros_like(dy)
    cost = sad_at(cur_b, rp, dy, dx)
    frozen = cost < DIAMOND_EARLY_SAD

    def step(dy, dx, cost, frozen, offsets):
        costs, dys, dxs = [cost], [dy], [dx]
        for ody, odx in offsets:
            ndy, ndx = dy + ody, dx + odx
            valid = (ndy.abs() <= R) & (ndx.abs() <= R)
            c = sad_at(cur_b, rp, ndy.clamp(-R, R), ndx.clamp(-R, R))
            costs.append(torch.where(valid, c, FAR))
            dys.append(ndy)
            dxs.append(ndx)
        cc = torch.stack(costs)
        win = (cc * 8 + torch.arange(5, device=cc.device).view(5, 1, 1)
               ).argmin(0, keepdim=True)         # first minimum
        wdy = torch.stack(dys).gather(0, win)[0]
        wdx = torch.stack(dxs).gather(0, win)[0]
        wcost = cc.gather(0, win)[0]
        moved = (win[0] != 0) & ~frozen
        return (torch.where(frozen, dy, wdy), torch.where(frozen, dx, wdx),
                torch.where(frozen, cost, wcost), moved)

    large = ((-2, 0), (0, -2), (0, 2), (2, 0))
    for _ in range(DIAMOND_MAX_STEPS):   # a frozen MB keeps its state
        dy, dx, cost, moved = step(dy, dx, cost, frozen, large)
        frozen = frozen | ~moved | (cost < DIAMOND_EARLY_SAD)
    small = ((-1, 0), (0, -1), (0, 1), (1, 0))
    dy, dx, cost, _ = step(dy, dx, cost, torch.zeros_like(frozen), small)
    return dy, dx, cost


def intra_cost(cur: torch.Tensor) -> torch.Tensor:
    """Per-MB SAD against the MB's rounded mean, int64 [nby, nbx]."""
    b = blockify(cur.long(), MB)
    dc = (b.sum((2, 3)) + 128) >> 8
    return (b - dc[:, :, None, None]).abs().sum((2, 3))


# ---- transform, quantizer, reconstruction (SPEC.md §§3-5) -----------------

def rshift_round(v: torch.Tensor, s: int) -> torch.Tensor:
    mag = (v.abs() + (1 << (s - 1))) >> s
    return torch.where(v < 0, -mag, mag)


def _products(a, b, dtype):
    """Integer matrix product a @ b through `dtype`, back to int64."""
    return torch.matmul(a.to(dtype), b.to(dtype)).round().long()


def forward_transform(x: torch.Tensor, dtype) -> torch.Tensor:
    b = torch.tensor(B_MATRIX, device=x.device)
    t1 = rshift_round(_products(b, x, dtype), TX_SHIFT)
    return rshift_round(_products(t1, b.T, dtype), TX_SHIFT)


def inverse_transform(c: torch.Tensor, dtype) -> torch.Tensor:
    b = torch.tensor(B_MATRIX, device=c.device)
    u1 = rshift_round(_products(b.T, c, dtype), TX_SHIFT)
    return rshift_round(_products(u1, b, dtype), TX_SHIFT)


def assemble(y8, cb8, cr8) -> torch.Tensor:
    """[nby, nbx, 6, 8, 8] in block order Y00, Y08, Y80, Y88, Cb, Cr from
    [2 nby, 2 nbx, 8, 8] luma and [nby, nbx, 8, 8] chroma blocks."""
    return torch.stack([y8[0::2, 0::2], y8[0::2, 1::2], y8[1::2, 0::2],
                        y8[1::2, 1::2], cb8, cr8], 2)


def scatter(b6: torch.Tensor):
    """assemble's inverse: (luma [2 nby, 2 nbx, 8, 8], cb, cr)."""
    nby, nbx = b6.shape[:2]
    y8 = b6.new_empty((2 * nby, 2 * nbx, BLK, BLK))
    y8[0::2, 0::2], y8[0::2, 1::2] = b6[:, :, 0], b6[:, :, 1]
    y8[1::2, 0::2], y8[1::2, 1::2] = b6[:, :, 2], b6[:, :, 3]
    return y8, b6[:, :, 4], b6[:, :, 5]


def code(cur, pred, qp_mb, dtype):
    """Residual -> ITX8 -> quantize (midpoint) -> dequantize -> inverse ->
    clipped recon of the three planes at per-MB qps. Returns (levels in
    zigzag order [nby nbx, 6, 64], recon planes)."""
    y, cb, cr = (p.long() for p in cur)
    py, pcb, pcr = pred
    resid = assemble(blockify(unblockify(blockify(y, MB) - py), BLK),
                     blockify(cb, BLK) - pcb, blockify(cr, BLK) - pcr)
    q = torch.tensor(QSTEP, device=y.device)[qp_mb]
    q6 = q[:, :, None, None, None].expand(-1, -1, 6, 1, 1)
    c = forward_transform(resid, dtype)
    mag = (2 * c.abs() + q6) // (2 * q6)
    levels = torch.where(c < 0, -mag, mag)
    ry8, rcb8, rcr8 = scatter(inverse_transform(levels * q6, dtype))
    rec = tuple((unblockify(r) + unblockify(p)).clamp(0, 255)
                for r, p in ((ry8, blockify(unblockify(py), BLK)),
                             (rcb8, pcb), (rcr8, pcr)))
    zz = torch.tensor(ZIGZAG, device=y.device)
    return levels.reshape(-1, 6, 64)[..., zz], rec


# ---- entropy coding (SPEC.md §§6-7, format 1) -----------------------------

def bitlen(v: torch.Tensor) -> torch.Tensor:
    """floor(log2 v) + 1 for v >= 1, 0 for 0."""
    out = torch.zeros_like(v)
    cur = v.clone()
    for shift in (32, 16, 8, 4, 2, 1):
        big = cur >= (1 << shift)
        out = torch.where(big, out + shift, out)
        cur = torch.where(big, cur >> shift, cur)
    return out + (cur > 0).long()


def ue(v: torch.Tensor):
    """(code, length) of the Exp-Golomb ue(v)."""
    return v + 1, 2 * bitlen(v + 1) - 1


def se(v: torch.Tensor):
    return ue(torch.where(v > 0, 2 * v - 1, -2 * v))


def symbols(levels_zz, qp_delta, is_p: bool, is_inter, dy, dx):
    """Every code of a frame in stream order as (values, lengths) [n_mbs,
    784], a zero length where a slot holds no code: per MB the mode, the
    vector (dx, dy) and the qp delta, then for each of the six blocks its
    coded flag, ue(nnz - 1) and (ue(run), se(level)) at each nonzero
    position of the zigzag scan."""
    n = levels_zz.shape[0]
    dev = levels_zz.device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    inter = is_inter.reshape(n)
    if is_p:
        mode = (torch.where(inter, 1, 2), torch.where(inter, 1, 3))
        mvx, mvy = se(dx.reshape(n)), se(dy.reshape(n))
        mvx = (mvx[0], torch.where(inter, mvx[1], 0))
        mvy = (mvy[0], torch.where(inter, mvy[1], 0))
    else:
        mode = mvx = mvy = (zero, zero)
    dq = se(qp_delta.reshape(n))
    head_v = torch.stack([mode[0], mvx[0], mvy[0], dq[0]], 1)
    head_l = torch.stack([mode[1], mvx[1], mvy[1], dq[1]], 1)

    nz = levels_zz != 0                                  # [n, 6, 64]
    nnz = nz.sum(-1)
    pos = torch.arange(64, device=dev)
    last = torch.cummax(torch.where(nz, pos, -1), -1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], -1)
    run_v, run_l = ue(pos - prev - 1)
    lev_v, lev_l = se(levels_zz)
    pair_v = torch.stack([run_v, lev_v], -1).reshape(n, 6, 128)
    pair_l = torch.where(nz[..., None], torch.stack([run_l, lev_l], -1),
                         0).reshape(n, 6, 128)
    cnt_v, cnt_l = ue((nnz - 1).clamp(min=0))
    blk_v = torch.cat([(nnz > 0).long()[..., None], cnt_v[..., None], pair_v],
                      -1)
    blk_l = torch.cat([torch.ones_like(nnz)[..., None],
                       torch.where(nnz > 0, cnt_l, 0)[..., None], pair_l], -1)
    return (torch.cat([head_v, blk_v.reshape(n, -1)], 1),
            torch.cat([head_l, blk_l.reshape(n, -1)], 1))


def pack(values: torch.Tensor, lengths: torch.Tensor) -> tuple[bytes, int]:
    """The codes MSB-first in stream order as big-endian 32-bit words:
    (payload bytes, bit count)."""
    keep = lengths.reshape(-1) > 0
    v, ln = values.reshape(-1)[keep], lengths.reshape(-1)[keep]
    if int(ln.max()) > 32:
        raise ValueError("a code longer than 32 bits")
    pos = torch.cumsum(ln, 0) - ln
    nbits = int(ln.sum())
    words = torch.zeros((nbits + 31) // 32 + 1, dtype=torch.int64,
                        device=v.device)
    w, avail = pos >> 5, 32 - (pos & 31)
    fits = ln <= avail
    spill = (ln - avail).clamp(min=0)
    words.index_add_(0, w, torch.where(fits, v << (avail - ln).clamp(min=0),
                                       v >> spill))
    tail = (v & ((1 << spill) - 1)) << (32 - spill)
    words.index_add_(0, (w + 1)[~fits], tail[~fits])
    nwords = (nbits + 31) // 32
    return words[:nwords].cpu().numpy().astype(">u4").tobytes(), nbits


def mb_rc_offsets(est: torch.Tensor) -> torch.Tensor:
    """rc=mb per-MB qp offsets (SPEC.md §10.4) from pass-1 bits [nby, nbx]."""
    nbx = est.shape[-1]
    row_tot = est.sum(-1, keepdim=True).clamp(min=1)
    share = est * 1024 // row_tot
    spent = torch.cumsum(share, -1) - share
    plan = torch.arange(nbx, device=est.device) * 1024 // nbx
    return ((spent - plan) >> 7).clamp(-2, 2)


# ---- the GOP --------------------------------------------------------------

def encode_gop(enc: dict, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               transform=torch.float64):
    """One closed GOP of padded uint8 planes y [T, H, W], cb and cr
    [T, H/2, W/2]: frame 0 intra, the rest predicted from the previous
    frame's reconstruction; the frame qp starts at base_qp and, under rc
    mb, moves by the proportional term of SPEC.md §10 after every frame.
    Returns (packet bytes per frame, sse [T, 3] int64 on the host)."""
    check_config(enc)
    t_len, h, w = y.shape
    nby, nbx = h // MB, w // MB
    target = target_bits(enc)
    qp = enc["base_qp"]
    ref, packets, sse = None, [], []
    for t in range(t_len):
        cur = (y[t].long(), cb[t].long(), cr[t].long())
        is_p = ref is not None
        if is_p:
            search = full_search if enc["search"] == "full" else diamond_search
            dy, dx, sad = search(cur[0], ref[0])
            inter = sad <= intra_cost(cur[0])
            m = inter[:, :, None, None]
            cdy, cdx = dy >> 1, dx >> 1
            pred = (torch.where(m, fetch(pad_edge(ref[0], R), dy, dx, MB, R),
                                128),
                    torch.where(m, fetch(pad_edge(ref[1], BLK), cdy, cdx,
                                         BLK, BLK), 128),
                    torch.where(m, fetch(pad_edge(ref[2], BLK), cdy, cdx,
                                         BLK, BLK), 128))
        else:
            dy = dx = torch.zeros((nby, nbx), dtype=torch.int64,
                                  device=y.device)
            inter = torch.zeros((nby, nbx), dtype=torch.bool, device=y.device)
            pred = (torch.full((nby, nbx, MB, MB), 128, device=y.device),
                    torch.full((nby, nbx, BLK, BLK), 128, device=y.device),
                    torch.full((nby, nbx, BLK, BLK), 128, device=y.device))
        qp_mb = torch.full((nby, nbx), qp, dtype=torch.int64, device=y.device)
        if enc["rc"] == "mb":     # pass 1 at the flat qp sets per-MB offsets
            lz, _ = code(cur, pred, qp_mb, transform)
            _, lens = symbols(lz, qp_mb - qp, is_p, inter, dy, dx)
            est = lens.sum(1).reshape(nby, nbx)
            qp_mb = (qp + mb_rc_offsets(est)).clamp(QP_MIN, QP_MAX)
        lz, rec = code(cur, pred, qp_mb, transform)
        payload, nbits = pack(*symbols(lz, qp_mb - qp, is_p, inter, dy, dx))
        packets.append(struct.pack("<BBHI", int(is_p), qp, 0, nbits) + payload)
        sse.append(torch.stack([((c - r) ** 2).sum() for c, r in zip(cur, rec)]))
        if target > 0:
            delta = max(-2, min(2, ((nbits - target) * 4) // target))
            qp = max(QP_MIN, min(QP_MAX, qp + delta))
        ref = rec
    return packets, torch.stack(sse).cpu()
