"""Plain PyTorch reference of the TVC1 encoder, format 4 (SPEC.md §§12-14
on §§1-10).

The benchmark's own statement of what a format-4 GOP encode must give:
the frame packets' bytes and each frame's sum of squared errors, for full
(±16) or diamond search, rc none or mb, the quant matrix on or off and any
chroma qp offset in [-12, 12], on planes already padded to the macroblock
grid. Format 4 is format 1 with every later coding tool at once:

- §12.2: chroma quantizes at clamp(qp_mb + chroma_qp_offset, 1, 63);
- §12.3: an inter MB codes its vector as the difference from its left
  MB's, where that MB is inter (in half-pel units, §14.1);
- §12.4-12.5: each 8x8 block codes its DC level as the difference from the
  left block's on its plane's block grid, then the count of nonzero ACs
  and their (run, level) pairs from zigzag position 1;
- §13.1: an I frame predicts each 8-row stripe of every plane from the
  reconstructed row above it (128 above the first), a chain over stripes;
- §13.2: with the quant matrix, position (i, j) of a block quantizes at
  max(1, (qstep * QMAT[i][j] + 8) >> 4), QMAT = 16 + 2 (i + j), DC 16;
- §14.2-14.4: the integer search is refined over the nine half-pel
  candidates around it on the H, V and D parity planes (each plane
  edge-replicated after it is interpolated), the first minimum winning;
  the winner's SAD decides the mode; chroma takes the vector d >> 1 in
  chroma half-pels on the chroma planes' parities.

It imports nothing of the encoder under test. The pieces format 4 leaves
as format 1 has them (the transform, zigzag, Exp-Golomb, the pack, the
searches, the intra cost, the rc mb offsets) are `tvc1_fmt1`'s; the rest
is worked out here from the spec's text. Departures from that text, none
of which changes a bit of the output:

- the nine refine candidates' SADs are taken with the vector clamped to
  ±32 half-pels, so that a candidate the spec calls invalid (cost +inf)
  still reads inside the padded plane; its cost is then set to +inf;
- the spec's int32 arithmetic is carried in int64 (no value it bounds
  comes near either limit), and the transform's matrix products in
  `transform` (float64 holds each of them exactly, as in tvc1_fmt1).
"""

from __future__ import annotations

import struct
import zlib

import torch
import torch.nn.functional as F

from . import tvc1_fmt1 as v1
from .tvc1_fmt1 import BLK, FAR, MB, QP_MAX, QP_MIN, R

R2 = 2 * R                      # the half-pel window: ±32
# §14.4: the refine's candidates (u, v), u outer, v inner
HPEL_STEPS = tuple((u, v) for u in (-1, 0, 1) for v in (-1, 0, 1))


def check_config(enc: dict) -> None:
    """Raise unless the encoder settings are ones this reference states."""
    want = dict(format_version=4, intra_slice_mbrows=0, quant_bias=8,
                gop_devices=1, tile_devices=1)
    off = {k: enc.get(k, v) for k, v in want.items() if enc.get(k, v) != v}
    cqpo = enc.get("chroma_qp_offset", 0)
    if (off or not isinstance(cqpo, int) or not -12 <= cqpo <= 12
            or enc.get("quant_matrix", False) not in (False, True)
            or enc.get("search", "full") not in v1.SEARCH_ID
            or enc.get("rc", "none") not in ("none", "mb")):
        raise ValueError(f"the format-4 reference does not state {off or enc}")


def stream_header(enc: dict, frame_count: int) -> bytes:
    """SPEC.md §8 stream header of a format-4 stream: version 4, the chroma
    qp offset in the flags' high byte (§12.1), the quant matrix in flags
    bit 1 (§13.2), and the extension word (§13.3, §14.5), 0 intra-slice
    rows. The config hash is the CRC32 of the canonical string, which from
    format 2 on names the version and the offset, and the matrix when
    it is on."""
    check_config(enc)
    cqpo, qmat = enc.get("chroma_qp_offset", 0), enc.get("quant_matrix", False)
    canon = (f"tvc1:w={enc['width']}:h={enc['height']}:gop={enc['gop_n']}"
             f":qp={enc['base_qp']}:search={enc['search']}:rc={enc['rc']}"
             f":kbps={enc.get('target_kbps', 0)}"
             f":fps={enc.get('fps_num', 30)}/{enc.get('fps_den', 1)}"
             f":v=4:cqpo={cqpo}" + (":qm=1" if qmat else ""))
    flags = int(enc["gop_n"] == 1) | (2 if qmat else 0) | ((cqpo & 0xFF) << 8)
    return struct.pack("<4sHHHHHBBII", b"TVC1", 4, flags, enc["width"],
                       enc["height"], enc["gop_n"], enc["base_qp"],
                       v1.SEARCH_ID[enc["search"]], frame_count,
                       zlib.crc32(canon.encode()) & 0xFFFFFFFF
                       ) + struct.pack("<I", 0)


# ---- half-pel motion (SPEC.md §14) -----------------------------------------

def parity_planes(p: torch.Tensor) -> torch.Tensor:
    """[4, H, W]: p and its H, V, D planes (§14.2), the +1 reads clamped to
    the last row and column, in the order (fy, fx) = (0, 0), (0, 1),
    (1, 0), (1, 1)."""
    h, w = p.shape
    right = torch.arange(1, w + 1, device=p.device).clamp(max=w - 1)
    down = torch.arange(1, h + 1, device=p.device).clamp(max=h - 1)
    a, b = p, p[:, right]
    c, d = p[down], p[down][:, right]
    return torch.stack([a, (a + b + 1) >> 1, (a + c + 1) >> 1,
                        (a + b + c + d + 2) >> 2])


def padded_parities(p: torch.Tensor, r: int) -> torch.Tensor:
    """[4, H + 2r, W + 2r]: each parity plane edge-replicated by r (§14.2:
    the padding applies to the parity plane itself)."""
    return torch.stack([v1.pad_edge(q, r) for q in parity_planes(p.long())])


def fetch_hpel(planes: torch.Tensor, d2y, d2x, bs: int, r: int):
    """Blocks [nby, nbx, bs, bs] at per-block half-pel vectors: sample
    (i, j) of block (by, bx) is P[r + by bs + iy + i, r + bx bs + ix + j]
    of the padded parity plane P that (fy, fx) selects, iy = d2y >> 1 and
    fy = d2y & 1 (an arithmetic shift: floor)."""
    nby, nbx = d2y.shape
    dev = planes.device
    ii = torch.arange(bs, device=dev)
    sel = ((d2y & 1) * 2 + (d2x & 1))[:, :, None, None]
    rows = (r + torch.arange(nby, device=dev)[:, None, None, None] * bs
            + (d2y >> 1)[:, :, None, None] + ii[None, None, :, None])
    cols = (r + torch.arange(nbx, device=dev)[None, :, None, None] * bs
            + (d2x >> 1)[:, :, None, None] + ii[None, None, None, :])
    return planes[sel, rows, cols]


def hpel_refine(cur: torch.Tensor, planes: torch.Tensor, dy, dx):
    """§14.4 step 2: the nine candidates (2dy + u, 2dx + v) in row-major
    order, SAD of the MB against the interpolated predictor, a component
    beyond ±32 costing +inf, the first minimum winning. (d2y, d2x, sad)."""
    cur_b = v1.blockify(cur.long(), MB)
    best = None
    for k, (u, v) in enumerate(HPEL_STEPS):
        d2y, d2x = 2 * dy + u, 2 * dx + v
        valid = (d2y.abs() <= R2) & (d2x.abs() <= R2)
        pred = fetch_hpel(planes, d2y.clamp(-R2, R2), d2x.clamp(-R2, R2),
                          MB, R)
        sad = (cur_b - pred).abs().sum((2, 3))
        key = torch.where(valid, sad, FAR) * 16 + k
        best = key if best is None else torch.minimum(best, key)
    u, v = (torch.tensor(HPEL_STEPS, device=cur.device)[best % 16]).unbind(-1)
    return 2 * dy + u, 2 * dx + v, best // 16


# ---- transform, quantizer, reconstruction (§§3-4, §12.2, §13) -------------

def qsteps(qp_blk: torch.Tensor, qmat: bool) -> torch.Tensor:
    """Per-position steps [by, bx, 8, 8] from per-block qps [by, bx]: the
    flat QSTEP, or under the quant matrix max(1, (q QMAT + 8) >> 4)."""
    q = torch.tensor(v1.QSTEP, device=qp_blk.device)[qp_blk]
    q = q[:, :, None, None].expand(-1, -1, BLK, BLK)
    if not qmat:
        return q
    i = torch.arange(BLK, device=qp_blk.device)
    m = 16 + 2 * (i[:, None] + i[None, :])
    m[0, 0] = 16
    return ((q * m + 8) >> 4).clamp(min=1)


def code_plane(cur, pred, q, dtype):
    """One plane [h, W] against its predictor [h, W] at per-position steps
    q [h/8, W/8, 8, 8]: residual, ITX8, midpoint quantizer, dequantizer,
    inverse, clipped recon. (levels in zigzag order [h/8, W/8, 64],
    recon [h, W])."""
    c = v1.forward_transform(v1.blockify(cur - pred, BLK), dtype)
    mag = (2 * c.abs() + q) // (2 * q)
    levels = torch.where(c < 0, -mag, mag)
    rec = (v1.unblockify(v1.inverse_transform(levels * q, dtype))
           + pred).clamp(0, 255)
    zz = torch.tensor(v1.ZIGZAG, device=cur.device)
    return levels.reshape(*levels.shape[:2], 64)[..., zz], rec


def code_intra_rows(cur, q, dtype):
    """§13.1: the I frame's vertical intra chain over one plane's 8-row
    stripes, each predicted from the recon's last row above it (128 above
    the first stripe)."""
    h, w = cur.shape
    pred = torch.full((BLK, w), 128, dtype=torch.int64, device=cur.device)
    levels, recs = [], []
    for j in range(h // BLK):
        lz, rec = code_plane(cur[j * BLK:(j + 1) * BLK], pred,
                             q[j:j + 1], dtype)
        levels.append(lz)
        recs.append(rec)
        pred = rec[-1:].expand(BLK, w)
    return torch.cat(levels), torch.cat(recs)


def code(cur, pred, qp_mb, is_p: bool, enc: dict, dtype):
    """The three planes at per-MB qps: luma at qp_mb, chroma at qp_mb plus
    the offset (§12.2); an I frame through the row chain, a P frame
    against its predictors. (levels per plane, recon per plane)."""
    qmat = enc.get("quant_matrix", False)
    qp_c = (qp_mb + enc.get("chroma_qp_offset", 0)).clamp(QP_MIN, QP_MAX)
    qp_y = qp_mb.repeat_interleave(2, 0).repeat_interleave(2, 1)
    out = []
    for plane, p, qp in zip(cur, pred, (qp_y, qp_c, qp_c)):
        q = qsteps(qp, qmat)
        out.append(code_plane(plane, p, q, dtype) if is_p
                   else code_intra_rows(plane, q, dtype))
    return [lz for lz, _ in out], [rec for _, rec in out]


# ---- entropy coding (§12.3-12.5) -------------------------------------------

def left(a: torch.Tensor) -> torch.Tensor:
    """a[..., by, bx - 1] along the block grid's columns, 0 at column 0."""
    return F.pad(a[:, :-1], (1, 0))


def block_symbols(lz: torch.Tensor):
    """A plane's per-block codes [by, bx, 129] (values, lengths): cbf,
    se(dc - left dc), ue(nonzero ACs), then (ue(run), se(level)) at each
    nonzero AC, runs counted from zigzag position 1."""
    dc, ac = lz[..., 0], lz[..., 1:]
    nz = ac != 0
    nnz = nz.sum(-1)
    cbf = (dc != 0) | (nnz > 0)
    pos = torch.arange(63, device=lz.device)
    last = torch.cummax(torch.where(nz, pos, -1), -1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], -1)
    run_v, run_l = v1.ue(pos - prev - 1)
    lev_v, lev_l = v1.se(ac)
    pair_v = torch.stack([run_v, lev_v], -1).flatten(-2)
    pair_l = torch.where(nz[..., None], torch.stack([run_l, lev_l], -1),
                         0).flatten(-2)
    dcd_v, dcd_l = v1.se(dc - left(dc))
    cnt_v, cnt_l = v1.ue(nnz)
    head_v = torch.stack([cbf.long(), dcd_v, cnt_v], -1)
    head_l = torch.stack([torch.ones_like(nnz), torch.where(cbf, dcd_l, 0),
                          torch.where(cbf, cnt_l, 0)], -1)
    return torch.cat([head_v, pair_v], -1), torch.cat([head_l, pair_l], -1)


def symbols(levels, qp_delta, is_p: bool, is_inter, d2y, d2x):
    """Every code of a frame in stream order as (values, lengths) [n_mbs,
    778], a zero length where a slot holds no code: per MB the mode, the
    vector difference (x, y) from the left inter MB's and the qp delta,
    then its six blocks Y00, Y08, Y80, Y88, Cb, Cr."""
    nby, nbx = qp_delta.shape
    n = nby * nbx
    zero = torch.zeros_like(qp_delta)
    if is_p:
        both = is_inter & left(is_inter)
        mvd_x = d2x - torch.where(both, left(d2x), 0)
        mvd_y = d2y - torch.where(both, left(d2y), 0)
        mode = (torch.where(is_inter, 1, 2), torch.where(is_inter, 1, 3))
        mvx, mvy = v1.se(mvd_x), v1.se(mvd_y)
        mvx = (mvx[0], torch.where(is_inter, mvx[1], 0))
        mvy = (mvy[0], torch.where(is_inter, mvy[1], 0))
    else:
        mode = mvx = mvy = (zero, zero)
    dq = v1.se(qp_delta)
    head_v = torch.stack([mode[0], mvx[0], mvy[0], dq[0]], -1).reshape(n, 4)
    head_l = torch.stack([mode[1], mvx[1], mvy[1], dq[1]], -1).reshape(n, 4)
    (yv, yl), (cbv, cbl), (crv, crl) = (block_symbols(lz) for lz in levels)

    def per_mb(y, cb, cr):
        return torch.stack([y[0::2, 0::2], y[0::2, 1::2], y[1::2, 0::2],
                            y[1::2, 1::2], cb, cr], 2).reshape(n, -1)

    return (torch.cat([head_v, per_mb(yv, cbv, crv)], 1),
            torch.cat([head_l, per_mb(yl, cbl, crl)], 1))


# ---- the GOP ---------------------------------------------------------------

def encode_gop(enc: dict, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               transform=torch.float64):
    """One closed GOP of padded uint8 planes y [T, H, W], cb and cr
    [T, H/2, W/2]: frame 0 intra through the row chain, the rest predicted
    at half-pel vectors from the previous frame's reconstruction; the
    frame qp starts at base_qp and, under rc mb, moves by the proportional
    term of SPEC.md §10 after every frame. Returns (packet bytes per frame,
    sse [T, 3] int64 on the host)."""
    check_config(enc)
    # no product of this file may run in TF32 (float32 products are not
    # used, but a caller's setting is not this reference's to inherit)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_len, h, w = y.shape
    nby, nbx = h // MB, w // MB
    dev = y.device
    target = v1.target_bits(enc)
    search = v1.full_search if enc["search"] == "full" else v1.diamond_search
    qp = enc["base_qp"]
    ref, packets, sse = None, [], []
    for t in range(t_len):
        cur = (y[t].long(), cb[t].long(), cr[t].long())
        is_p = ref is not None
        if is_p:
            dy, dx, _ = search(cur[0], ref[0])
            luma = padded_parities(ref[0], R)
            d2y, d2x, sad = hpel_refine(cur[0], luma, dy, dx)
            inter = sad <= v1.intra_cost(cur[0])
            c2y, c2x = d2y >> 1, d2x >> 1
            m16 = inter.repeat_interleave(MB, 0).repeat_interleave(MB, 1)
            m8 = inter.repeat_interleave(BLK, 0).repeat_interleave(BLK, 1)
            pred = (
                torch.where(m16, v1.unblockify(fetch_hpel(luma, d2y, d2x,
                                                          MB, R)), 128),
                *(torch.where(m8, v1.unblockify(fetch_hpel(
                    padded_parities(p, BLK), c2y, c2x, BLK, BLK)), 128)
                  for p in ref[1:]))
        else:
            d2y = d2x = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
            inter = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
            pred = (None, None, None)
        qp_mb = torch.full((nby, nbx), qp, dtype=torch.int64, device=dev)
        if enc["rc"] == "mb":     # pass 1 at the flat qp sets per-MB offsets
            lz, _ = code(cur, pred, qp_mb, is_p, enc, transform)
            _, lens = symbols(lz, qp_mb - qp, is_p, inter, d2y, d2x)
            est = lens.sum(1).reshape(nby, nbx)
            qp_mb = (qp + v1.mb_rc_offsets(est)).clamp(QP_MIN, QP_MAX)
        lz, rec = code(cur, pred, qp_mb, is_p, enc, transform)
        payload, nbits = v1.pack(*symbols(lz, qp_mb - qp, is_p, inter, d2y,
                                          d2x))
        packets.append(struct.pack("<BBHI", int(is_p), qp, 0, nbits) + payload)
        sse.append(torch.stack([((c - r) ** 2).sum() for c, r in zip(cur, rec)]))
        if target > 0:
            delta = max(-2, min(2, ((nbits - target) * 4) // target))
            qp = max(QP_MIN, min(QP_MAX, qp + delta))
        ref = rec
    return packets, torch.stack(sse).cpu()
