"""Numpy golden model of the TVC1 codec (SPEC.md): the port's own copy of
`video_encoder_tpu/codec/golden.py`, kept equal to it by
tests/test_torch_copies.py and tests/test_torch_golden.py.

The executable spec, and the referee for every device implementation:
frame model, SAD, full/diamond/hier motion search, half-pel refinement,
MC, transform, quantizer, zigzag, entropy coding, the reconstruction loop
and the decoder, in plain numpy, independent of the port's PyTorch code
and CUDA kernels. `Frame`, `mb_grid` and `FrameEncodeResult` are
`codec/frame.py`'s, so one `Frame` class flows between the golden,
per-frame and GOP engines. Vectorised over macroblocks but written for
clarity, not speed: it runs on the host's CPU, a 1080p P frame in
seconds.
"""

from __future__ import annotations

import numpy as np

from . import spec
from .bitio import BitReader, BitWriter
from .config import EncoderConfig
from .frame import Frame, FrameEncodeResult, mb_grid

# --------------------------------------------------------------------------
# Motion estimation (C5–C7) and compensation (C8)
# --------------------------------------------------------------------------


def sad_full_search(cur_y: np.ndarray, ref_y: np.ndarray):
    """Full ±16 search (SPEC.md §9). Returns (dy, dx, best_sad) per MB.

    Candidate order: dy outer −16..16, dx inner −16..16; first minimum wins
    (np.argmin first-occurrence over the flattened candidate axis).
    """
    h, w = cur_y.shape
    nby, nbx = h // spec.MB, w // spec.MB
    refpad = spec.pad_ref(ref_y, spec.SEARCH_R)
    r = spec.SEARCH_R
    costs = np.empty((spec.N_CAND, nby, nbx), dtype=np.int64)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = refpad[r + dy : r + dy + h, r + dx : r + dx + w]
            diff = np.abs(cur_y - shifted)
            costs[k] = spec.blockify(diff, spec.MB).sum(axis=(2, 3))
            k += 1
    best = np.argmin(costs, axis=0)  # first occurrence
    best_sad = np.take_along_axis(costs, best[None], axis=0)[0]
    dy = best // (2 * r + 1) - r
    dx = best % (2 * r + 1) - r
    return dy.astype(np.int32), dx.astype(np.int32), best_sad.astype(np.int64)


def sad_at(cur_y: np.ndarray, refpad: np.ndarray, dy: np.ndarray, dx: np.ndarray):
    """SAD per MB at per-MB integer mv (dy, dx); refpad has pad SEARCH_R."""
    h, w = cur_y.shape
    nby, nbx = h // spec.MB, w // spec.MB
    r = spec.SEARCH_R
    my = np.arange(nby)[:, None, None, None] * spec.MB
    mx = np.arange(nbx)[None, :, None, None] * spec.MB
    ii = np.arange(spec.MB)[None, None, :, None]
    jj = np.arange(spec.MB)[None, None, None, :]
    rows = r + my + dy[:, :, None, None] + ii
    cols = r + mx + dx[:, :, None, None] + jj
    pred = refpad[rows, cols]
    cur = spec.blockify(cur_y, spec.MB)
    return np.abs(cur - pred).sum(axis=(2, 3)).astype(np.int64)


def sad_diamond_search(cur_y: np.ndarray, ref_y: np.ndarray):
    """Diamond search w/ early freeze (SPEC.md §9), SPMD-style masked loop.

    Large diamond: per step evaluate [center, (dy-2,dx), (dy,dx-2),
    (dy,dx+2), (dy+2,dx)] (first-min tie-break; out-of-window = +inf);
    freeze an MB when the winner is the center or its SAD < 512; at most 16
    steps. Then one small-diamond (±1) refinement applied to every MB.
    """
    h, w = cur_y.shape
    nby, nbx = h // spec.MB, w // spec.MB
    refpad = spec.pad_ref(ref_y, spec.SEARCH_R)
    dy = np.zeros((nby, nbx), dtype=np.int32)
    dx = np.zeros((nby, nbx), dtype=np.int32)
    cost = sad_at(cur_y, refpad, dy, dx)
    frozen = cost < spec.DIAMOND_EARLY_SAD

    def step(dy, dx, cost, frozen, offsets):
        cand_costs = [cost]
        cand_dy, cand_dx = [dy], [dx]
        for ody, odx in offsets:
            ndy, ndx = dy + ody, dx + odx
            valid = (
                (np.abs(ndy) <= spec.SEARCH_R) & (np.abs(ndx) <= spec.SEARCH_R)
            )
            c = np.where(
                valid,
                sad_at(cur_y, refpad, np.clip(ndy, -16, 16), np.clip(ndx, -16, 16)),
                np.int64(1) << 60,
            )
            cand_costs.append(c)
            cand_dy.append(ndy)
            cand_dx.append(ndx)
        cc = np.stack(cand_costs)  # [5, nby, nbx]
        widx = np.argmin(cc, axis=0)  # first occurrence == candidate order
        wdy = np.take_along_axis(np.stack(cand_dy), widx[None], 0)[0]
        wdx = np.take_along_axis(np.stack(cand_dx), widx[None], 0)[0]
        wcost = np.take_along_axis(cc, widx[None], 0)[0]
        # frozen MBs keep their state
        ndy = np.where(frozen, dy, wdy).astype(np.int32)
        ndx = np.where(frozen, dx, wdx).astype(np.int32)
        ncost = np.where(frozen, cost, wcost)
        moved = (widx != 0) & ~frozen
        return ndy, ndx, ncost, moved

    large = ((-2, 0), (0, -2), (0, 2), (2, 0))
    for _ in range(spec.DIAMOND_MAX_STEPS):
        dy, dx, cost, moved = step(dy, dx, cost, frozen, large)
        frozen = frozen | ~moved | (cost < spec.DIAMOND_EARLY_SAD)
        if frozen.all():
            break
    # Small-diamond refinement for every MB (freeze mask lifted).
    small = ((-1, 0), (0, -1), (0, 1), (1, 0))
    dy, dx, cost, _ = step(dy, dx, cost, np.zeros_like(frozen), small)
    return dy, dx, cost


def sad_hier_search(cur_y: np.ndarray, ref_y: np.ndarray):
    """Hierarchical search (SPEC.md §9 "hier"): a ±HIER_COARSE_R full SAD
    search of each MB's 4×4 block on the 4x-downsampled planes (row-major
    first-min), scaled ×4, then a ±HIER_REFINE_R full-resolution SAD
    refinement (row-major first-min, out-of-window = +inf). ~10x fewer SAD
    evaluations than the full ±16 search with near-identical mv quality.
    """
    h, w = cur_y.shape
    nby, nbx = h // spec.MB, w // spec.MB
    cq = spec.down2(spec.down2(cur_y))
    rq = spec.down2(spec.down2(ref_y))
    rc = spec.HIER_COARSE_R
    nd = 2 * rc + 1
    rqpad = spec.pad_ref(rq, rc)
    hq, wq = cq.shape
    costs = np.empty((nd * nd, nby, nbx), dtype=np.int64)
    k = 0
    for dy in range(-rc, rc + 1):
        for dx in range(-rc, rc + 1):
            shifted = rqpad[rc + dy : rc + dy + hq, rc + dx : rc + dx + wq]
            costs[k] = spec.blockify(np.abs(cq - shifted), 4).sum(axis=(2, 3))
            k += 1
    best = np.argmin(costs, axis=0)  # first occurrence
    cdy = (best // nd - rc).astype(np.int32) * 4
    cdx = (best % nd - rc).astype(np.int32) * 4

    refpad = spec.pad_ref(ref_y, spec.SEARCH_R)
    rr = spec.HIER_REFINE_R
    dy, dx = cdy, cdx
    sad = None
    for _ in range(spec.HIER_REFINE_STEPS):
        cand_costs, cand_dy, cand_dx = [], [], []
        for u in range(-rr, rr + 1):
            for v in range(-rr, rr + 1):
                ndy, ndx = dy + u, dx + v
                valid = (
                    (np.abs(ndy) <= spec.SEARCH_R)
                    & (np.abs(ndx) <= spec.SEARCH_R)
                )
                c = np.where(
                    valid,
                    sad_at(cur_y, refpad,
                           np.clip(ndy, -spec.SEARCH_R, spec.SEARCH_R),
                           np.clip(ndx, -spec.SEARCH_R, spec.SEARCH_R)),
                    np.int64(1) << 60,
                )
                cand_costs.append(c)
                cand_dy.append(ndy)
                cand_dx.append(ndx)
        cc = np.stack(cand_costs)
        widx = np.argmin(cc, axis=0)  # first occurrence == (u, v) row-major
        dy = np.take_along_axis(np.stack(cand_dy), widx[None], 0)[0].astype(np.int32)
        dx = np.take_along_axis(np.stack(cand_dx), widx[None], 0)[0].astype(np.int32)
        sad = np.take_along_axis(cc, widx[None], 0)[0]
    return dy, dx, sad


def mc_fetch(refpad: np.ndarray, dy: np.ndarray, dx: np.ndarray, bs: int, r: int):
    """Predictor blocks [nby, nbx, bs, bs] from a padded plane (C8)."""
    nby, nbx = dy.shape
    my = np.arange(nby)[:, None, None, None] * bs
    mx = np.arange(nbx)[None, :, None, None] * bs
    ii = np.arange(bs)[None, None, :, None]
    jj = np.arange(bs)[None, None, None, :]
    rows = r + my + dy[:, :, None, None] + ii
    cols = r + mx + dx[:, :, None, None] + jj
    return refpad[rows, cols]


def hpel_planes(p: np.ndarray):
    """SPEC.md §14.2 parity planes (H, V, D) on the plane grid, +1 reads
    edge-clamped."""
    b = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)   # p[y, x+1]
    c = np.concatenate([p[1:, :], p[-1:, :]], axis=0)   # p[y+1, x]
    d = np.concatenate([b[1:, :], b[-1:, :]], axis=0)   # p[y+1, x+1]
    return (p + b + 1) >> 1, (p + c + 1) >> 1, (p + b + c + d + 2) >> 2


def mc_fetch_hpel(plane: np.ndarray, d2y: np.ndarray, d2x: np.ndarray,
                  bs: int, r: int):
    """Predictor blocks at half-pel mvs (SPEC.md §14.2): integer mc_fetch
    on the (fy, fx)-selected edge-padded parity plane."""
    hh, vv, dd = hpel_planes(plane)
    iy, ix = d2y >> 1, d2x >> 1
    sel = ((d2y & 1) * 2 + (d2x & 1))[:, :, None, None]
    f = [mc_fetch(spec.pad_ref(pl, r), iy, ix, bs, r)
         for pl in (plane, hh, vv, dd)]
    return np.select([sel == 0, sel == 1, sel == 2], f[:3], f[3])


def sad_hpel_refine(cur_y: np.ndarray, ref_y: np.ndarray,
                    dy: np.ndarray, dx: np.ndarray):
    """SPEC.md §14.4 half-pel refinement: evaluate (2dy+u, 2dx+v) for
    (u, v) in {-1,0,1}^2 row-major, first-minimum; out-of-range = +inf.
    Returns (d2y, d2x, sad) with components in half-pel units."""
    hh, vv, dd = hpel_planes(ref_y)
    pads = {
        (0, 0): spec.pad_ref(ref_y, spec.SEARCH_R),
        (0, 1): spec.pad_ref(hh, spec.SEARCH_R),
        (1, 0): spec.pad_ref(vv, spec.SEARCH_R),
        (1, 1): spec.pad_ref(dd, spec.SEARCH_R),
    }
    r2 = 2 * spec.SEARCH_R
    cand_costs, cand_dy, cand_dx = [], [], []
    for u in (-1, 0, 1):
        for v in (-1, 0, 1):
            d2y, d2x = 2 * dy + u, 2 * dx + v
            valid = (np.abs(d2y) <= r2) & (np.abs(d2x) <= r2)
            iy = np.clip(d2y >> 1, -spec.SEARCH_R, spec.SEARCH_R)
            ix = np.clip(d2x >> 1, -spec.SEARCH_R, spec.SEARCH_R)
            c = np.where(
                valid,
                sad_at(cur_y, pads[(abs(u), abs(v))], iy, ix),
                np.int64(1) << 60,
            )
            cand_costs.append(c)
            cand_dy.append(d2y)
            cand_dx.append(d2x)
    cc = np.stack(cand_costs)
    widx = np.argmin(cc, axis=0)  # first occurrence == (u, v) row-major
    d2y = np.take_along_axis(np.stack(cand_dy), widx[None], 0)[0].astype(np.int32)
    d2x = np.take_along_axis(np.stack(cand_dx), widx[None], 0)[0].astype(np.int32)
    sad = np.take_along_axis(cc, widx[None], 0)[0]
    return d2y, d2x, sad


def intra_cost_and_dc(cur_y: np.ndarray):
    """Per-MB DC and SAD-vs-DC (SPEC.md §9 mode decision / §10 activity)."""
    blocks = spec.blockify(cur_y, spec.MB).astype(np.int64)
    dc = (blocks.sum(axis=(2, 3)) + 128) >> 8
    cost = np.abs(blocks - dc[:, :, None, None]).sum(axis=(2, 3))
    return dc, cost


# --------------------------------------------------------------------------
# Frame encode (C5–C15)
# --------------------------------------------------------------------------


def _assemble_blocks(
    y_blocks: np.ndarray, cb_blocks: np.ndarray, cr_blocks: np.ndarray
) -> np.ndarray:
    """Per-MB 6-block tensor [nby, nbx, 6, 8, 8] in spec block order."""
    nby, nbx = cb_blocks.shape[:2]
    out = np.empty((nby, nbx, 6, 8, 8), dtype=y_blocks.dtype)
    # y_blocks: [2*nby, 2*nbx, 8, 8]; spec order Y00, Y08, Y80, Y88
    out[:, :, 0] = y_blocks[0::2, 0::2]
    out[:, :, 1] = y_blocks[0::2, 1::2]
    out[:, :, 2] = y_blocks[1::2, 0::2]
    out[:, :, 3] = y_blocks[1::2, 1::2]
    out[:, :, 4] = cb_blocks
    out[:, :, 5] = cr_blocks
    return out


def _scatter_blocks(blocks6: np.ndarray):
    """Inverse of _assemble_blocks: → (y_blocks, cb_blocks, cr_blocks)."""
    nby, nbx = blocks6.shape[:2]
    yb = np.empty((2 * nby, 2 * nbx, 8, 8), dtype=blocks6.dtype)
    yb[0::2, 0::2] = blocks6[:, :, 0]
    yb[0::2, 1::2] = blocks6[:, :, 1]
    yb[1::2, 0::2] = blocks6[:, :, 2]
    yb[1::2, 1::2] = blocks6[:, :, 3]
    return yb, blocks6[:, :, 4], blocks6[:, :, 5]


def _predict(cur: Frame, ref: Frame | None, is_inter: np.ndarray, dy, dx,
             hpel: bool = False):
    """Per-MB predictors (luma [nby,nbx,16,16], chroma [nby,nbx,8,8] ×2).

    hpel (SPEC.md §14, format v4): dy/dx are in half-pel units; chroma
    vectors are dy>>1, dx>>1 in chroma half-pel units (§14.3)."""
    nby, nbx = dy.shape
    pred_y = np.full((nby, nbx, spec.MB, spec.MB), 128, dtype=np.int32)
    pred_cb = np.full((nby, nbx, spec.BLK, spec.BLK), 128, dtype=np.int32)
    pred_cr = np.full((nby, nbx, spec.BLK, spec.BLK), 128, dtype=np.int32)
    if ref is not None and is_inter.any():
        cdy, cdx = dy >> 1, dx >> 1
        m = is_inter[:, :, None, None]
        if hpel:
            pred_y = np.where(
                m, mc_fetch_hpel(ref.y, dy, dx, spec.MB, spec.SEARCH_R), pred_y)
            pred_cb = np.where(
                m, mc_fetch_hpel(ref.cb, cdy, cdx, spec.BLK, spec.BLK), pred_cb)
            pred_cr = np.where(
                m, mc_fetch_hpel(ref.cr, cdy, cdx, spec.BLK, spec.BLK), pred_cr)
        else:
            refpad_y = spec.pad_ref(ref.y, spec.SEARCH_R)
            refpad_cb = spec.pad_ref(ref.cb, spec.BLK)
            refpad_cr = spec.pad_ref(ref.cr, spec.BLK)
            pred_y = np.where(m, mc_fetch(refpad_y, dy, dx, spec.MB, spec.SEARCH_R), pred_y)
            pred_cb = np.where(m, mc_fetch(refpad_cb, cdy, cdx, spec.BLK, spec.BLK), pred_cb)
            pred_cr = np.where(m, mc_fetch(refpad_cr, cdy, cdx, spec.BLK, spec.BLK), pred_cr)
    return pred_y, pred_cb, pred_cr


def _q6(qp_mb, chroma_qp_offset=0, quant_matrix=False):
    """Per-block quantizer steps [nby, nbx, 6, 1, 1] ([..., 8, 8] with the
    v3 quant matrix); v2 chroma QP offset (SPEC.md §12.2) applies to blocks
    4-5 only."""
    qp_c = np.clip(qp_mb + chroma_qp_offset, spec.QP_MIN, spec.QP_MAX)
    ql = spec.QSTEP[qp_mb]
    qc = spec.QSTEP[qp_c]
    q6 = np.stack([ql, ql, ql, ql, qc, qc], axis=2)
    return spec.qsteps_pos(q6, quant_matrix)


def _reconstruct(levels_zz, qp_mb, pred_y, pred_cb, pred_cr,
                 chroma_qp_offset=0, quant_matrix=False) -> Frame:
    """Shared encoder/decoder reconstruction (C14): bit-exact by construction."""
    nby, nbx = qp_mb.shape
    q = _q6(qp_mb, chroma_qp_offset, quant_matrix)
    levels = np.zeros((nby, nbx, 6, 64), dtype=np.int32)
    levels[..., spec.ZIGZAG] = levels_zz
    coefs = spec.dequantize(levels.reshape(nby, nbx, 6, 8, 8), q)
    resid = spec.inverse_transform(coefs)
    yb, cbb, crb = _scatter_blocks(resid)
    py = spec.unblockify(pred_y)
    pcb = spec.unblockify(pred_cb)
    pcr = spec.unblockify(pred_cr)
    ry = np.clip(spec.unblockify(yb) + py, 0, 255).astype(np.int32)
    rcb = np.clip(spec.unblockify(cbb) + pcb, 0, 255).astype(np.int32)
    rcr = np.clip(spec.unblockify(crb) + pcr, 0, 255).astype(np.int32)
    return Frame(ry, rcb, rcr)


def encode_frame(
    cfg: EncoderConfig,
    cur: Frame,
    ref: Frame | None,
    frame_type: int,
    base_qp: int,
    _qp_mb: np.ndarray | None = None,
) -> FrameEncodeResult:
    """Encode one frame per SPEC.md §§2–10. frame_type: 0=I, 1=P.

    _qp_mb: internal per-MB qp override (the rc=mb pass-1 probe)."""
    nby, nbx = mb_grid(cur)
    dc, icost = intra_cost_and_dc(cur.y)

    if frame_type == 0:
        is_inter = np.zeros((nby, nbx), dtype=bool)
        dy = np.zeros((nby, nbx), dtype=np.int32)
        dx = np.zeros((nby, nbx), dtype=np.int32)
    else:
        assert ref is not None
        if cfg.search == "full":
            dy, dx, best_sad = sad_full_search(cur.y, ref.y)
        elif cfg.search == "hier":
            dy, dx, best_sad = sad_hier_search(cur.y, ref.y)
        else:
            dy, dx, best_sad = sad_diamond_search(cur.y, ref.y)
        if cfg.format_version >= 4:
            # v4 (SPEC.md §14.4): half-pel refinement; dy/dx become
            # half-pel units from here on (mvd coding included)
            dy, dx, best_sad = sad_hpel_refine(cur.y, ref.y, dy, dx)
        is_inter = best_sad <= icost  # ties → inter (SPEC.md §9)

    if _qp_mb is not None:
        qp_mb = _qp_mb
    elif cfg.rc == "adaptive":
        qp_mb = spec.adaptive_qp(base_qp, icost)
    elif cfg.rc == "mb":
        # per-MB bits feedback (SPEC.md §10.4): pass 1 probes the frame at
        # the flat frame qp; row-local pace offsets set pass-2 quantizers
        flat = np.full((nby, nbx), base_qp, dtype=np.int32)
        est = encode_frame(cfg, cur, ref, frame_type, base_qp, _qp_mb=flat).mb_bits
        qp_mb = np.clip(
            base_qp + spec.mb_rc_offsets(est), spec.QP_MIN, spec.QP_MAX
        ).astype(np.int32)
    else:
        qp_mb = np.full((nby, nbx), base_qp, dtype=np.int32)

    cqpo = cfg.chroma_qp_offset if cfg.format_version >= 2 else 0
    qmat = cfg.format_version >= 3 and cfg.quant_matrix

    if cfg.format_version >= 3 and frame_type == 0:
        # v3 I-frame (SPEC.md §13.1): vertical intra prediction per block
        # row — sequential over the h/8 block rows, vectorized within each
        qp_c = np.clip(qp_mb + cqpo, spec.QP_MIN, spec.QP_MAX)
        qs_y = spec.qsteps_pos(
            np.repeat(np.repeat(spec.QSTEP[qp_mb], 2, 0), 2, 1), qmat
        )
        qs_c = spec.qsteps_pos(spec.QSTEP[qp_c], qmat)
        isl = cfg.intra_slice_mbrows  # §13.3: 0 = one slice per frame
        lv_y, rec_y = spec.intra_rows_code_plane(
            cur.y, qs_y, cfg.quant_bias, 2 * isl)
        lv_cb, rec_cb = spec.intra_rows_code_plane(
            cur.cb, qs_c, cfg.quant_bias, isl)
        lv_cr, rec_cr = spec.intra_rows_code_plane(
            cur.cr, qs_c, cfg.quant_bias, isl)
        levels = _assemble_blocks(lv_y, lv_cb, lv_cr)
        levels_zz = levels.reshape(nby, nbx, 6, 64)[..., spec.ZIGZAG]
        recon = Frame(rec_y, rec_cb, rec_cr)
    else:
        pred_y, pred_cb, pred_cr = _predict(
            cur, ref, is_inter, dy, dx, hpel=cfg.format_version >= 4)

        cur_yb = spec.blockify(cur.y, spec.MB)
        resid_y = spec.blockify(spec.unblockify((cur_yb - pred_y)), spec.BLK)
        resid_cb = spec.blockify(cur.cb, spec.BLK) - pred_cb
        resid_cr = spec.blockify(cur.cr, spec.BLK) - pred_cr
        blocks6 = _assemble_blocks(resid_y, resid_cb, resid_cr)

        q = _q6(qp_mb, cqpo, qmat)
        coefs = spec.forward_transform(blocks6)
        levels = spec.quantize(coefs, q, cfg.quant_bias)
        levels_zz = levels.reshape(nby, nbx, 6, 64)[..., spec.ZIGZAG]

        recon = _reconstruct(levels_zz, qp_mb, pred_y, pred_cb, pred_cr,
                             cqpo, qmat)

    # ---- entropy coding (C12): golden sequential bitwriter ----
    fmt = cfg.format_version
    if fmt >= 2:
        # v2 predictors (SPEC.md §12.3-12.4), vectorized: left-MB mv pred,
        # left-block DC pred on each plane's block grid.
        pred_dx = np.zeros_like(dx)
        pred_dy = np.zeros_like(dy)
        left_ok = np.zeros_like(is_inter)
        left_ok[:, 1:] = is_inter[:, :-1] & is_inter[:, 1:]
        pred_dx[:, 1:] = np.where(left_ok[:, 1:], dx[:, :-1], 0)
        pred_dy[:, 1:] = np.where(left_ok[:, 1:], dy[:, :-1], 0)
        dcy = np.zeros((2 * nby, 2 * nbx), dtype=np.int32)
        for b in range(4):
            dcy[b // 2 :: 2, b % 2 :: 2] = levels_zz[:, :, b, 0]
        dcy_pred = np.zeros_like(dcy)
        dcy_pred[:, 1:] = dcy[:, :-1]
        dcc_pred = np.zeros((nby, nbx, 2), dtype=np.int32)
        dcc_pred[:, 1:, 0] = levels_zz[:, :-1, 4, 0]
        dcc_pred[:, 1:, 1] = levels_zz[:, :-1, 5, 0]

    bw = BitWriter()
    mb_bits = np.zeros((nby, nbx), dtype=np.int64)
    for my in range(nby):
        for mx in range(nbx):
            start = bw.nbits
            inter = bool(is_inter[my, mx])
            if frame_type == 1:
                bw.put_ue(0 if inter else 1)
                if inter:
                    if fmt >= 2:
                        bw.put_se(int(dx[my, mx]) - int(pred_dx[my, mx]))
                        bw.put_se(int(dy[my, mx]) - int(pred_dy[my, mx]))
                    else:
                        bw.put_se(int(dx[my, mx]))
                        bw.put_se(int(dy[my, mx]))
            bw.put_se(int(qp_mb[my, mx]) - base_qp)
            for b in range(6):
                zz = levels_zz[my, mx, b]
                nz = np.nonzero(zz)[0]
                if fmt >= 2:
                    if len(nz) == 0:
                        bw.put(0, 1)
                        continue
                    bw.put(1, 1)
                    if b < 4:
                        pdc = int(dcy_pred[2 * my + b // 2, 2 * mx + b % 2])
                    else:
                        pdc = int(dcc_pred[my, mx, b - 4])
                    bw.put_se(int(zz[0]) - pdc)
                    ac = nz[nz > 0]
                    bw.put_ue(len(ac))
                    prev = 0
                    for pos in ac:
                        bw.put_ue(int(pos - prev - 1))
                        bw.put_se(int(zz[pos]))
                        prev = pos
                    continue
                if len(nz) == 0:
                    bw.put(0, 1)
                    continue
                bw.put(1, 1)
                bw.put_ue(len(nz) - 1)
                prev = -1
                for pos in nz:
                    bw.put_ue(int(pos - prev - 1))
                    bw.put_se(int(zz[pos]))
                    prev = pos
            mb_bits[my, mx] = bw.nbits - start

    return FrameEncodeResult(
        payload=bw.tobytes(),
        payload_bits=bw.nbits,
        recon=recon,
        mb_bits=mb_bits,
        n_intra=int((~is_inter).sum()) if frame_type == 1 else nby * nbx,
        n_inter=int(is_inter.sum()) if frame_type == 1 else 0,
    )


# --------------------------------------------------------------------------
# Frame decode (C16)
# --------------------------------------------------------------------------


def decode_frame(
    width: int,
    height: int,
    frame_type: int,
    base_qp: int,
    payload: bytes,
    payload_bits: int,
    ref: Frame | None,
    version: int = 1,
    chroma_qp_offset: int = 0,
    quant_matrix: bool = False,
    intra_slice: int = 0,
) -> Frame:
    """Decode one frame; reconstruction is bit-exact with the encoder's.

    version=2 parses the SPEC.md §12 syntax (left-MV prediction, DC DPCM,
    chroma QP offset); raster order makes every left predictor available.
    version=3 (SPEC.md §13) shares the v2 syntax; reconstruction adds
    I-frame vertical intra prediction and the optional quant matrix."""
    wp, hp = spec.ceil_to(width, spec.MB), spec.ceil_to(height, spec.MB)
    nby, nbx = hp // spec.MB, wp // spec.MB
    br = BitReader(payload, payload_bits)

    is_inter = np.zeros((nby, nbx), dtype=bool)
    dy = np.zeros((nby, nbx), dtype=np.int32)
    dx = np.zeros((nby, nbx), dtype=np.int32)
    qp_mb = np.zeros((nby, nbx), dtype=np.int32)
    levels_zz = np.zeros((nby, nbx, 6, 64), dtype=np.int32)
    dcy = np.zeros((2 * nby, 2 * nbx), dtype=np.int32)  # v2 DC grids
    dcc = np.zeros((nby, nbx, 2), dtype=np.int32)

    for my in range(nby):
        for mx in range(nbx):
            if frame_type == 1:
                mode = br.get_ue()
                if mode == 0:
                    is_inter[my, mx] = True
                    vx, vy = br.get_se(), br.get_se()
                    if version >= 2 and mx > 0 and is_inter[my, mx - 1]:
                        vx += int(dx[my, mx - 1])
                        vy += int(dy[my, mx - 1])
                    # v4 (SPEC.md §14.1): components in half-pel units
                    mv_r = 2 * spec.SEARCH_R if version >= 4 else spec.SEARCH_R
                    if not (-mv_r <= vx <= mv_r and -mv_r <= vy <= mv_r):
                        raise ValueError(
                            f"corrupt stream: mv ({vy},{vx}) out of range"
                        )
                    dx[my, mx] = vx
                    dy[my, mx] = vy
            qp_mb[my, mx] = base_qp + br.get_se()
            for b in range(6):
                if br.get(1) == 0:
                    continue
                if version >= 2:
                    # predictor = the left block's final DC level, which for
                    # Y(0,8)/Y(8,8) is a block of THIS MB — so the DC grids
                    # update per block, not per MB
                    if b < 4:
                        by, bx = 2 * my + b // 2, 2 * mx + b % 2
                        pdc = int(dcy[by, bx - 1]) if bx > 0 else 0
                    else:
                        pdc = int(dcc[my, mx - 1, b - 4]) if mx > 0 else 0
                    dc = pdc + br.get_se()
                    levels_zz[my, mx, b, 0] = dc
                    if b < 4:
                        dcy[by, bx] = dc
                    else:
                        dcc[my, mx, b - 4] = dc
                    nnz_ac = br.get_ue()
                    pos = 0
                    for _ in range(nnz_ac):
                        pos += br.get_ue() + 1
                        if pos >= 64:
                            raise ValueError(
                                f"corrupt stream: zigzag position {pos} in "
                                f"MB ({my},{mx}) block {b}"
                            )
                        levels_zz[my, mx, b, pos] = br.get_se()
                else:
                    nnz = br.get_ue() + 1
                    pos = -1
                    for _ in range(nnz):
                        pos += br.get_ue() + 1
                        if pos >= 64:
                            raise ValueError(
                                f"corrupt stream: zigzag position {pos} in "
                                f"MB ({my},{mx}) block {b}"
                            )
                        levels_zz[my, mx, b, pos] = br.get_se()

    cqpo = chroma_qp_offset if version >= 2 else 0
    if version >= 3 and frame_type == 0:
        # v3 I-frame (SPEC.md §13.1): vertical-intra row recon
        levels = np.zeros((nby, nbx, 6, 64), dtype=np.int32)
        levels[..., spec.ZIGZAG] = levels_zz
        lv_y, lv_cb, lv_cr = _scatter_blocks(levels.reshape(nby, nbx, 6, 8, 8))
        qp_c = np.clip(qp_mb + cqpo, spec.QP_MIN, spec.QP_MAX)
        qs_y = spec.qsteps_pos(
            np.repeat(np.repeat(spec.QSTEP[qp_mb], 2, 0), 2, 1), quant_matrix
        )
        qs_c = spec.qsteps_pos(spec.QSTEP[qp_c], quant_matrix)
        return Frame(
            spec.intra_rows_recon_plane(lv_y, qs_y, 2 * intra_slice),
            spec.intra_rows_recon_plane(lv_cb, qs_c, intra_slice),
            spec.intra_rows_recon_plane(lv_cr, qs_c, intra_slice),
        )

    # Dummy current frame (only geometry is used by _predict).
    geom = Frame(
        np.zeros((hp, wp), np.int32),
        np.zeros((hp // 2, wp // 2), np.int32),
        np.zeros((hp // 2, wp // 2), np.int32),
    )
    pred_y, pred_cb, pred_cr = _predict(geom, ref, is_inter, dy, dx,
                                        hpel=version >= 4)
    return _reconstruct(levels_zz, qp_mb, pred_y, pred_cb, pred_cr, cqpo,
                        quant_matrix)
