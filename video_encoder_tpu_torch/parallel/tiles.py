"""Tile-parallel (spatially sharded) encode with halo exchange.

Twin of `video_encoder_tpu/parallel/tiles.py`. One frame's MB grid is
sharded along MB rows over the 'tile' axis. Motion search reads reference
pixels up to ±16 px past the shard edge, so each P step extends every
shard of the *reconstruction* by 16-row strips of its neighbours (the
halo), or takes its window out of the whole gathered frame; boundary
shards edge-replicate instead, which keeps the sharded encode
byte-identical to the unsharded one. The TVC1 MB syntax has no
cross-MB-row prediction, so a frame's payload is the bit-concatenation of
the per-shard payloads in tile order (`codec/mux.py` `bit_concat`).

The reference's collectives have two bodies each, chosen by the process
group they are given (`parallel/mesh.py`): `exchange_halo` (ppermute),
`exchange_halo_2d`, `gather_ref` (all_gather) and `psum`. Without a group
every shard lives on one device: the S row shards of a frame are one more
leading axis of each tensor ([.., S, h, w]; B = G * S planes per frame
step for G GOPs in lockstep, g-major), and a collective is a function of
that axis. With a group the mesh spans ranks: each rank holds its own
shard (that axis of size 1) and the collective runs over the group
(batch_isend_irecv, all_gather, all_reduce). The per-shard program is
the reference's, seam for seam, and the same for both.

The 2-D grid ('tr' x 'tc': MB rows and MB columns, format 1 only) shards
[T, H, W] planes into [T, Sr * Sc, h, w] tiles; its halo carries corner
patches from the diagonal neighbours and its pack emits one string per MB
row, so that the host can restore the raster order across column shards.
On one CUDA device its GOP loop (`tile2d_gop_scan`) is one CUDA graph per
`Tile2dKey`, the counterpart of the reference's jitted
`encode_gop_tiled2d`, with the base qp a graph input; over ranks it runs
eagerly (its collectives are gloo's).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..codec import entropy, spec, tables
from ..codec.mux import bit_concat
from ..ops import dispatch, motion
from ..ops.kernels import sad as ksad
from ..pipeline.gop_engine import (GraphCache, _code_frame, _sse,
                                   code_pack_traced, predict_i_traced,
                                   rc_carry_step)
from . import mesh as dmesh
from .mesh import CodecMesh

HALO_Y = tables.SEARCH_R   # 16 luma halo rows
HALO_C = tables.BLK        # 8 chroma halo rows


# ---- the transport: a function of the shard axis, or of a process group --

def exchange_halo(plane: torch.Tensor, halo: int, shard_dim: int = -3,
                  axis: int = 0, group=None) -> torch.Tensor:
    """Shards [.., S, .., h, w] (S at `shard_dim`) -> each extended by
    2 * halo rows (axis 0) or columns (axis 1) with its neighbours'
    boundary strips: the reference's two `ppermute`s along the mesh axis.
    Shard i receives shard i - 1's last rows above and shard i + 1's first
    rows below. Boundary shards replicate their own first or last row,
    which is the unsharded pad_ref. With a group, S is 1 (this rank's
    shard) and the strips travel in one batch_isend_irecv: the last rows to
    group rank i + 1, the first rows to i - 1."""
    if axis == 1:
        return exchange_halo(plane.transpose(-1, -2), halo, shard_dim,
                             group=group).transpose(-1, -2)
    p = plane.movedim(shard_dim, 0)
    top_own = p[..., :1, :].expand(*p.shape[:-2], halo, p.shape[-1])
    bot_own = p[..., -1:, :].expand(*p.shape[:-2], halo, p.shape[-1])
    if group is None:
        top = torch.cat([top_own[:1], p[:-1, ..., -halo:, :]], 0)
        bot = torch.cat([p[1:, ..., :halo, :], bot_own[-1:]], 0)
    else:
        i, n = dmesh.group_rank(group)
        first, last = p[..., :halo, :], p[..., -halo:, :]
        sends = ([(first, i - 1)] if i > 0 else []) + (
            [(last, i + 1)] if i < n - 1 else [])
        recvs = ([(last, i - 1)] if i > 0 else []) + (
            [(first, i + 1)] if i < n - 1 else [])
        got = dmesh.exchange(sends, recvs, group)
        top = got.pop(0) if i > 0 else top_own
        bot = got.pop(0) if i < n - 1 else bot_own
    return torch.cat([top, p, bot], -2).movedim(0, shard_dim)


def exchange_halo_2d(plane: torch.Tensor, halo: int, row_dim: int = -4,
                     col_dim: int = -3, groups=(None, None)) -> torch.Tensor:
    """Tiles [.., Sr, Sc, h, w] -> [.., Sr, Sc, h + 2 halo, w + 2 halo]:
    the row halo along 'tr', then the column halo along 'tc' of the
    row-extended tiles, so the four corner patches arrive from the
    diagonal neighbours (a two-hop corner exchange). groups: the ('tr',
    'tc') process groups of a mesh over ranks."""
    p = exchange_halo(plane, halo, row_dim, axis=0, group=groups[0])
    return exchange_halo(p, halo, col_dim, axis=1, group=groups[1])


def _shard_windows(full: torch.Tensor, n: int, halo: int,
                   only: int | None = None) -> torch.Tensor:
    """[.., n * h, w] -> [.., n, h + 2 halo, w]: shard s's rows of the
    frame with halo rows on both sides, the frame's first and last row
    replicated beyond its edge; with `only`, that shard's window alone
    ([.., 1, h + 2 halo, w])."""
    rows_total = full.shape[-2]
    h = rows_total // n
    rows = torch.arange(-halo, rows_total + halo, device=full.device
                        ).clamp(0, rows_total - 1)
    padded = full[..., rows, :]
    return torch.stack([padded[..., s * h:(s + 1) * h + 2 * halo, :]
                        for s in (range(n) if only is None else [only])], -3)


def _whole_frame(p: torch.Tensor, group):
    """Row shards [.., S, h, w] -> (the frame [.., S * h, w], the shard
    count, this rank's shard index or None): with a group, the frame of
    every rank's shard by all_gather (the reference's tiled all_gather)."""
    own = None
    if group is not None:
        own, _ = dmesh.group_rank(group)
        p = torch.cat(dmesh.all_gather(p.contiguous(), group), -3)
    n = p.shape[-3]
    return p.reshape(*p.shape[:-3], n * p.shape[-2], p.shape[-1]), n, own


def gather_ref(plane: torch.Tensor, halo: int, shard_dim: int = -3,
               group=None) -> torch.Tensor:
    """The all_gather variant of exchange_halo (rows): every shard gets the
    whole frame (the reference's tiled `all_gather`), pads it and slices
    its own rows plus the halo."""
    full, n, own = _whole_frame(plane.movedim(shard_dim, -3), group)
    return _shard_windows(full, n, halo, own).movedim(-3, shard_dim)


def psum(x: torch.Tensor, shard_dim: int = -1, group=None) -> torch.Tensor:
    """Sum over the shard axis: the reference's `psum` along the mesh axis
    (with a group, an all_reduce of this rank's sum)."""
    s = x.sum(shard_dim)
    return s if group is None else dmesh.all_reduce(s, group)


# ---- format 4 half-pel under row sharding (SPEC.md §14) --------------------
#
# Unsharded, the parity planes are made of the whole frame and THEN
# edge-padded (motion.hpel_planes, then pad_ref inside MC and SAD).
# Exchanging a pixel halo and averaging the extended plane would break that
# at the frame's top edge: a replicated row pair averages to p[0], but the
# parity row that pad_ref replicates is (p[0] + p[1] + 1) >> 1. So: a
# one-row pixel halo, boundary-correct local parity rows, then a halo
# exchange of the parity planes themselves.

def _parity_ext(ref: torch.Tensor, halo: int, ref_mode: str,
                shard_dim: int = -3, group=None):
    """Halo-extended parity planes (H, V, D) of row shards [.., S, h, w],
    each [.., S, h + 2 halo, w] and equal to shard s's rows of
    pad_ref(hpel_planes(full frame), halo)."""
    if ref_mode == "halo":
        p1 = exchange_halo(ref, 1, shard_dim, group=group)   # ±1 row for +1 reads
        return tuple(exchange_halo(q[..., 1:-1, :], halo, shard_dim,
                                   group=group)
                     for q in motion.hpel_planes(p1))
    full, n, own = _whole_frame(ref.movedim(shard_dim, -3), group)
    return tuple(_shard_windows(q, n, halo, own).movedim(-3, shard_dim)
                 for q in motion.hpel_planes(full))


def predict_p_tile_traced(cur_y, ref_y, ref_cb, ref_cr, icost, *,
                          n_tile: int, ref_mode: str, fmt: int, group=None):
    """P-frame prediction of B = G * n_tile row shards [B, h, w] (g-major):
    halo exchange, full search (plus the half-pel refine of format 4) and
    MC: the sharded twin of gop_engine.predict_p_traced. The reference
    planes are the shards' reconstructions, not the source. With a group
    (the 'tile' group of a mesh over ranks) n_tile is 1 and the exchange
    runs over the group."""
    fetch = exchange_halo if ref_mode == "halo" else gather_ref

    def over_tiles(fn, plane, halo):   # [B, h, w] -> [B, h + 2 halo, w]
        ext = fn(plane.unflatten(0, (-1, n_tile)), halo, group=group)
        if isinstance(ext, tuple):
            return tuple(e.flatten(0, 1).contiguous() for e in ext)
        return ext.flatten(0, 1).contiguous()

    def parity(plane, halo):
        return over_tiles(lambda p, hl, group: _parity_ext(
            p, hl, ref_mode, group=group), plane, halo)

    exts = tuple(over_tiles(fetch, p, halo) for p, halo in
                 ((ref_y, HALO_Y), (ref_cb, HALO_C), (ref_cr, HALO_C)))
    dy, dx, best_sad = dispatch.full_search_pre_haloed(cur_y, exts[0])
    if fmt >= 4:
        # refine to half-pels against the halo-extended parity planes; the
        # vectors are in half-pels from here on, and MC reads those planes
        refs = tuple(torch.stack((ext, *parity(p, halo)), -3) for ext, p, halo
                     in zip(exts, (ref_y, ref_cb, ref_cr),
                            (HALO_Y, HALO_C, HALO_C)))
        dy, dx, best_sad = dispatch.hpel_refine(
            cur_y, None, dy, dx, refs[0], sad_fn=dispatch.sad_at_mv_pre_haloed)
    else:
        refs = tuple(ext.unsqueeze(-3) for ext in exts)
    is_inter = best_sad <= icost
    return (dy, dx, is_inter,
            *dispatch.mc_predict_pre_haloed(refs, dy, dx, is_inter))


def encode_frame_tile_traced(cur, ref, qp: torch.Tensor, *, is_p: bool,
                             n_tile: int, rc: str, block_words: int,
                             cap_words: int, ref_mode: str = "halo",
                             fmt: int = 1, cqpo: int = 0, qbias: int = 8,
                             qmat: bool = False, islice: int = 0,
                             emit: str = "frame", group=None):
    """One frame step of B = G * n_tile row shards: cur and ref are three
    planes [B, h, w] each (ref None on an I frame), qp the [G] frame qps.
    I frames run no search and no exchange. Every shard codes and packs
    its rows alone (code_pack_traced on the B planes): left-neighbour
    predictors of format >= 2 are row-local, rc mb paces each MB row on
    its own total, and with islice dividing a shard's MB rows the row
    scan of a format >= 3 I frame restarts at every shard's first row as
    it does unsharded. Returns code_pack_traced's tensors per shard
    ([B, ...]) plus frame_bits [G], the sum over a frame's shards (with
    a group, over the group's ranks too)."""
    icost = None
    if is_p or rc == "adaptive":
        _, icost = motion.intra_cost_and_dc(cur[0])
    if is_p:
        pred = predict_p_tile_traced(cur[0], *ref, icost, n_tile=n_tile,
                                     ref_mode=ref_mode, fmt=fmt, group=group)
    else:
        pred = predict_i_traced(*cur)
    dy, dx, is_inter = pred[:3]
    out = code_pack_traced(
        cur, pred[3:], dy, dx, is_inter, is_p, qp.repeat_interleave(n_tile),
        icost, rc=rc, emit=emit, block_words=block_words, cap_words=cap_words,
        fmt=fmt, cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice)
    out["frame_bits"] = psum(out["bits"].unflatten(0, (-1, n_tile)),
                             group=group)
    return out


def tile_gop_scan(y, cb, cr, qp: torch.Tensor, *, n_tile: int, rc: str,
                  block_words: int, cap_words: int, target_bits: int,
                  ref_mode: str = "halo", fmt: int = 1, cqpo: int = 0,
                  qbias: int = 8, vbv_bits: int = 0, qmat: bool = False,
                  islice: int = 0, emit: str = "frame", group=None):
    """The loop over a GOP's frames on row shards: y [T, B, h, w] uint8
    (B = G * n_tile, g-major; chroma [T, B, h/2, w/2]), qp [G] int32.
    Launches only, no host wait (with a group, its collectives). The
    rate-control carry runs on the summed frame bits, so every shard of a
    GOP sees the same next qp and vbv fullness. Each frame's results go
    into [T, ...] tensors made at the first frame's shapes (the body a
    graph captures: gop_parallel.ShardedGopEncoder). Returns [T, G,
    n_tile, ...]: words, bits, n_inter, sse [.., 3], cbits under chunk
    emit; qp [T, G]; ovf [T]."""
    fullness = torch.full_like(qp, spec.vbv_init(vbv_bits), dtype=torch.int64)
    per_shard = ["words", "bits", "n_inter", "sse"]
    if emit == "chunks":
        per_shard.append("cbits")
    keys = per_shard + ["qp", "ovf"]
    n = y.shape[0]
    ref = res = None
    for t in range(n):
        cur = (y[t].to(torch.int32), cb[t].to(torch.int32),
               cr[t].to(torch.int32))
        out = encode_frame_tile_traced(
            cur, ref, qp, is_p=t > 0, n_tile=n_tile, rc=rc,
            block_words=block_words, cap_words=cap_words, ref_mode=ref_mode,
            fmt=fmt, cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice,
            emit=emit, group=group)
        out["qp"] = qp
        if res is None:
            res = {k: out[k].new_empty((n, *out[k].shape)) for k in keys}
        for k in keys:
            res[k][t] = out[k]
        qp, fullness = rc_carry_step(rc, target_bits, vbv_bits, qp, fullness,
                                     out["frame_bits"])
        ref = out["rec"]
    for k in per_shard:
        res[k] = res[k].unflatten(1, (-1, n_tile))
    return res


def check_tile_config(mesh: CodecMesh, height: int, width: int, fmt: int,
                      islice: int) -> int:
    """The per-shard MB rows of a row-sharded frame; raises unless the MB
    rows divide over the 'tile' axis and, from format 3 on, the intra
    slices divide a shard's MB rows (SPEC.md §13.3): the I frame's
    vertical-intra chain then resets at every shard's first row."""
    mesh.check_frame(height, width)
    mb_rows_shard = -(-height // tables.MB) // mesh.shape["tile"]
    if fmt >= 3 and (islice == 0 or mb_rows_shard % islice):
        raise ValueError(
            f"v3 tile sharding needs intra_slice_mbrows dividing the "
            f"per-shard MB rows ({mb_rows_shard}); got islice={islice} "
            "(SPEC.md §13.3)")
    return mb_rows_shard


def _base_qps(base_qp, g: int, device) -> torch.Tensor:
    """[g] int32 frame qps on the device from one qp or one per GOP."""
    qps = [int(base_qp)] * g if np.ndim(base_qp) == 0 else [int(q) for q in base_qp]
    if len(qps) != g:
        raise ValueError(f"{len(qps)} base qps for {g} GOPs")
    return torch.tensor(qps, dtype=torch.int32).to(device)


def encode_gop_tiled(y_u8, cb_u8, cr_u8, base_qp: int, *, mesh: CodecMesh,
                     rc: str, block_words: int, cap_words: int,
                     target_bits: int, ref_mode: str = "halo", fmt: int = 1,
                     cqpo: int = 0, qbias: int = 8, vbv_bits: int = 0,
                     qmat: bool = False, islice: int = 0,
                     emit: str = "frame"):
    """GOP encode with frames row-sharded over the mesh's 'tile' axis:
    y_u8 [T, H, W] uint8 (H/16 divisible by the tile count), chroma
    [T, H/2, W/2]. Format >= 3 needs intra slices dividing the per-shard
    MB rows. Returns tile_gop_scan's tensors without the GOP axis:
    [T, S, ...] per shard, qp [T], ovf [T]. On a mesh over ranks y_u8 is
    this rank's rows [T, H / S, W] and S is 1 in the results."""
    outs = encode_gop_batch_2d(
        y_u8[:, None], cb_u8[:, None], cr_u8[:, None], base_qp, mesh=mesh,
        rc=rc, block_words=block_words, cap_words=cap_words,
        target_bits=target_bits, ref_mode=ref_mode, fmt=fmt, cqpo=cqpo,
        qbias=qbias, vbv_bits=vbv_bits, qmat=qmat, islice=islice, emit=emit)
    return {k: v if k == "ovf" else v[:, 0] for k, v in outs.items()}


def encode_gop_batch_2d(y_u8, cb_u8, cr_u8, base_qp, *, mesh: CodecMesh,
                        rc: str, block_words: int, cap_words: int,
                        target_bits: int, ref_mode: str = "halo",
                        fmt: int = 1, cqpo: int = 0, qbias: int = 8,
                        vbv_bits: int = 0, qmat: bool = False,
                        islice: int = 0, emit: str = "frame"):
    """The fused ('gop', 'tile') program: G GOPs in lockstep, every frame
    in S row shards. y_u8 [T, G, H, W] uint8 with the frame axis leading
    (the port's batch order, gop_engine.run_batch; the reference takes
    [G, T, H, W]), chroma [T, G, H/2, W/2]; base_qp one int or one per
    GOP, or a [G] int32 device tensor (a graph's input). The 'gop' axis
    carries no exchange: GOPs are closed under prediction. Returns
    [T, G, S, ...] per shard: words, bits, n_inter, sse, cbits under
    chunk emit (the host glues a frame's shards in order); qp [T, G];
    ovf [T]. On a mesh over ranks the planes are this rank's block,
    [T, 1, H / S, W]: its GOP and its rows, with S = 1 in the results;
    the exchange and the frame bits' sum run over the rank's 'tile'
    group."""
    t, g, h, w = y_u8.shape
    n_tile = mesh.local("tile")
    if g != mesh.local("gop"):
        raise ValueError(f"{g} GOPs on a mesh of {mesh.shape}")
    check_tile_config(mesh, h * mesh.shape["tile"] // n_tile, w, fmt, islice)

    def shards(p):   # [T, G, H, W] -> [T, G * S, h, W], a view
        p = p.contiguous()
        return p.reshape(t, g * n_tile, p.shape[-2] // n_tile, p.shape[-1])

    qp = (base_qp if isinstance(base_qp, torch.Tensor)
          else _base_qps(base_qp, g, y_u8.device))
    return tile_gop_scan(
        shards(y_u8), shards(cb_u8), shards(cr_u8), qp, n_tile=n_tile, rc=rc,
        block_words=block_words, cap_words=cap_words, target_bits=target_bits,
        ref_mode=ref_mode, fmt=fmt, cqpo=cqpo, qbias=qbias, vbv_bits=vbv_bits,
        qmat=qmat, islice=islice, emit=emit, group=mesh.group("tile"))


# ---- the 2-D tile grid ('tr' x 'tc'), format 1 ----------------------------

def mb_rc_offsets_tile2d(est: torch.Tensor, col_dim: int = -3,
                         group=None) -> torch.Tensor:
    """rc=mb offsets (SPEC.md §10.4) on a column-sharded MB grid, est
    [.., Sc, nby, nbx_local] pass-1 bits: the pace needs each MB row's
    total over all column shards (the reference's `psum` along 'tc') and
    each MB's prefix across the shards to its left (its `all_gather` of
    the per-shard share sums). Equal to gop_engine.mb_rc_offsets of the
    unsharded grid; int32 in [-2, 2]. With a group (the 'tc' group of a
    mesh over ranks) Sc is 1, this rank's column shard."""
    est = est.long().movedim(col_dim, -3)
    sc, nbx_local = est.shape[-3], est.shape[-1]
    c0 = 0
    if group is not None:
        c0, sc = dmesh.group_rank(group)
    dev = est.device
    row_tot = psum(est.sum(-1, keepdim=True), -3, group).unsqueeze(-3
                                                                   ).clamp(min=1)
    share = torch.div(est * 1024, row_tot, rounding_mode="floor")
    share_sum = share.sum(-1, keepdim=True)             # [.., Sc, nby, 1]
    sums = (share_sum if group is None
            else torch.cat(dmesh.all_gather(share_sum, group), -3))
    prefix = (torch.cumsum(sums, -3) - sums)[..., c0:c0 + est.shape[-3], :, :]
    spent = prefix + torch.cumsum(share, -1) - share
    gx = (torch.arange(c0, c0 + est.shape[-3], device=dev)[:, None, None]
          * nbx_local + torch.arange(nbx_local, device=dev))
    plan = torch.div(gx * 1024, sc * nbx_local, rounding_mode="floor")
    return ((spent - plan) >> 7).clamp(-2, 2).int().movedim(-3, col_dim)


def encode_frame_tile2d_traced(cur, ref, qp: torch.Tensor, *, is_p: bool,
                               grid: tuple, rc: str, block_words: int,
                               row_words: int, qbias: int = 8,
                               groups=(None, None)):
    """One frame step of a 2-D tile grid: cur and ref are three planes
    [Sr * Sc, h, w] each (row-major tiles; ref None on an I frame), qp the
    0-dim frame qp. The reference halo comes from the four neighbours and
    the corners (exchange_halo_2d); the pack emits one string per MB row
    of a tile. Format 1 only: the left-MV and DC predictors of format 2
    would cross column-shard boundaries. rc mb probes per tile and paces
    over the whole row (mb_rc_offsets_tile2d). groups: the ('tr', 'tc')
    process groups of a mesh over ranks, whose grid is then (1, 1)."""
    b = cur[0].shape[0]
    icost = None
    if is_p or rc == "adaptive":
        _, icost = motion.intra_cost_and_dc(cur[0])
    if is_p:
        def ext(plane, halo):
            return exchange_halo_2d(plane.unflatten(0, grid), halo,
                                    groups=groups).flatten(0, 1).contiguous()

        ref_ext = (ext(ref[0], HALO_Y), ext(ref[1], HALO_C), ext(ref[2], HALO_C))
        dy, dx, best_sad = dispatch.full_search_pre_haloed(cur[0], ref_ext[0])
        is_inter = best_sad <= icost
        pred = dispatch.mc_predict_pre_haloed(
            tuple(e.unsqueeze(-3) for e in ref_ext), dy, dx, is_inter)
    else:
        dy, dx, is_inter, *pred = predict_i_traced(*cur)
    nby, nbx = dy.shape[-2:]
    qp_b = qp.expand(b)
    qp_mbs = qp_b[:, None, None]
    flat = qp_mbs.expand(b, nby, nbx)
    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(qp_b, icost)
    elif rc == "mb":
        levels, _ = _code_frame(cur, pred, flat, 0, qbias)
        est = entropy.frame_mb_bits(*levels, flat - qp_mbs, is_p, is_inter,
                                    dy, dx, block_words)
        offs = mb_rc_offsets_tile2d(est.unflatten(0, grid),
                                    group=groups[1]).flatten(0, 1)
        qp_mb = (qp_mbs + offs).clamp(tables.QP_MIN, tables.QP_MAX)
    else:
        qp_mb = flat
    levels, rec = _code_frame(cur, pred, qp_mb, 0, qbias)
    words, row_bits, _, ovf = entropy.pack_frame_rows(
        *levels, qp_mb - qp_mbs, is_p, is_inter, dy, dx, block_words,
        row_words)
    tile_bits = row_bits.sum(-1).unflatten(0, grid)
    return dict(words=words, row_bits=row_bits,
                frame_bits=psum(psum(tile_bits, 0, groups[0]), 0, groups[1]),
                ovf=ovf,
                n_inter=is_inter.sum((-2, -1)), rec=rec,
                sse=torch.stack([_sse(c, r) for c, r in zip(cur, rec)], -1))


def tile2d_gop_scan(y, cb, cr, qp: torch.Tensor, *, grid: tuple, rc: str,
                    block_words: int, row_words: int, target_bits: int,
                    qbias: int = 8, vbv_bits: int = 0, groups=(None, None)):
    """The loop over a GOP's frames on a 2-D tile grid: y [T, H, W] uint8
    (this rank's tile over ranks), chroma [T, H/2, W/2], qp the 0-dim int32
    base qp. Launches only, no host wait (over ranks, its collectives).
    Each frame's results go into [T, ...] tensors made at the first
    frame's shapes (the body a graph captures: encode_gop_tiled2d).
    Returns encode_gop_tiled2d's tensors."""
    t = y.shape[0]

    def tiles(p):   # [T, H, W] -> [T, Sr * Sc, h, w]
        ph, pw = p.shape[-2] // grid[0], p.shape[-1] // grid[1]
        return p.reshape(t, grid[0], ph, grid[1], pw).permute(
            0, 1, 3, 2, 4).reshape(t, grid[0] * grid[1], ph, pw).contiguous()

    y, cb, cr = tiles(y), tiles(cb), tiles(cr)
    fullness = torch.full_like(qp, spec.vbv_init(vbv_bits), dtype=torch.int64)
    per_tile = ["words", "row_bits", "n_inter", "sse"]
    keys = per_tile + ["qp", "ovf"]
    ref = res = None
    for k in range(t):
        cur = (y[k].to(torch.int32), cb[k].to(torch.int32),
               cr[k].to(torch.int32))
        out = encode_frame_tile2d_traced(
            cur, ref, qp, is_p=k > 0, grid=grid, rc=rc,
            block_words=block_words, row_words=row_words, qbias=qbias,
            groups=groups)
        out["qp"] = qp
        if res is None:
            res = {n: out[n].new_empty((t, *out[n].shape)) for n in keys}
        for n in keys:
            res[n][k] = out[n]
        qp, fullness = rc_carry_step(rc, target_bits, vbv_bits, qp, fullness,
                                     out["frame_bits"])
        ref = out["rec"]
    for n in per_tile:
        res[n] = res[n].unflatten(1, grid)
    return res


# what a captured 2-D grid loop bakes in (encode_gop_tiled2d)
Tile2dKey = collections.namedtuple(
    "Tile2dKey", "grid rc block_words row_words target_bits qbias vbv_bits "
    "fmt y_shape c_shape sea force")

# device -> the GraphCache of the 2-D grid's graphs on it: process-wide,
# as the reference's jit cache of the free function encode_gop_tiled2d
_TILE2D_CACHES: dict[str, GraphCache] = {}


def tile2d_cache(device) -> GraphCache:
    """The 2-D grid's graphs on a device. A cache of its own: the grid
    packs through entropy.pack_frame_rows (block_pack and frame_concat)
    and runs no span merge, so its graphs need not replay on the stream of
    an engine's, whose merges share one overflow ticket per device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = str(dev)
    if name not in _TILE2D_CACHES:
        _TILE2D_CACHES[name] = GraphCache(f"encode_gop_tiled2d on {name}")
    return _TILE2D_CACHES[name]


def tile2d_graph_key(mesh: CodecMesh, y_shape, c_shape, **static):
    """The key of a 2-D grid GOP's graph: the reference jit's static
    arguments of encode_gop_tiled2d (the grid, rc, block_words,
    row_words, target_bits, qbias, vbv_bits, fmt), the luma and chroma
    shapes, and the routes the wrappers read at every call and a capture
    bakes in (TVC_SEA, read by full_search_pre_haloed, and
    dispatch.force); None on a mesh over ranks, whose collectives a
    capture cannot take. The base qp is an input."""
    if mesh.spans_ranks:
        return None
    return Tile2dKey(grid=(mesh.local("tr"), mesh.local("tc")),
                     y_shape=tuple(y_shape), c_shape=tuple(c_shape),
                     sea=ksad._sea_enabled(), force=dispatch._FORCE, **static)


def encode_gop_tiled2d(y_u8, cb_u8, cr_u8, base_qp: int, *, mesh: CodecMesh,
                       rc: str, block_words: int, row_words: int,
                       target_bits: int, qbias: int = 8, vbv_bits: int = 0,
                       fmt: int = 1):
    """GOP encode with frames sharded over a 2-D ('tr', 'tc') tile grid:
    MB rows over 'tr' and MB columns over 'tc', with a corner-correct
    halo. y_u8 [T, H, W] uint8; H/16 divisible by Sr, W/16 by Sc. Returns
    per tile, frame and local MB row: words [T, Sr, Sc, nby_s, row_words],
    row_bits [T, Sr, Sc, nby_s]; n_inter [T, Sr, Sc], sse [T, Sr, Sc, 3];
    qp [T]; ovf [T], each a tensor of the call's own. assemble_frame_2d
    glues a frame's payload. On a mesh over ranks y_u8 is this rank's
    tile [T, H / Sr, W / Sc] and Sr = Sc = 1 in the results.

    On one CUDA device the loop (tile2d_gop_scan) replays one CUDA graph
    per Tile2dKey from the key's second call on (tile2d_cache; the first
    runs eagerly, a failed capture raises), with base_qp a graph input;
    on the CPU and over ranks it runs eagerly at every call."""
    if fmt != 1:
        raise ValueError(
            f"encode_gop_tiled2d is format v1 only (got fmt={fmt}): v2's "
            "left-MV/DC prediction crosses 'tc' column-shard boundaries and "
            "v4's half-pel is not implemented on the 2-D grid; use the 1-D "
            "row sharding (encode_gop_tiled) for fmt>=2")
    _, h, w = y_u8.shape
    grid = (mesh.local("tr"), mesh.local("tc"))
    mesh.check_frame(h * mesh.shape["tr"] // grid[0],
                     w * mesh.shape["tc"] // grid[1])
    groups = (mesh.group("tr"), mesh.group("tc"))
    static = dict(rc=rc, block_words=block_words, row_words=row_words,
                  target_bits=target_bits, qbias=qbias, vbv_bits=vbv_bits)
    key = tile2d_graph_key(mesh, y_u8.shape, cb_u8.shape, fmt=fmt, **static)
    return tile2d_cache(y_u8.device).launch(
        key, lambda y, cb, cr, qp: tile2d_gop_scan(
            y, cb, cr, qp, grid=grid, groups=groups, **static),
        (y_u8, cb_u8, cr_u8), int(base_qp))


def assemble_frame_2d(words: np.ndarray, row_bits: np.ndarray, t: int
                      ) -> tuple[bytes, int]:
    """Host glue of encode_gop_tiled2d's results (numpy: words
    [T, Sr, Sc, nby_s, row_words], int32 as downloaded or uint32, row_bits
    [T, Sr, Sc, nby_s]): frame t's
    payload is its MB rows in frame order, each row its column shards'
    strings in order."""
    _, sr, sc, nby_s = row_bits.shape
    return bit_concat([(words[t, r, c, row], int(row_bits[t, r, c, row]))
                       for r in range(sr) for row in range(nby_s)
                       for c in range(sc)])
