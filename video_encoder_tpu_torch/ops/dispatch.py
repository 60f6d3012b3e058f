"""The one dispatch rule of the port.

Every kernel wrapper launches its CUDA kernel for a CUDA tensor and takes
its plain PyTorch version for a CPU tensor; nothing falls back from the
kernel to the plain version. `force("plain")` routes CUDA tensors to the
plain versions too, so a kernel can be compared with its plain version on
the card (chip_smoke.py); it mirrors the reference's `force("jnp")`.

Planes with a leading G axis ([G, H, W]: G GOPs encoded in lockstep) go to
the G-batched kernels, one launch for all G, or on the CPU to the same
plain versions, which take the axis as it is. The block pack, the frame
pack's tail and the span merges have no batched twin: their callers fold G
into the row axis, and the tail's strings are the product of the leading
axes.

The `_pre_haloed` functions serve the tile-sharded encode
(`parallel/tiles.py`): the reference plane of a shard already carries its
neighbours' pixels as a halo of rows (and, on a 2-D tile grid, columns).

The successive-elimination full search (TVC_SEA=1) is chosen inside the
kernel wrappers, as the reference chooses it inside its Pallas wrappers:
nothing here reads the variable, and the plain route is the exhaustive
search either way. `sad_map`, `chunk_merge`, `full_search_sea_stats` and
`hier_search` have no caller on an encode path, in the port as in the
reference (`GopEngine` refuses search="hier").
"""

from __future__ import annotations

import torch

from ..codec import entropy, pack
from . import motion, transform
from .kernels import assemble as kasm
from .kernels import codec as kcodec
from .kernels import entropy_pack as kpack
from .kernels import pack as kspan
from .kernels import sad as ksad

_FORCE: str | None = None  # None | "plain"


def force(mode: str | None) -> None:
    global _FORCE
    if mode not in (None, "plain"):
        raise ValueError(f"unknown dispatch mode {mode!r}")
    _FORCE = mode


def full_search(cur_y, ref_y):
    """(dy, dx, sad) [(G,) nby, nbx] of planes [(G,) H, W]."""
    if _FORCE == "plain":
        return motion.full_search(cur_y, ref_y)
    if cur_y.ndim == 3:
        return ksad.full_search_g(cur_y, ref_y)
    return ksad.full_search(cur_y, ref_y)


def full_search_pre_haloed(cur_y, ref_ext):
    """(dy, dx, sad) [(B,) nby, nbx] of a shard [(B,) h, w] against its
    pre-haloed reference [(B,) h + 32, w or w + 32]."""
    if _FORCE == "plain":
        return motion.full_search_pre_haloed(cur_y, ref_ext)
    return ksad.full_search_pre_haloed(cur_y, ref_ext)


def mc_fetch_pre_haloed(ref_ext, dy, dx, bs: int, r: int):
    """[(B,) h, w] predictor of a shard from its pre-haloed reference
    [(B,) h + 2r, w or w + 2r]: (bs, r) = (16, 16) luma, (8, 8) chroma."""
    if _FORCE == "plain":
        return motion.mc_fetch_pre_haloed(ref_ext, dy, dx, bs, r)
    return ksad.mc_fetch_pre_haloed(ref_ext, dy, dx, bs, r)


def sad_at_mv_pre_haloed(cur_y, ref_ext, dy, dx, plane_of=None):
    """Per-MB SADs of a luma shard at mvs [(B,) (K,) nby, nbx] against a
    pre-haloed reference, or with plane_of a stack [(B,) P, h + 32, .]."""
    if _FORCE == "plain":
        return motion.sad_at_pre_haloed(cur_y, ref_ext, dy, dx, plane_of)
    return ksad.sad_at_mv_pre_haloed(cur_y, ref_ext, dy, dx, plane_of)


def sad_map_even(cur_y, ref_y):
    """[(G,) nby, nbx, 289] SADs of the even-even mvs."""
    if _FORCE == "plain":
        return motion.sad_map_even(cur_y, ref_y)
    if cur_y.ndim == 3:
        return ksad.sad_map_even_g(cur_y, ref_y)
    return ksad.sad_map_even(cur_y, ref_y)


def sad_map(cur_y, ref_y):
    """[(G,) nby, nbx, 1089] SADs of every mv, candidate (dy+16)*33 + dx+16."""
    if _FORCE == "plain":
        return motion.sad_map(cur_y, ref_y)
    if cur_y.ndim == 3:
        return ksad.sad_map_g(cur_y, ref_y)
    return ksad.sad_map(cur_y, ref_y)


def full_search_sea_stats(cur_y, ref_y):
    """(dy, dx, sad, rows) [nby, nbx] of the SEA search of planes [H, W]:
    rows counts the dy rows each MB evaluated exactly."""
    if _FORCE == "plain":
        return motion.full_search_sea(cur_y, ref_y)
    return ksad.full_search_sea_stats(cur_y, ref_y)


def hier_search(cur_y, ref_y):
    """The hierarchical search (SPEC.md §9 "hier") of planes [(G,) H, W]:
    the plain coarse search, then each refine step's 25 candidates in one
    sad_at_mv launch. Returns (dy, dx, sad) int32 [(G,) nby, nbx]."""
    if _FORCE == "plain":
        return motion.hier_search(cur_y, ref_y)

    def refine(dy, dx):
        return sad_at_mv(cur_y, ref_y, dy, dx)
    refine.batched = True
    return motion.hier_search(cur_y, ref_y, refine)


def sad_at_mv(cur_y, ref_y, dy, dx, plane_of=None):
    """Per-MB SADs at mvs [(G,) (K,) nby, nbx]. With plane_of (K ints)
    ref_y is a stack [(G,) P, H, W] and candidate k of [(G,) K, nby, nbx]
    reads ref_y[(g,) plane_of[k]]: still one launch."""
    if _FORCE == "plain":
        return motion.sad_at(cur_y, ref_y, dy, dx, plane_of=plane_of)
    if cur_y.ndim == 3:
        return ksad.sad_at_mv_g(cur_y, ref_y, dy, dx, plane_of)
    return ksad.sad_at_mv(cur_y, ref_y, dy, dx, plane_of)


def sad_at_mv_chroma(cur_c, ref_c, dy, dx):
    """Per-8x8-block SADs of a chroma plane at chroma mvs (|mv| <= 8)."""
    if _FORCE == "plain":
        return motion.sad_at(cur_c, ref_c, dy, dx, 8)
    if cur_c.ndim == 3:
        return ksad.sad_at_mv_chroma_g(cur_c, ref_c, dy, dx)
    return ksad.sad_at_mv_chroma(cur_c, ref_c, dy, dx)


def diamond_search(cur_y, ref_y):
    """Diamond search (SPEC.md §9) as a descent over the even-lattice SAD
    map: one sad_map_even pass, then on the card one launch of the descent
    kernel for the large-diamond walk and the final ±1 step of every MB
    (of every GOP, for planes [G, H, W]). Its plain version, on the CPU
    and under force("plain"), is motion.diamond_descent: the masked loop
    motion.diamond_search_with, every large-diamond candidate a
    torch.gather from the map and the final step's four SADs from
    sad_at. Returns (dy, dx, sad) int32, [(G,) nby, nbx]."""
    meven = sad_map_even(cur_y, ref_y)
    if _FORCE == "plain":
        return motion.diamond_descent(cur_y, ref_y, meven)
    return ksad.diamond_descent(cur_y, ref_y, meven)


def mc_fetch_luma_plane(ref_y, dy, dx):
    """[(G,) H, W] luma predictor plane from per-MB mvs."""
    if _FORCE == "plain":
        return motion.mc_fetch_plane(ref_y, dy, dx, 16)
    if ref_y.ndim == 3:
        return ksad.mc_fetch_plane_g(ref_y, dy, dx)
    return ksad.mc_fetch_plane(ref_y, dy, dx)


def mc_fetch_chroma_plane(ref_c, cdy, cdx):
    """[(G,) H/2, W/2] chroma predictor plane from per-MB chroma mvs."""
    if _FORCE == "plain":
        return motion.mc_fetch_plane(ref_c, cdy, cdx, 8)
    if ref_c.ndim == 3:
        return ksad.mc_fetch_plane_chroma_g(ref_c, cdy, cdx)
    return ksad.mc_fetch_plane_chroma(ref_c, cdy, cdx)


def hpel_refine(cur_y, ref_y, dy, dx, planes=None, sad_fn=None):
    """Half-pel refinement of format 4 (SPEC.md §14.4): the nine
    candidates (2dy+u, 2dx+v), u, v in -1..1 row-major, first minimum.
    Candidate (u, v) has parity (|u|, |v|), so its SAD is an integer-mv
    SAD on that parity plane: one sad_at_mv launch for all nine. A
    candidate beyond ±32 half-pels is invalid (its integer part is
    clipped for the SAD). `planes` is motion.hpel_stack(ref_y),
    [(G,) 4, H, W], made here unless given; `sad_fn` (default sad_at_mv)
    evaluates the candidates on them: the tile-sharded encode passes
    sad_at_mv_pre_haloed with halo-extended planes. Returns (d2y, d2x,
    sad) int32 [(G,) nby, nbx], vectors in half-pels."""
    if planes is None:
        planes = motion.hpel_stack(ref_y)
    sad_fn = sad_fn or sad_at_mv
    r, r2 = motion.R, 2 * motion.R
    uv = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
    k = torch.arange(9, device=cur_y.device)[:, None, None]
    u = torch.div(k, 3, rounding_mode="floor").int() - 1
    v = (k % 3).int() - 1
    d2y = 2 * dy.unsqueeze(-3) + u                     # [(G,) 9, nby, nbx]
    d2x = 2 * dx.unsqueeze(-3) + v
    valid = (d2y.abs() <= r2) & (d2x.abs() <= r2)
    sads = sad_fn(
        cur_y, planes, (d2y >> 1).clamp(-r, r), (d2x >> 1).clamp(-r, r),
        [abs(a) * 2 + abs(b) for a, b in uv])
    # packed int64 key cost * 16 + index: its minimum is the first minimum
    key = torch.where(valid, sads, motion.BIG).long() * 16 + k
    best = key.amin(-3)
    pick = (best & 15).unsqueeze(-3)
    return (d2y.gather(-3, pick).squeeze(-3), d2x.gather(-3, pick).squeeze(-3),
            (best >> 4).int())


def mc_predict(refs, dy, dx, is_inter):
    """(pred_y, pred_cb, pred_cr) of a P frame step, one kernel launch for
    the three planes: refs (luma, cb, cr) are stacks [(G,) P, H, W] and
    [(G,) P, H/2, W/2] of one plane (P = 1) or of the four parity planes
    (P = 4, motion.hpel_stack order, vectors in half-pels); dy, dx
    [(G,) nby, nbx] per MB; an intra MB (is_inter False) predicts 128."""
    if _FORCE == "plain":
        return motion.mc_predict(refs, dy, dx, is_inter)
    return ksad.mc_predict(refs, dy, dx, is_inter)


def mc_predict_pre_haloed(refs_ext, dy, dx, is_inter):
    """mc_predict of shards [(B,) h, w] from pre-haloed reference stacks
    (luma [(B,) P, h + 32, w or w + 32], chroma [(B,) P, h/2 + 16,
    w/2 or w/2 + 16])."""
    if _FORCE == "plain":
        return motion.mc_predict(refs_ext, dy, dx, is_inter, halo=True)
    return ksad.mc_predict_pre_haloed(refs_ext, dy, dx, is_inter)


def code_plane(cur, pred, q_blk, qbias: int = 8, qmat: bool = False):
    """(levels [(G,) H/8, W/8, 64] zigzag order, recon [(G,) H, W]) of
    one plane, or of the planes of G GOPs; qmat applies the v3 quant
    matrix."""
    if _FORCE == "plain":
        return transform.code_plane(cur, pred, q_blk, qbias, qmat)
    if cur.ndim == 3:
        return kcodec.code_plane_g(cur, pred, q_blk, qbias, qmat)
    return kcodec.code_plane(cur, pred, q_blk, qbias, qmat)


def intra_rows_code_plane(cur, q_blk, qbias: int = 8, reset_rows: int = 0,
                          qmat: bool = False):
    """v3 I-frame row scan of one plane [H, W], or of B planes [B, H, W]
    (G GOPs in lockstep, G x S shards): one kernel launch per call on the
    GPU; the plain version walks the [(B,) 8, W] stripes through the plain
    code_plane."""
    if _FORCE == "plain":
        return transform.intra_rows_code_plane(cur, q_blk, qbias, reset_rows,
                                               qmat)
    return kcodec.code_plane_rows(cur, q_blk, qbias, reset_rows, qmat)


def recon_plane(levels_zz, pred, q_blk, qmat: bool = False, out8=None):
    """The decoders' inter recon of one plane [H, W] from zigzag levels
    [H/8, W/8, 64] (int16), pred [H, W] int32 (None: flat 128) and steps
    [H/8, W/8]; with out8 (uint8 [H, W]) the recon is also written there
    as bytes. Returns the recon int32."""
    if _FORCE == "plain":
        return kcodec.to_out8(
            transform.recon_plane(levels_zz, pred, q_blk, qmat), out8)
    return kcodec.recon_plane(levels_zz, pred, q_blk, qmat, out8)


def intra_rows_recon_plane(levels_zz, q_blk, reset_rows: int = 0,
                           qmat: bool = False, out8=None):
    """Format-3/4 I-frame recon of one plane, or of B planes [B, ...]: one
    kernel launch per call on the GPU; the plain version walks the
    [(B,) 8, W] stripes through the plain recon_plane."""
    if _FORCE == "plain":
        return kcodec.to_out8(transform.intra_rows_recon_plane(
            levels_zz, q_blk, reset_rows, qmat), out8)
    return kcodec.recon_plane_rows(levels_zz, q_blk, reset_rows, qmat, out8)


def block_pack(levels_zz, n_words: int, dc_pred=None, fmt: int = 1):
    """Per-block strings in the format-1 syntax, or with fmt >= 2 the
    format-2 syntax against dc_pred [n]: (words [n, W] int32, bits [n]
    int32)."""
    if _FORCE == "plain":
        return kpack.plain_block_pack(levels_zz, n_words, dc_pred, fmt)
    return kpack.block_pack(levels_zz, n_words, dc_pred, fmt)


def frame_assemble(blocks, hdr, is_p_frame: bool, n_words: int,
                   fmt: int = 1, per_row: bool = False):
    """The frame pack's tail: block_pack's outputs of the three planes and
    the MB arrays hdr = (qp_delta, is_inter, dy, dx) to one string per
    leading index (with per_row, per MB row): (words int32, total bits
    int64, mb_bits int32, ovf). Two launches on the GPU (the headers, then
    the placement), for any leading shape."""
    if _FORCE == "plain":
        return entropy.assemble(blocks, hdr, is_p_frame, n_words, fmt,
                                per_row)
    return kasm.frame_assemble(blocks, hdr, is_p_frame, n_words, fmt, per_row)


def mb_headers(block_bits, hdr, is_p_frame: bool, block_words: int,
               fmt: int = 1):
    """Each MB's header words and piece bit counts for the chunk emit's
    merges: (hw, piece_bits, mb_bits, ovf); one launch on the GPU."""
    if _FORCE == "plain":
        return entropy.mb_headers(block_bits, hdr, is_p_frame, block_words,
                                  fmt)
    return kasm.mb_headers(block_bits, hdr, is_p_frame, block_words, fmt)


def mb_bit_totals(block_bits, hdr, is_p_frame: bool, fmt: int = 1):
    """Per-MB bit counts only (rc mb's first pass); one launch on the
    GPU."""
    if _FORCE == "plain":
        return entropy.mb_bit_totals(block_bits, hdr, is_p_frame, fmt)
    return kasm.mb_bit_totals(block_bits, hdr, is_p_frame, fmt)


def span_merge_mb(hw, yw, cbw, crw, piece_bits, m: int, cw: int,
                  n_strings: int):
    """Stage-1 span strings from per-MB piece sources: (words, bits, ovf)."""
    if _FORCE == "plain":
        return pack.span_merge_mb(hw, yw, cbw, crw, piece_bits, m, cw,
                                  n_strings)
    return kspan.span_merge_mb(hw, yw, cbw, crw, piece_bits, m, cw, n_strings)


def span_merge(strings, bits, g: int, stop: int, cw: int):
    """Stage-2 span strings from groups of stage-1 strings."""
    if _FORCE == "plain":
        return pack.span_merge(strings, bits, g, stop, cw)
    return kspan.span_merge(strings, bits, g, stop, cw)


def chunk_merge(words, bits, k: int):
    """Runs of k piece strings [(G,) n, w] -> two half-chunk strings each,
    [(G,) 2n/k, (k/2) * w + 1] and bits [(G,) 2n/k]."""
    if _FORCE == "plain":
        return pack.chunk_merge(words, bits, k)
    return kspan.chunk_merge(words, bits, k)
