"""Device-side entropy pack of a frame (SPEC.md §6-7, §12).

Twin of `video_encoder_tpu/codec/entropy.py` for the format-1 syntax and
the format-2 syntax (left-MV prediction and DC DPCM, which formats 3 and
4 share), with both emits: frame (`pack_frame_planes`) and chunks
(`pack_frame_chunks`, span strings the host glues; `codec/pack.py`). Every
symbol's (value, length) is computed in parallel, each 8x8 block is
packed into its own MSB-first word string (`block_pack`, a kernel on the
GPU), and the frame payload is assembled from the per-MB pieces (header,
Y00, Y01, Y10, Y11, Cb, Cr) by `frame_concat`: an exclusive prefix sum of
the piece bit lengths, then one shifted add per piece word into the two
target words it straddles. Disjoint bit ranges make add equal to or, so
the bytes equal the reference's `tree_concat`.

Words are int64 tensors holding 32-bit values: torch has no uint32
shifts on the CPU.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
HEADER_SLOTS = 4
HEADER_WORDS = 2  # header <= 3 + 11 + 11 + 13 = 38 bits
# Worst-case bits per MB: mode(3) + mv(2*11) + qp_delta(13)
#   + 6 * (cbf(1) + nnz(13) + 64 * (run(13) + level(25))) = 14714
MAX_MB_BITS = 3 + 22 + 13 + 6 * (1 + 13 + 64 * (13 + 25))
BLOCK_WORDS_DEFAULT = 24  # 768 bits per 8x8 block
BLOCK_WORDS_MAX = (1 + 13 + 64 * (13 + 25) + 31) // 32 + 1  # exact worst case


def capacity_words(n_mbs: int) -> int:
    """Budgeted payload capacity of a frame, 1024 bits per MB; overflow
    triggers the exact worst-case rerun."""
    return (n_mbs * 1024 + 31) // 32 + 2


def max_words(n_mbs: int) -> int:
    """Worst-case word count for a frame of n_mbs macroblocks."""
    return (n_mbs * MAX_MB_BITS + 31) // 32 + 1


def bitlen(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) + 1 for 1 <= x < 2^32, 0 for x == 0 (int64)."""
    x = x.long()
    out = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        out = torch.where(big, out + shift, out)
        x = torch.where(big, x >> shift, x)
    return out + (x > 0).long()


def ue_code(v: torch.Tensor):
    """(value, length) of ue(v): value v+1 in 2*bitlen(v+1)-1 bits."""
    vp1 = v.long() + 1
    return vp1, 2 * bitlen(vp1) - 1


def se_code(v: torch.Tensor):
    """(value, length) of se(v) = ue(2v-1 if v > 0 else -2v)."""
    v = v.long()
    return ue_code(torch.where(v > 0, 2 * v - 1, -2 * v))


def _run_level_symbols(coefs: torch.Tensor):
    """(ue(run), se(level)) pairs of a scan [..., n], runs counted from its
    first position, length 0 where the coefficient is zero: (nonzero count
    [...], pair values [..., 2n], pair lengths [..., 2n])."""
    n = coefs.shape[-1]
    nz = coefs != 0
    idx = torch.arange(n, device=coefs.device)
    masked = torch.where(nz, idx, -1)
    prev_nz = torch.cat(
        [torch.full_like(masked[..., :1], -1),
         torch.cummax(masked, dim=-1).values[..., :-1]], dim=-1)
    run_val, run_len = ue_code(torch.where(nz, idx - prev_nz - 1, 0))
    lev_val, lev_len = se_code(coefs)
    run_len = torch.where(nz, run_len, 0)
    lev_len = torch.where(nz, lev_len, 0)
    lead = coefs.shape[:-1]
    return (nz.sum(-1),
            torch.stack([run_val, lev_val], -1).reshape(*lead, 2 * n),
            torch.stack([run_len, lev_len], -1).reshape(*lead, 2 * n))


def _block_string(head_vals, head_lens, pair_val, pair_len):
    """Symbols [..., S] from leading per-block symbols and the pairs."""
    values = torch.cat([*(v.long()[..., None] for v in head_vals), pair_val], -1)
    lengths = torch.cat([*(l[..., None] for l in head_lens), pair_len], -1)
    return torch.where(lengths > 0, values, 0), lengths


def block_symbols(levels_zz: torch.Tensor):
    """Per-block symbols [..., 130]: cbf, ue(nnz-1), then (ue(run),
    se(level)) at each zigzag position, length 0 where the coefficient is
    zero. Returns (values, lengths), both int64."""
    nnz, pair_val, pair_len = _run_level_symbols(levels_zz)
    cbf = nnz > 0
    nnz_val, nnz_len = ue_code((nnz - 1).clamp(min=0))
    return _block_string(
        (cbf, nnz_val), (torch.ones_like(nnz), torch.where(cbf, nnz_len, 0)),
        pair_val, pair_len)


def block_symbols_v2(levels_zz: torch.Tensor, dc_pred: torch.Tensor):
    """Format-2 per-block symbols [..., 129] (SPEC.md §12.4-12.5): cbf,
    se(dc - dc_pred), ue(nnz_ac), then (ue(run), se(level)) at each AC
    zigzag position 1..63, runs counted from position 1. Returns (values,
    lengths), both int64."""
    dc = levels_zz[..., 0]
    nnz_ac, pair_val, pair_len = _run_level_symbols(levels_zz[..., 1:])
    cbf = (dc != 0) | (nnz_ac > 0)
    dcd_val, dcd_len = se_code(dc - dc_pred)
    nnz_val, nnz_len = ue_code(nnz_ac)
    return _block_string(
        (cbf, dcd_val, nnz_val),
        (torch.ones_like(nnz_ac), torch.where(cbf, dcd_len, 0),
         torch.where(cbf, nnz_len, 0)), pair_val, pair_len)


def _dc_pred_left(levels: torch.Tensor) -> torch.Tensor:
    """Left-block DC predictor of a [by, bx, 64] plane level array: the dc
    level of block (by, bx - 1), 0 at bx = 0 (SPEC.md §12.4). Luma
    predicts across MB boundaries on its [2 nby, 2 nbx] grid."""
    return torch.nn.functional.pad(levels[..., :-1, 0], (1, 0))


def _header_slots(qp_delta, is_p_frame: bool, is_inter, dy, dx,
                  fmt: int = 1):
    """Per-MB header symbols, slot axis leading: ([4, nby, nbx] values,
    lengths) for mode, se(dx), se(dy), se(qp_delta). From format 2 on the
    vectors code as differences from the left MB's when both MBs are
    inter (zero at column 0; SPEC.md §12.3)."""
    mode_val, mode_len = ue_code(torch.where(is_inter, 0, 1))
    inter_p = is_inter & is_p_frame
    if fmt >= 2:
        both = is_inter & torch.nn.functional.pad(is_inter[:, :-1], (1, 0))
        dx = dx - torch.where(both, torch.nn.functional.pad(dx[:, :-1], (1, 0)), 0)
        dy = dy - torch.where(both, torch.nn.functional.pad(dy[:, :-1], (1, 0)), 0)
    dx_val, dx_len = se_code(dx)
    dy_val, dy_len = se_code(dy)
    qpd_val, qpd_len = se_code(qp_delta)
    lengths = torch.stack([
        mode_len * int(is_p_frame),
        torch.where(inter_p, dx_len, 0),
        torch.where(inter_p, dy_len, 0),
        qpd_len,
    ])
    values = torch.stack([mode_val, dx_val, dy_val, qpd_val])
    return torch.where(lengths > 0, values, 0), lengths


def pack_dense(values: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """Pack [..., S] symbol strings MSB-first into [..., n_words] words.

    Returns (words int64 [..., W], bits int32 [...], overflow bool). Bits
    past 32*n_words are dropped; `bits` is the untruncated length. Each
    symbol adds into at most two words (scatter-add; disjoint bit ranges
    make add equal to or)."""
    lead = values.shape[:-1]
    values = values.reshape(-1, values.shape[-1]).long()
    lengths = lengths.reshape(-1, lengths.shape[-1]).long()
    off = torch.cumsum(lengths, -1) - lengths
    bits = off[:, -1] + lengths[:, -1]

    s = off & 31
    fits = (s + lengths) <= 32
    sh1 = torch.where(fits, 32 - s - lengths, lengths - (32 - s)).clamp(0, 31)
    c1 = torch.where(fits, (values << sh1) & MASK32, values >> sh1)
    sh2 = (64 - s - lengths).clamp(0, 31)
    c2 = torch.where(fits, 0, (values << sh2) & MASK32)
    live = lengths > 0
    c1 = torch.where(live, c1, 0)
    c2 = torch.where(live & ~fits, c2, 0)

    w1 = off >> 5
    buf = torch.zeros(values.shape[0], n_words + 1, dtype=torch.int64,
                      device=values.device)
    buf.scatter_add_(1, w1.clamp(max=n_words), c1)
    buf.scatter_add_(1, (w1 + 1).clamp(max=n_words), c2)
    words = buf[:, :n_words].reshape(*lead, n_words)
    bits = bits.reshape(lead).int()
    return words, bits, (bits > 32 * n_words).any()


def pack_header(values: torch.Tensor, lengths: torch.Tensor,
                n_words: int = HEADER_WORDS):
    """pack_dense of slot-leading [S, ...] header symbols."""
    return pack_dense(values.movedim(0, -1), lengths.movedim(0, -1), n_words)


def _pack_blocks(levels: torch.Tensor, block_words: int, fmt: int = 1):
    """Per-block pack of a plane's [by, bx, 64] zigzag level array through
    the dispatch rule (block_pack kernel on the GPU): ([by, bx, W] words,
    [by, bx] bits, overflow). From format 2 on each block's DC codes
    against its left neighbour's."""
    from ..ops import dispatch  # lazy: dispatch imports this module

    lead = levels.shape[:-1]
    dc_pred = (_dc_pred_left(levels).reshape(-1).contiguous() if fmt >= 2
               else None)
    w, b = dispatch.block_pack(levels.reshape(-1, 64), block_words, dc_pred,
                               fmt)
    return (w.reshape(*lead, block_words), b.reshape(lead),
            (b > 32 * block_words).any())


def _mb_sources(levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame,
                is_inter, dy, dx, block_words: int, fmt: int = 1):
    """Per-MB piece sources: words (hw [n_mbs, 2], yw [n_mbs, 4, W], cbw,
    crw [n_mbs, W]), piece bit counts [n_mbs, 7] int32 in the order
    header, Y00, Y01, Y10, Y11, Cb, Cr, and the block overflow flag."""
    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx

    hv, hl = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx, fmt)
    hwords, hbits, ovf_h = pack_header(hv, hl)

    ywords, ybits, ovf_y = _pack_blocks(levels_y8, block_words, fmt)
    ywords = ywords.reshape(nby, 2, nbx, 2, block_words).permute(0, 2, 1, 3, 4)
    ybits = ybits.reshape(nby, 2, nbx, 2).permute(0, 2, 1, 3)
    cbwords, cbbits, ovf_cb = _pack_blocks(levels_cb, block_words, fmt)
    crwords, crbits, ovf_cr = _pack_blocks(levels_cr, block_words, fmt)

    words = (hwords.reshape(n_mbs, HEADER_WORDS),
             ywords.reshape(n_mbs, 4, block_words),
             cbwords.reshape(n_mbs, block_words),
             crwords.reshape(n_mbs, block_words))
    piece_bits = torch.cat([
        hbits.reshape(n_mbs, 1), ybits.reshape(n_mbs, 4),
        cbbits.reshape(n_mbs, 1), crbits.reshape(n_mbs, 1),
    ], 1)
    return words, piece_bits, ovf_h | ovf_y | ovf_cb | ovf_cr


def _frame_pieces(levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame,
                  is_inter, dy, dx, block_words: int, fmt: int = 1):
    """Per-MB piece strings [n_mbs, 7, W] and bit counts [n_mbs, 7] in the
    order header, Y00, Y01, Y10, Y11, Cb, Cr."""
    (hw, yw, cbw, crw), piece_bits, ovf = _mb_sources(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words, fmt)
    hpad = torch.nn.functional.pad(hw[:, None], (0, block_words - HEADER_WORDS))
    piece_words = torch.cat([hpad, yw, cbw[:, None], crw[:, None]], 1)
    return piece_words, piece_bits, ovf


def frame_concat(piece_words: torch.Tensor, piece_bits: torch.Tensor,
                 n_words: int):
    """Concatenate n MSB-first bit strings [n, W] of lengths [n] into one
    [n_words] string (words past n_words dropped). Returns (words int64,
    total_bits int64 scalar tensor).

    Piece p starts at bit off_p (exclusive prefix sum); its word j lands
    shifted right by off_p % 32 in word off_p // 32 + j, and its low bits
    spill into the next word."""
    n, w = piece_words.shape
    bits = piece_bits.long()
    off = torch.cumsum(bits, 0) - bits
    total = off[-1] + bits[-1]
    s = (off & 31)[:, None]
    target = (off >> 5)[:, None] + torch.arange(w, device=off.device)
    hi = piece_words >> s
    lo = (piece_words << (32 - s)) & MASK32   # 0 where s == 0
    out = torch.zeros(n_words + 1, dtype=torch.int64, device=off.device)
    out.index_add_(0, target.clamp(max=n_words).reshape(-1), hi.reshape(-1))
    out.index_add_(0, (target + 1).clamp(max=n_words).reshape(-1),
                   lo.reshape(-1))
    return out[:n_words], total


def pack_frame_planes(levels_y8, levels_cb, levels_cr, qp_delta,
                      is_p_frame: bool, is_inter, dy, dx, block_words: int,
                      n_words: int, fmt: int = 1):
    """Frame payload from per-plane zigzag levels ([2nby, 2nbx, 64] luma,
    [nby, nbx, 64] chroma) in the format-1 syntax, or the format-2 syntax
    for fmt >= 2. Returns (words int64 [n_words], total_bits, mb_bits
    [nby, nbx], overflow)."""
    nby, nbx = qp_delta.shape
    piece_words, piece_bits, ovf = _frame_pieces(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words, fmt,
    )
    words, total = frame_concat(
        piece_words.reshape(-1, block_words), piece_bits.reshape(-1), n_words)
    mb_bits = piece_bits.sum(1, dtype=torch.int32).reshape(nby, nbx)
    return words, total, mb_bits, ovf | (total > 32 * n_words)


def frame_mb_bits(levels_y8, levels_cb, levels_cr, qp_delta,
                  is_p_frame: bool, is_inter, dy, dx, block_words: int,
                  fmt: int = 1):
    """Per-MB bit counts [nby, nbx] int32 (header symbols plus the six
    block strings) with no payload assembled: the rc=mb pass-1 estimate,
    which uses nothing else of the pack."""
    nby, nbx = qp_delta.shape
    _, hl = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx, fmt)
    _, ybits, _ = _pack_blocks(levels_y8, block_words, fmt)
    _, cbbits, _ = _pack_blocks(levels_cb, block_words, fmt)
    _, crbits, _ = _pack_blocks(levels_cr, block_words, fmt)
    ysum = ybits.reshape(nby, 2, nbx, 2).sum((1, 3))
    return (hl.sum(0) + ysum + cbbits + crbits).int()


def chunk_capacity(n_pieces: int, block_words: int) -> tuple[int, int, int]:
    """(n_chunk_strings, pieces_per_chunk_string, words_per_chunk_string)
    for a frame of n_pieces piece strings of block_words words: the
    reference's span geometry (the port's strings carry the budgeted
    width of `pack.span_plan`, at most this)."""
    from . import pack

    _, h, cw, n_strings = pack.span_geometry(n_pieces, block_words)
    return n_strings, h, cw


def pack_frame_chunks(levels_y8, levels_cb, levels_cr, qp_delta,
                      is_p_frame: bool, is_inter, dy, dx, block_words: int,
                      fmt: int = 1):
    """Frame (format-1 syntax, or format-2 for fmt >= 2) as span strings: (chunk_words [C, cw] int64,
    chunk_bits [C] int32, mb_bits [nby, nbx], ovf). The frame payload is
    the host bit-concatenation of the strings in order (`codec/mux.py`),
    the same bytes as pack_frame_planes. The span merge runs through the
    dispatch rule (span_merge_mb, then span_merge in the two-stage shape)
    straight from the per-MB sources; no [n_mbs, 8, W] piece array is
    made."""
    from ..ops import dispatch  # lazy: dispatch imports this module
    from . import pack

    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx
    (hw, yw, cbw, crw), bits7, ovf = _mb_sources(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words, fmt)
    piece_bits = torch.nn.functional.pad(bits7, (0, 1)).reshape(-1)
    plan = pack.span_plan(n_mbs, block_words)
    words, bits, ovf_m = dispatch.span_merge_mb(
        hw.contiguous(), yw.contiguous(), cbw.contiguous(), crw.contiguous(),
        piece_bits, plan.m1, plan.cw1, plan.n1)
    if plan.two_stage:
        words, bits, ovf_2 = dispatch.span_merge(words, bits, plan.g,
                                                 plan.stop, plan.cwf)
        ovf_m = ovf_m | ovf_2
    mb_bits = bits7.sum(1, dtype=torch.int32).reshape(nby, nbx)
    return words, bits, mb_bits, ovf | ovf_m

