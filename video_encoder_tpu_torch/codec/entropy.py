"""Device-side entropy pack of a frame (SPEC.md §6-7, §12).

Twin of `video_encoder_tpu/codec/entropy.py` for the format-1 syntax and
the format-2 syntax (left-MV prediction and DC DPCM, which formats 3 and
4 share), with both emits: frame (`pack_frame_planes`) and chunks
(`pack_frame_chunks`, span strings the host glues; `codec/pack.py`). Every
symbol's (value, length) is computed in parallel, each 8x8 block is
packed into its own MSB-first word string (`block_pack`, a kernel on the
GPU), and the frame payload is assembled from the per-MB pieces (header,
Y00, Y01, Y10, Y11, Cb, Cr). That tail goes through the dispatch rule
(`dispatch.frame_assemble`, `mb_headers`, `mb_bit_totals`): on the GPU
two kernel launches (`ops/kernels/assemble.py`), on the CPU its plain
version here (`assemble`): the header symbols (`_header_slots`) packed
into two words per MB (`pack_header`), then `frame_concat`, an exclusive
prefix sum of the piece bit lengths and one shifted add per piece word
into the two target words it straddles. Disjoint bit ranges make add
equal to or, so the bytes equal the reference's `tree_concat`.

Words are int32 tensors holding the reference's uint32 bit patterns, on
the CPU and on the card (torch has no uint32 shifts or adds on the CPU).
A word with bit 31 set is negative, so a right shift of a word goes
through `shift_split`, which shifts logically; int64 appears only inside
a plain function's arithmetic and is narrowed before it leaves. Adds of
disjoint bit ranges never carry, so an int32 add of them equals an or and
never overflows.

The per-frame engine (`pipeline/device_engine.py`) packs as the
reference's does: per-MB symbols (`mb_symbols`) and one dense pack of
the frame (`pack_bits`), no per-block strings.

Every frame-level function also takes the arrays of G GOPs encoded in
lockstep, with a leading G axis on each (levels [G, by, bx, 64], headers
[G, nby, nbx]), and gives for each g what it gives for that frame alone.
Left-neighbour predictors are taken on the [G, ...] grids; then G is
folded into the row axis of `block_pack` and of the span merges, so each
still launches once.
"""

from __future__ import annotations

import torch

from . import tables

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
    """Per-MB header symbols, slot axis leading: ([4, ..., nby, nbx] values,
    lengths) for mode, se(dx), se(dy), se(qp_delta). From format 2 on the
    vectors code as differences from the left MB's when both MBs are
    inter (zero at column 0; SPEC.md §12.3)."""
    mode_val, mode_len = ue_code(torch.where(is_inter, 0, 1))
    inter_p = is_inter & is_p_frame
    if fmt >= 2:
        both = is_inter & torch.nn.functional.pad(is_inter[..., :-1], (1, 0))
        dx = dx - torch.where(both, torch.nn.functional.pad(dx[..., :-1], (1, 0)), 0)
        dy = dy - torch.where(both, torch.nn.functional.pad(dy[..., :-1], (1, 0)), 0)
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


def shift_split(words: torch.Tensor, s: torch.Tensor):
    """int32 words placed at a bit shift s in [0, 32) (broadcast, one per
    string): (hi, lo), each word shifted right by s and its low s bits
    left-aligned in the next word (0 where s == 0). The right shift is
    logical: an int32 `>>` is arithmetic and smears a set bit 31 into the
    top s bits, which a mask clears. No shift is by 32 or by a negative
    count. The shifts and masks of all the strings are one gather of
    `tables.SHIFT`'s columns, each quantity contiguous, so a word takes
    two operations for each of hi and lo."""
    if words.dtype != torch.int32:
        raise TypeError(f"words are int32 holding 32-bit patterns, got "
                        f"{words.dtype}")
    t = tables.load(words.device).SHIFT.index_select(
        1, s.reshape(-1).long()).reshape(4, *s.shape)
    hi = (words >> t[0]) & t[1]
    lo = (words << t[2]) & t[3]
    return hi, lo


def pack_dense(values: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """Pack [..., S] symbol strings MSB-first into [..., n_words] words.

    Returns (words int32 [..., W], bits int32 [...], overflow bool). Bits
    past 32*n_words are dropped; `bits` is the untruncated length. Each
    symbol adds into at most two words (scatter-add; disjoint bit ranges
    make add equal to or, so the int32 adds never overflow). The symbol
    values (below 2^25) are shifted in int64, and each word part is
    narrowed to int32 (modulo 2^32) before the scatter."""
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
    buf = torch.zeros(values.shape[0], n_words + 1, dtype=torch.int32,
                      device=values.device)
    buf.scatter_add_(1, w1.clamp(max=n_words), c1.to(torch.int32))
    buf.scatter_add_(1, (w1 + 1).clamp(max=n_words), c2.to(torch.int32))
    words = buf[:, :n_words].reshape(*lead, n_words)
    bits = bits.reshape(lead).int()
    return words, bits, (bits > 32 * n_words).any()


def pack_bits(values: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """MSB-first pack of flat (value, length) symbol arrays of any shape,
    in row-major order, into one string: (words int32 [n_words], total_bits
    int32). The per-frame engine's pass 2, pack_dense of a single row."""
    words, bits, _ = pack_dense(values.reshape(1, -1), lengths.reshape(1, -1),
                                n_words)
    return words[0], bits[0]


def mb_symbols(levels_zz, qp_delta, is_p_frame: bool, is_inter, dy, dx):
    """The per-frame engine's pass 1 in the format-1 syntax: per-MB symbol
    (values, lengths) [nby, nbx, 4 + 6 * 130], int64, from the MB-ordered
    zigzag levels [nby, nbx, 6, 64] (`assemble_blocks`): mode, se(dx),
    se(dy), se(qp_delta), then each block's cbf, ue(nnz - 1) and (run,
    level) pairs. Length 0 (and value 0) where a symbol is absent."""
    nby, nbx = qp_delta.shape
    hv, hl = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx)
    bv, bl = block_symbols(levels_zz)
    return (torch.cat([hv.movedim(0, -1), bv.reshape(nby, nbx, -1)], -1),
            torch.cat([hl.movedim(0, -1), bl.reshape(nby, nbx, -1)], -1))


def mb_bit_counts(lengths: torch.Tensor) -> torch.Tensor:
    """Per-MB bit totals [nby, nbx] int32 from mb_symbols' lengths."""
    return lengths.sum(-1, dtype=torch.int32)


def pack_header(values: torch.Tensor, lengths: torch.Tensor,
                n_words: int = HEADER_WORDS):
    """pack_dense of slot-leading [S, ...] header symbols."""
    return pack_dense(values.movedim(0, -1), lengths.movedim(0, -1), n_words)


def _pack_blocks(levels: torch.Tensor, block_words: int, fmt: int = 1):
    """Per-block pack of a plane's [..., by, bx, 64] zigzag level array
    through the dispatch rule (block_pack kernel on the GPU, one launch
    on all the leading axes' blocks): ([..., by, bx, W] words, [..., by,
    bx] bits, each a block's untruncated bit count). From format 2 on
    each block's DC codes against its left neighbour's in the same
    plane."""
    from ..ops import dispatch  # lazy: dispatch imports this module

    lead = levels.shape[:-1]
    dc_pred = (_dc_pred_left(levels).reshape(-1).contiguous() if fmt >= 2
               else None)
    w, b = dispatch.block_pack(levels.reshape(-1, 64), block_words, dc_pred,
                               fmt)
    return w.reshape(*lead, block_words), b.reshape(lead)


def _plane_blocks(levels_y8, levels_cb, levels_cr, block_words: int,
                  fmt: int = 1):
    """block_pack of the three planes: ((yw, yb), (cbw, cbb), (crw, crb)),
    luma on its [..., 2 nby, 2 nbx] block grid, chroma on [..., nby,
    nbx]: what the frame pack's tail starts from."""
    return tuple(_pack_blocks(lv, block_words, fmt)
                 for lv in (levels_y8, levels_cb, levels_cr))


def _mb_words(blocks):
    """block_pack's words of the three planes in MB order: yw [..., n_mbs,
    4, W] (Y00, Y01, Y10, Y11), cbw and crw [..., n_mbs, W]."""
    (yw, _), (cbw, _), (crw, _) = blocks
    *lead, by, bx, w = yw.shape
    n_mbs = by * bx // 4
    yw = yw.reshape(*lead, by // 2, 2, bx // 2, 2, w).transpose(-4, -3)
    return (yw.reshape(*lead, n_mbs, 4, w), cbw.reshape(*lead, n_mbs, w),
            crw.reshape(*lead, n_mbs, w))


def mb_headers(block_bits, hdr, is_p_frame: bool, block_words: int,
               fmt: int = 1):
    """The plain version of the frame pack's first launch (`ops/kernels/
    assemble.py`): each MB's header symbols packed into its two words and
    its piece bit counts, from block_pack's bit counts (yb [..., 2 nby,
    2 nbx], cbb, crb [..., nby, nbx]) and the MB arrays hdr = (qp_delta,
    is_inter, dy, dx), each [..., nby, nbx]. Returns (hw [..., n_mbs, 2]
    int32, piece bits [..., n_mbs, 8] int32 in the order header, Y00, Y01,
    Y10, Y11, Cb, Cr, empty, mb_bits [..., nby, nbx] int32, overflow: a
    header or block over its budget)."""
    qp_delta, is_inter, dy, dx = hdr
    yb, cbb, crb = block_bits
    *lead, nby, nbx = qp_delta.shape
    n_mbs = nby * nbx
    hv, hl = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx, fmt)
    hwords, hbits, ovf = pack_header(hv, hl)
    ybits = yb.reshape(*lead, nby, 2, nbx, 2).transpose(-3, -2)
    piece_bits = torch.cat([
        hbits.reshape(*lead, n_mbs, 1), ybits.reshape(*lead, n_mbs, 4),
        cbb.reshape(*lead, n_mbs, 1), crb.reshape(*lead, n_mbs, 1),
        torch.zeros_like(crb).reshape(*lead, n_mbs, 1)], -1)
    for b in block_bits:
        ovf = ovf | (b > 32 * block_words).any()
    mb_bits = piece_bits.sum(-1, dtype=torch.int32).reshape(*lead, nby, nbx)
    return (hwords.reshape(*lead, n_mbs, HEADER_WORDS), piece_bits, mb_bits,
            ovf)


def mb_bit_totals(block_bits, hdr, is_p_frame: bool, fmt: int = 1):
    """The plain version of the lengths-only launch: per-MB bit counts
    [..., nby, nbx] int32 (header symbols plus the six block strings) from
    block_pack's bit counts and the MB arrays hdr, no word packed."""
    qp_delta, is_inter, dy, dx = hdr
    yb, cbb, crb = block_bits
    *lead, nby, nbx = qp_delta.shape
    _, hl = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx, fmt)
    ysum = yb.reshape(*lead, nby, 2, nbx, 2).sum((-3, -1))
    return (hl.sum(0) + ysum + cbb + crb).int()


def mb_sources(blocks, hdr, is_p_frame: bool, block_words: int,
               fmt: int = 1):
    """Per-MB piece sources from block_pack's outputs: words (hw [...,
    n_mbs, 2], yw [..., n_mbs, 4, W], cbw, crw [..., n_mbs, W]), piece bit
    counts [..., n_mbs, 7] int32 in the order header, Y00, Y01, Y10, Y11,
    Cb, Cr, and the overflow flag (one for all leading axes)."""
    hw, piece_bits, _, ovf = mb_headers(tuple(b for _, b in blocks), hdr,
                                        is_p_frame, block_words, fmt)
    return (hw, *_mb_words(blocks)), piece_bits[..., :7], ovf


def _mb_sources(levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame,
                is_inter, dy, dx, block_words: int, fmt: int = 1):
    """mb_sources of the three planes' zigzag levels."""
    return mb_sources(
        _plane_blocks(levels_y8, levels_cb, levels_cr, block_words, fmt),
        (qp_delta, is_inter, dy, dx), is_p_frame, block_words, fmt)


def _pieces(sources, block_words: int):
    """Per-MB piece strings [..., n_mbs, 7, W] of mb_sources' words, the
    header padded to W words."""
    hw, yw, cbw, crw = sources
    hpad = torch.nn.functional.pad(hw.unsqueeze(-2),
                                   (0, block_words - HEADER_WORDS))
    return torch.cat([hpad, yw, cbw.unsqueeze(-2), crw.unsqueeze(-2)], -2)


def _frame_pieces(levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame,
                  is_inter, dy, dx, block_words: int, fmt: int = 1):
    """Per-MB piece strings [..., n_mbs, 7, W] and bit counts [..., n_mbs,
    7] in the order header, Y00, Y01, Y10, Y11, Cb, Cr."""
    sources, piece_bits, ovf = _mb_sources(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words, fmt)
    return _pieces(sources, block_words), piece_bits, ovf


def frame_concat(piece_words: torch.Tensor, piece_bits: torch.Tensor,
                 n_words: int):
    """Concatenate n MSB-first bit strings [..., n, W] int32 of lengths
    [..., n] into one [..., n_words] string per leading index (words past
    n_words dropped). Returns (words int32, total_bits int64 [...]).

    Piece p starts at bit off_p (exclusive prefix sum in int64, restarting
    at every leading index; a frame's stays below 2^31); its word j lands
    shifted right by off_p % 32 in word off_p // 32 + j, and its low bits
    spill into the next word (`shift_split`). String g of G adds into its
    own n_words + 1 slots of one flat int32 buffer, the last of them the
    spill slot; the adds are of disjoint bit ranges, so they equal ors."""
    *lead, n, w = piece_words.shape
    dev = piece_words.device
    bits = piece_bits.long()
    off = torch.cumsum(bits, -1) - bits
    total = off[..., -1] + bits[..., -1]
    target = (off >> 5)[..., None] + torch.arange(w, device=dev)
    hi, lo = shift_split(piece_words, (off & 31)[..., None])
    n_out = 1
    for d in lead:
        n_out *= d
    base = (torch.arange(n_out, device=dev) * (n_words + 1)).reshape(
        *lead, 1, 1) if lead else 0
    out = torch.zeros(n_out * (n_words + 1), dtype=torch.int32, device=dev)
    out.index_add_(0, (base + target.clamp(max=n_words)).reshape(-1),
                   hi.reshape(-1))
    out.index_add_(0, (base + (target + 1).clamp(max=n_words)).reshape(-1),
                   lo.reshape(-1))
    return out.reshape(*lead, n_words + 1)[..., :n_words], total


def assemble(blocks, hdr, is_p_frame: bool, n_words: int, fmt: int = 1,
             per_row: bool = False):
    """The plain version of the frame pack's tail (`ops/kernels/
    assemble.py`, csrc/frame_pack.cu): from block_pack's outputs of the
    three planes (`_plane_blocks`) and the MB arrays hdr = (qp_delta,
    is_inter, dy, dx) to one string per leading index (a frame), or with
    per_row one per MB row: the per-MB headers (`mb_headers`), then
    `frame_concat` of the pieces in MB raster order. Returns (words int32
    [..., (nby,) n_words], total bits int64 [..., (nby)], mb_bits int32
    [..., nby, nbx], overflow: a header or block over its budget, or a
    string over n_words)."""
    *lead, nby, nbx = hdr[0].shape
    block_words = blocks[0][0].shape[-1]
    sources, piece_bits, ovf = mb_sources(blocks, hdr, is_p_frame,
                                          block_words, fmt)
    strings = (*lead, nby) if per_row else tuple(lead)
    words, total = frame_concat(
        _pieces(sources, block_words).reshape(*strings, -1, block_words),
        piece_bits.reshape(*strings, -1), n_words)
    mb_bits = piece_bits.sum(-1, dtype=torch.int32).reshape(*lead, nby, nbx)
    return words, total, mb_bits, ovf | (total > 32 * n_words).any()


def pack_frame_planes(levels_y8, levels_cb, levels_cr, qp_delta,
                      is_p_frame: bool, is_inter, dy, dx, block_words: int,
                      n_words: int, fmt: int = 1):
    """Frame payload from per-plane zigzag levels ([2nby, 2nbx, 64] luma,
    [nby, nbx, 64] chroma) in the format-1 syntax, or the format-2 syntax
    for fmt >= 2: block_pack, then the frame pack's tail through the
    dispatch rule (`dispatch.frame_assemble`: two kernel launches on the
    GPU). Returns (words int32 [n_words], total_bits int64, mb_bits [nby,
    nbx] int32, overflow). With a leading G axis on every array: words
    [G, n_words], total_bits [G], mb_bits [G, nby, nbx], and one overflow
    flag for the batch."""
    from ..ops import dispatch  # lazy: dispatch imports this module

    return dispatch.frame_assemble(
        _plane_blocks(levels_y8, levels_cb, levels_cr, block_words, fmt),
        (qp_delta, is_inter, dy, dx), is_p_frame, n_words, fmt)


def pack_frame_rows(levels_y8, levels_cb, levels_cr, qp_delta,
                    is_p_frame: bool, is_inter, dy, dx, block_words: int,
                    row_words: int):
    """Format-1 pack emitting one bit string per MB row: (row strings
    [..., nby, row_words] int32, row_bits [..., nby] int64, mb_bits
    [..., nby, nbx], overflow). The frame payload is the in-order
    bit-concatenation of the row strings, the bytes of pack_frame_planes.
    The 2-D tile grid needs this granularity: a frame's MB raster order
    interleaves the column shards within each MB row."""
    from ..ops import dispatch  # lazy: dispatch imports this module

    return dispatch.frame_assemble(
        _plane_blocks(levels_y8, levels_cb, levels_cr, block_words),
        (qp_delta, is_inter, dy, dx), is_p_frame, row_words, per_row=True)


def frame_mb_bits(levels_y8, levels_cb, levels_cr, qp_delta,
                  is_p_frame: bool, is_inter, dy, dx, block_words: int,
                  fmt: int = 1):
    """Per-MB bit counts [..., nby, nbx] int32 (header symbols plus the
    six block strings) with no payload assembled: the rc=mb pass-1
    estimate, which uses nothing else of the pack (the lengths-only
    launch on the GPU, `dispatch.mb_bit_totals`)."""
    from ..ops import dispatch  # lazy: dispatch imports this module

    blocks = _plane_blocks(levels_y8, levels_cb, levels_cr, block_words, fmt)
    return dispatch.mb_bit_totals(tuple(b for _, b in blocks),
                                  (qp_delta, is_inter, dy, dx), is_p_frame,
                                  fmt)


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
    """Frame (format-1 syntax, or format-2 for fmt >= 2) as span strings:
    (chunk_words [C, cw] int32, chunk_bits [C] int32, mb_bits [nby, nbx],
    ovf). The frame payload is
    the host bit-concatenation of the strings in order (`codec/mux.py`),
    the same bytes as pack_frame_planes. The span merge runs through the
    dispatch rule (span_merge_mb, then span_merge in the two-stage shape)
    straight from the per-MB sources; no [n_mbs, 8, W] piece array is
    made. The per-MB headers come from the dispatch rule too
    (`dispatch.mb_headers`: the frame pack's first launch on the GPU, its
    header words and piece bit counts).

    With a leading G axis on every array the G frames fold into the row
    axis of both merges, which still launch once each: every frame's MB
    axis is first padded with empty MBs to the plan's n1 * m1 pieces, so
    that no string spans two frames. Returns chunk_words [G, C, cw],
    chunk_bits [G, C], mb_bits [G, nby, nbx] and one flag for the batch."""
    from ..ops import dispatch  # lazy: dispatch imports this module
    from . import pack

    *lead, nby, nbx = qp_delta.shape
    n_mbs = nby * nbx
    blocks = _plane_blocks(levels_y8, levels_cb, levels_cr, block_words, fmt)
    hw, piece_bits, mb_bits, ovf = dispatch.mb_headers(
        tuple(b for _, b in blocks), (qp_delta, is_inter, dy, dx),
        is_p_frame, block_words, fmt)
    yw, cbw, crw = _mb_words(blocks)
    plan = pack.span_plan(n_mbs, block_words)
    n_strings = plan.n1
    if lead:
        g = lead[0]
        extra = plan.n1 * plan.m1 // 8 - n_mbs   # empty MBs up to the plan

        def fold(a):   # [G, n_mbs, ...] -> [G * (n_mbs + extra), ...]
            if extra:
                a = torch.nn.functional.pad(
                    a, [0, 0] * (a.ndim - 2) + [0, extra])
            return a.reshape(-1, *a.shape[2:])

        hw, yw, cbw, crw = fold(hw), fold(yw), fold(cbw), fold(crw)
        piece_bits = fold(piece_bits)
        n_strings = g * plan.n1
    words, bits, ovf_m = dispatch.span_merge_mb(
        hw.contiguous(), yw.contiguous(), cbw.contiguous(), crw.contiguous(),
        piece_bits.reshape(-1), plan.m1, plan.cw1, n_strings)
    if plan.two_stage:
        words, bits, ovf_2 = dispatch.span_merge(words, bits, plan.g,
                                                 plan.stop, plan.cwf)
        ovf_m = ovf_m | ovf_2
    if lead:
        words = words.reshape(g, -1, words.shape[-1])
        bits = bits.reshape(g, -1)
    return words, bits, mb_bits, ovf | ovf_m
