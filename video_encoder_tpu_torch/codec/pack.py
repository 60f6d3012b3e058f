"""Span geometry and the plain span merges of the chunk-emit pack.

Twin of `video_encoder_tpu/ops/pallas/pack.py` (`_stage1_k`,
`span_geometry`, `_merge_budget` and the stage widths of
`_super_merge_mb_impl`). A frame's piece strings (8 per MB: header, Y00,
Y01, Y10, Y11, Cb, Cr, empty) are merged into span strings of h pieces;
the host glues a frame's span strings in order (`codec/mux.py`). The
geometry is the reference's, unchanged, so the port's span strings can be
compared with `super_merge_mb`'s one for one:

- single stage (n_pieces <= 3 * k1): strings of h pieces, width `cap`;
- two stages: stage 1 makes strings of m1 = k1/8 pieces (width cw1),
  stage 2 joins each 4 consecutive stage-1 strings (width cwf).

`span_merge_mb` and `span_merge` are the plain versions of the two
kernels in `csrc/span_merge.cu`: each string is the concatenation of its
pieces, placed by an exclusive prefix sum of the piece bit lengths and a
shifted add of each piece word, as `entropy.frame_concat` does.

Overflow rule: `ovf` is set when any OUTPUT string's true bit count
exceeds 32 * its width (cw1, cwf or cap). The reference also checks the
intermediate levels of its pairwise merge (`_reduce_loop`), which a
placement by prefix sum does not have, so the port's flag fires less often
than the reference's, never more. The stream is the same either way: an
overflowing GOP is encoded again at BLOCK_WORDS_MAX, where
`_merge_budget(w) == w` and every width is the exact worst case.

Words are int64 tensors holding 32-bit values; each piece's words past
its bit count are zero (every producer zero-fills), so the pieces' bit
ranges are disjoint and add equals or.
"""

from __future__ import annotations

import dataclasses

import torch

from . import entropy

MASK32 = 0xFFFFFFFF


def _stage1_k(w: int) -> int:
    """Pieces per stage-1 group: <= 1024 and <= 32768 words of input."""
    k = 1024
    while k > 16 and k * w > 32768:
        k //= 2
    return k


def span_geometry(n_pieces: int, w: int):
    """(padded_n, pieces_per_string, words_per_string, n_strings) for
    n_pieces piece strings of w words; idempotent on its own padded_n."""
    k1 = _stage1_k(w)
    if n_pieces > 3 * k1:
        f = 4 * k1
        n2 = -(-n_pieces // f) * f
        cw1 = (k1 // 8) * w + 1
        h = k1 // 2
        return n2, h, 4 * cw1 + 1, n2 // h
    k = 16
    while k * 2 <= n_pieces and k < k1:
        k *= 2
    n2 = -(-n_pieces // k) * k
    if n2 > n_pieces:
        return span_geometry(n2, w)  # geometry OF the padded count
    h = k // 8
    return n2, h, h * w + 1, (n2 // k) * 8


def _merge_budget(w: int) -> int:
    """Words per piece budgeted for spans of >= 64 pieces; w (no budget)
    at the exact worst case."""
    if w >= entropy.BLOCK_WORDS_MAX:
        return w
    return max(w // 4, 2)


@dataclasses.dataclass(frozen=True)
class SpanPlan:
    """The stages of one frame's span merge. Stage 1 makes n1 strings of
    m1 pieces, cw1 words; with two stages, stage 2 joins groups of g
    stage-1 strings into `stop` strings of cwf words."""
    n_strings: int
    m1: int
    cw1: int
    n1: int
    two_stage: bool
    cwf: int
    g: int = 32
    stop: int = 8


def span_plan(n_mbs: int, w: int) -> SpanPlan:
    """The reference's stage shapes and budgeted widths for a frame of
    n_mbs MBs at w words per block (`_super_merge_mb_impl`)."""
    n2, h, cw, n_strings = span_geometry(n_mbs * 8, w)
    bpp_w = _merge_budget(w)
    k1 = _stage1_k(w)
    if h == k1 // 2:  # two-stage shape (single-stage h is always <= k1/8)
        m1 = k1 // 8
        cw1 = m1 * w + 1
        if m1 >= 64:
            cw1 = min(cw1, bpp_w * m1 + 1)
        cwf = min(cw, bpp_w * 4 * m1 + 1) if 4 * m1 >= 64 else cw
        return SpanPlan(n_strings, m1, cw1, n2 // m1, True, cwf)
    cap = min(cw, bpp_w * h + 1) if h >= 64 else cw
    return SpanPlan(n_strings, h, cap, n_strings, False, cap)


def _place(out, cw: int, string, off, words):
    """Add words [P, W] of pieces at bit offsets off [P] of output strings
    string [P] into out [n_strings * (cw + 1)]; words past cw land in each
    string's spill slot cw."""
    p, w = words.shape
    s = (off & 31)[:, None]
    col = (off >> 5)[:, None] + torch.arange(w, device=off.device)
    row = (string * (cw + 1))[:, None]
    hi = words >> s
    lo = (words << (32 - s)) & MASK32   # 0 where s == 0
    out.index_add_(0, (row + col.clamp(max=cw)).reshape(-1), hi.reshape(-1))
    out.index_add_(0, (row + (col + 1).clamp(max=cw)).reshape(-1),
                   lo.reshape(-1))


def _offsets(bits, m: int, n_strings: int):
    """Exclusive in-string prefix sums of piece bits [n] (padded with
    empty pieces to n_strings * m) and each string's total."""
    b = torch.zeros(n_strings * m, dtype=torch.int64, device=bits.device)
    b[:bits.shape[0]] = bits.reshape(-1)
    b = b.reshape(n_strings, m)
    off = torch.cumsum(b, 1) - b
    return off.reshape(-1), b.sum(1)


def _finish(out, totals, n_strings: int, cw: int):
    words = out.reshape(n_strings, cw + 1)[:, :cw]
    bits = totals.int()
    return words, bits, (bits > 32 * cw).any()


def span_merge_mb(hw, yw, cbw, crw, piece_bits, m: int, cw: int,
                  n_strings: int):
    """Per-MB sources -> stage-1 strings. hw [n_mbs, 2], yw [n_mbs, 4, w],
    cbw, crw [n_mbs, w] int64; piece_bits [n_mbs * 8] int32 in piece order
    (0 for the empty 8th piece). String s holds pieces [s*m, (s+1)*m);
    pieces past 8 * n_mbs are empty. Returns (words [n_strings, cw] int64,
    bits [n_strings] int32, ovf)."""
    n_mbs = yw.shape[0]
    dev = yw.device
    off, totals = _offsets(piece_bits, m, n_strings)
    out = torch.zeros(n_strings * (cw + 1), dtype=torch.int64, device=dev)
    mb8 = torch.arange(n_mbs, device=dev)[:, None] * 8
    for slots, words in ((mb8, hw), (mb8 + torch.arange(1, 5, device=dev), yw),
                         (mb8 + 5, cbw), (mb8 + 6, crw)):
        gi = slots.reshape(-1)
        _place(out, cw, gi // m, off[gi], words.reshape(gi.shape[0], -1))
    return _finish(out, totals, n_strings, cw)


def span_merge(strings, bits, g: int, stop: int, cw: int):
    """Groups of g strings [n, w] int64 (bits [n] int32) -> `stop` strings
    per group, each the concatenation of g/stop consecutive inputs.
    Returns (words [n/g*stop, cw] int64, bits int32, ovf)."""
    n = strings.shape[0]
    m = g // stop
    n_strings = n // g * stop
    off, totals = _offsets(bits, m, n_strings)
    out = torch.zeros(n_strings * (cw + 1), dtype=torch.int64,
                      device=strings.device)
    gi = torch.arange(n, device=strings.device)
    _place(out, cw, gi // m, off[:n], strings)
    return _finish(out, totals, n_strings, cw)
