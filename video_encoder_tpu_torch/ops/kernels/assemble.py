"""Wrappers of the frame pack's tail (csrc/frame_pack.cu): from block_pack's
outputs of the three planes and the MB arrays hdr = (qp_delta, is_inter,
dy, dx) to the strings' words, in two launches.

A CPU tensor takes the plain version in `codec/entropy.py` (`assemble`,
`mb_headers`, `mb_bit_totals`); a CUDA tensor launches the kernels, which
are built at first use. Counters: `frame_headers` (the headers, the MB
totals and the tiles' sums, with the strings' zero fill), `frame_place`
(the placement), `frame_mb_bits` (the lengths-only launch).

A string is a run of m MBs in raster order: one per leading index (a
frame), or with per_row one per MB row. Its offsets are an int32 scan, so
a string may hold at most MAX_STRING_MBS MBs: below 2^31 bits at
MB_BITS_BOUND bits an MB.

Words are int32 tensors holding the reference's uint32 bit patterns; the
placement reads each block's words only up to its bit count, so they must
hold zeros past it, as block_pack writes them.
"""

from __future__ import annotations

import math

import torch

from ...codec import entropy
from . import build

# Bits of one MB, above the largest it can take: a header of at most
# 3 + 2 * 15 + 13 bits (format 4's half-pel vector differences) and six
# blocks of at most 1 + 13 + 64 * (13 + 25) bits (|level| <= 3925)
MB_BITS_BOUND = 1 << 14
MAX_STRING_MBS = (2**31 - 1) // MB_BITS_BOUND

_tile = None


def tile() -> int:
    """MBs per tile of the kernels (their tile_info has one entry each)."""
    global _tile
    if _tile is None:
        _tile = build.lib().tvc_frame_pack_tile()
    return _tile


def _check(block_bits, hdr, name: str, words=None):
    """The MB arrays as int32 (is_inter as bool), contiguous, and the
    grid: (hdr, leading shape, nby, nbx)."""
    qpd, inter, dy, dx = hdr
    *lead, nby, nbx = qpd.shape
    mbs = (*lead, nby, nbx)
    hdr = (qpd.to(torch.int32).contiguous(), inter.to(torch.bool).contiguous(),
           dy.to(torch.int32).contiguous(), dx.to(torch.int32).contiguous())
    for t, label in zip(hdr, ("qp_delta", "is_inter", "dy", "dx")):
        build.require(t, t.dtype, mbs, f"{name} {label}")
    yb, cbb, crb = block_bits
    build.require(yb, torch.int32, (*lead, 2 * nby, 2 * nbx), f"{name} luma bits")
    build.require(cbb, torch.int32, mbs, f"{name} cb bits")
    build.require(crb, torch.int32, mbs, f"{name} cr bits")
    if words is not None:
        yw, cbw, crw = words
        w = yw.shape[-1]
        build.require(yw, torch.int32, (*lead, 2 * nby, 2 * nbx, w),
                      f"{name} luma words")
        build.require(cbw, torch.int32, (*mbs, w), f"{name} cb words")
        build.require(crw, torch.int32, (*mbs, w), f"{name} cr words")
    return hdr, tuple(lead), nby, nbx


def _headers(hdr, block_bits, n_strings: int, m: int, nbx: int, w: int,
             is_p_frame: bool, fmt: int, *, hw=None, mb_bits, piece_bits=None,
             tile_info=None, zero=None, ovf=None):
    qpd, inter, dy, dx = hdr
    if not 1 <= w <= entropy.BLOCK_WORDS_MAX:
        raise ValueError(f"frame pack: block words {w} outside [1, "
                         f"{entropy.BLOCK_WORDS_MAX}]")

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = build.lib().tvc_mb_headers(
        qpd.data_ptr(), inter.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        *(b.data_ptr() for b in block_bits), n_strings, m, nbx, w,
        int(is_p_frame), fmt, ptr(hw), mb_bits.data_ptr(), ptr(piece_bits),
        ptr(tile_info), ptr(zero), 0 if zero is None else zero.numel(),
        ptr(ovf), build.stream_ptr(qpd.device))
    build.check(err, "frame_headers")


def frame_assemble(blocks, hdr, is_p_frame: bool, n_words: int, fmt: int = 1,
                   per_row: bool = False):
    """The frame pack's tail: blocks ((yw, yb), (cbw, cbb), (crw, crb)),
    block_pack's words [..., by, bx, W] int32 and bit counts [..., by, bx]
    int32 of the luma and chroma planes; hdr (qp_delta, is_inter, dy, dx)
    [..., nby, nbx]. One string per leading index, or with per_row one per
    MB row, of n_words words. Returns (words [..., (nby,) n_words] int32,
    total bits [..., (nby)] int64, mb_bits [..., nby, nbx] int32, ovf bool:
    a header or block over its budget, or a string over n_words). Two
    launches, whatever the leading shape."""
    if blocks[0][0].device.type == "cpu":
        return entropy.assemble(blocks, hdr, is_p_frame, n_words, fmt, per_row)
    (yw, yb), (cbw, cbb), (crw, crb) = blocks
    hdr, lead, nby, nbx = _check((yb, cbb, crb), hdr, "frame_assemble",
                                 (yw, cbw, crw))
    w = yw.shape[-1]
    n_lead = math.prod(lead)
    n_strings, m = (n_lead * nby, nbx) if per_row else (n_lead, nby * nbx)
    if m > MAX_STRING_MBS:
        raise ValueError(f"frame_assemble: {m} MBs a string pass the int32 "
                         f"scan's {MAX_STRING_MBS}")
    if n_words < 1:
        raise ValueError(f"frame_assemble: {n_words} words a string")
    dev = yw.device
    strings = (*lead, nby) if per_row else lead
    words = torch.empty((*strings, n_words), dtype=torch.int32, device=dev)
    totals = torch.empty(strings, dtype=torch.int64, device=dev)
    mb_bits = torch.empty((*lead, nby, nbx), dtype=torch.int32, device=dev)
    hw = torch.empty((n_lead * nby * nbx, entropy.HEADER_WORDS),
                     dtype=torch.int32, device=dev)
    tile_info = torch.empty((n_strings * -(-m // tile()), 2),
                            dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    _headers(hdr, (yb, cbb, crb), n_strings, m, nbx, w, is_p_frame, fmt,
             hw=hw, mb_bits=mb_bits, tile_info=tile_info, zero=words, ovf=ovf)
    build.LAUNCHES["frame_headers"] += 1
    err = build.lib().tvc_frame_place(
        hw.data_ptr(), yw.data_ptr(), yb.data_ptr(), cbw.data_ptr(),
        cbb.data_ptr(), crw.data_ptr(), crb.data_ptr(), mb_bits.data_ptr(),
        tile_info.data_ptr(), n_strings, m, nbx, w, n_words, words.data_ptr(),
        totals.data_ptr(), ovf.data_ptr(), build.stream_ptr(dev))
    build.check(err, "frame_place")
    build.LAUNCHES["frame_place"] += 1
    return words, totals, mb_bits, ovf


def mb_headers(block_bits, hdr, is_p_frame: bool, block_words: int,
               fmt: int = 1):
    """The chunk emit's per-MB sources of the first launch: block_bits
    (yb, cbb, crb) as in frame_assemble. Returns (hw [..., n_mbs, 2] int32,
    piece bits [..., n_mbs, 8] int32, mb_bits [..., nby, nbx] int32, ovf:
    a header or block over its budget). One launch, and the flag's
    reduction over the tiles' verdicts."""
    if block_bits[0].device.type == "cpu":
        return entropy.mb_headers(block_bits, hdr, is_p_frame, block_words,
                                  fmt)
    hdr, lead, nby, nbx = _check(block_bits, hdr, "mb_headers")
    dev = block_bits[0].device
    n_lead, n_mbs = math.prod(lead), nby * nbx
    hw = torch.empty((*lead, n_mbs, entropy.HEADER_WORDS), dtype=torch.int32,
                     device=dev)
    piece_bits = torch.empty((*lead, n_mbs, 8), dtype=torch.int32, device=dev)
    mb_bits = torch.empty((*lead, nby, nbx), dtype=torch.int32, device=dev)
    tile_info = torch.empty((n_lead * -(-n_mbs // tile()), 2),
                            dtype=torch.int32, device=dev)
    _headers(hdr, block_bits, n_lead, n_mbs, nbx, block_words, is_p_frame,
             fmt, hw=hw, mb_bits=mb_bits, piece_bits=piece_bits,
             tile_info=tile_info)
    build.LAUNCHES["frame_headers"] += 1
    return hw, piece_bits, mb_bits, tile_info[:, 1].any()


def mb_bit_totals(block_bits, hdr, is_p_frame: bool, fmt: int = 1):
    """Per-MB bit counts [..., nby, nbx] int32 (rc mb's first pass): the
    first launch with no words, no tile sums and no flag."""
    if block_bits[0].device.type == "cpu":
        return entropy.mb_bit_totals(block_bits, hdr, is_p_frame, fmt)
    hdr, lead, nby, nbx = _check(block_bits, hdr, "mb_bit_totals")
    mb_bits = torch.empty((*lead, nby, nbx), dtype=torch.int32,
                          device=block_bits[0].device)
    _headers(hdr, block_bits, math.prod(lead), nby * nbx, nbx,
             entropy.BLOCK_WORDS_MAX, is_p_frame, fmt, mb_bits=mb_bits)
    build.LAUNCHES["frame_mb_bits"] += 1
    return mb_bits
