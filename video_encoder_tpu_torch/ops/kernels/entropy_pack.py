"""Wrapper of the per-block symbol+pack kernel (csrc/block_pack.cu, one
warp per block).

A CPU tensor takes the plain version (`codec/entropy.py` block_symbols or
block_symbols_v2, then pack_dense); a CUDA tensor launches the kernel,
which is built at first use.
"""

from __future__ import annotations

import torch

from ...codec import entropy
from . import build


def plain_block_pack(levels_zz: torch.Tensor, n_words: int,
                     dc_pred: torch.Tensor | None = None, fmt: int = 1):
    if fmt >= 2:
        v, l = entropy.block_symbols_v2(levels_zz, dc_pred)
    else:
        v, l = entropy.block_symbols(levels_zz)
    words, bits, _ = entropy.pack_dense(v, l, n_words)
    return words, bits


def block_pack(levels_zz: torch.Tensor, n_words: int,
               dc_pred: torch.Tensor | None = None, fmt: int = 1):
    """Pack each 8x8 block's zigzag levels [n, 64] int32 into its own
    MSB-first string: (words [n, n_words] int32 holding the reference's
    uint32 bit patterns, bits [n] int32). fmt 1 is the format-1 syntax; fmt >= 2 the format-2
    syntax, whose DC codes against dc_pred [n] int32 (counted as
    "block_pack_v2"). A string longer than 32*n_words bits is truncated;
    `bits` keeps its full length so the caller can detect the overflow.
    Levels are quantizer outputs, |level| <= 3925 (SPEC.md §4). The
    kernel takes n_words up to BLOCK_WORDS_MAX, the exact worst case."""
    if fmt >= 2 and dc_pred is None:
        raise ValueError("block_pack: format >= 2 needs dc_pred")
    if levels_zz.device.type == "cpu":
        return plain_block_pack(levels_zz, n_words, dc_pred, fmt)
    if not 1 <= n_words <= entropy.BLOCK_WORDS_MAX:
        raise ValueError(f"block_pack: n_words {n_words} outside [1, "
                         f"{entropy.BLOCK_WORDS_MAX}], the exact worst case")
    n = levels_zz.shape[0]
    build.require(levels_zz, torch.int32, (n, 64), "block_pack levels")
    if fmt >= 2:
        build.require(dc_pred, torch.int32, (n,), "block_pack dc_pred")
    words = torch.empty((n, n_words), dtype=torch.int32,
                        device=levels_zz.device)
    bits = torch.empty((n,), dtype=torch.int32, device=levels_zz.device)
    err = build.lib().tvc_block_pack(
        levels_zz.data_ptr(), dc_pred.data_ptr() if fmt >= 2 else None, n,
        n_words, fmt, words.data_ptr(), bits.data_ptr(),
        build.stream_ptr(levels_zz.device))
    build.check(err, "block_pack")
    build.LAUNCHES["block_pack_v2" if fmt >= 2 else "block_pack"] += 1
    return words, bits
