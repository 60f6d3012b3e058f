"""Wrapper of the per-block symbol+pack kernel (csrc/block_pack.cu).

A CPU tensor takes the plain version (`codec/entropy.py` block_symbols +
pack_dense); a CUDA tensor launches the kernel, which is built at first
use. Format 1 only.
"""

from __future__ import annotations

import torch

from ...codec import entropy
from . import build


def plain_block_pack(levels_zz: torch.Tensor, n_words: int):
    v, l = entropy.block_symbols(levels_zz)
    words, bits, _ = entropy.pack_dense(v, l, n_words)
    return words, bits


def block_pack(levels_zz: torch.Tensor, n_words: int, fmt: int = 1):
    """Pack each 8x8 block's zigzag levels [n, 64] int32 into its own
    MSB-first string: (words [n, n_words] int64 holding 32-bit values,
    bits [n] int32). A string longer than 32*n_words bits is truncated;
    `bits` keeps its full length so the caller can detect the overflow.
    Levels are quantizer outputs, |level| <= 3925 (SPEC.md §4)."""
    if fmt != 1:
        raise NotImplementedError(
            "block_pack: format >= 2 (DC prediction) is not ported yet "
            "(ROADMAP.md Queue B, block_pack fmt>=2)")
    if levels_zz.device.type == "cpu":
        return plain_block_pack(levels_zz, n_words)
    n = levels_zz.shape[0]
    build.require(levels_zz, torch.int32, (n, 64), "block_pack levels")
    words = torch.empty((n, n_words), dtype=torch.int64,
                        device=levels_zz.device)
    bits = torch.empty((n,), dtype=torch.int32, device=levels_zz.device)
    err = build.lib().tvc_block_pack(
        levels_zz.data_ptr(), n, n_words, words.data_ptr(), bits.data_ptr(),
        build.stream_ptr(levels_zz.device))
    build.check(err, "block_pack")
    build.LAUNCHES["block_pack"] += 1
    return words, bits
