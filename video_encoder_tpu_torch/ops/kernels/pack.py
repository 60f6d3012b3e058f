"""Wrappers of the span-merge and chunk-merge kernels (csrc/span_merge.cu).

A CPU tensor takes the plain version in `codec/pack.py`; a CUDA tensor
launches the kernel, which is built at first use.

Words are int32 tensors holding the reference's uint32 bit patterns, in
and out; a kernel refuses words of any other dtype.

The kernel reads a piece's words only up to min(ceil(bits / 32), width),
so every piece (and every string fed to a later stage) must hold zeros
past its bit count, as the plain version's add, which equals an or only
then, also assumes: `block_pack` and `entropy._mb_sources` write them so,
and so does each merge for its own strings
(tests/test_torch_kernel_models.py holds every producer to it). A call is
one device op: the overflow flag is derived in the same launch.
"""

from __future__ import annotations

import torch

from ...codec import pack
from . import build


def _outputs(n_strings: int, cw: int, device):
    return (torch.empty((n_strings, cw), dtype=torch.int32, device=device),
            torch.empty((n_strings,), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.bool, device=device))


def span_merge_mb(hw, yw, cbw, crw, piece_bits, m: int, cw: int,
                  n_strings: int):
    """Per-MB piece sources -> n_strings strings of m pieces, cw words:
    (words [n_strings, cw] int32, bits [n_strings] int32, ovf bool). Each
    piece holds zeros past its bit count (see the module note)."""
    if yw.device.type == "cpu":
        return pack.span_merge_mb(hw, yw, cbw, crw, piece_bits, m, cw,
                                  n_strings)
    n_mbs, _, w = yw.shape
    if n_strings * m < 8 * n_mbs:
        raise ValueError(f"span_merge_mb: {n_strings} strings of {m} pieces "
                         f"do not hold {n_mbs} MBs")
    build.require(hw, torch.int32, (n_mbs, hw.shape[-1]), "span_merge_mb hw")
    build.require(yw, torch.int32, (n_mbs, 4, w), "span_merge_mb yw")
    build.require(cbw, torch.int32, (n_mbs, w), "span_merge_mb cbw")
    build.require(crw, torch.int32, (n_mbs, w), "span_merge_mb crw")
    build.require(piece_bits, torch.int32, (n_mbs * 8,), "span_merge_mb bits")
    words, bits, ovf = _outputs(n_strings, cw, yw.device)
    err = build.lib().tvc_span_merge_mb(
        hw.data_ptr(), yw.data_ptr(), cbw.data_ptr(), crw.data_ptr(),
        piece_bits.data_ptr(), n_mbs, hw.shape[-1], w, m, cw, n_strings,
        words.data_ptr(), bits.data_ptr(), ovf.data_ptr(),
        build.stream_ptr(yw.device))
    build.check(err, "span_merge_mb")
    build.LAUNCHES["span_merge_mb"] += 1
    return words, bits, ovf


def span_merge(strings, bits_in, g: int, stop: int, cw: int):
    """Groups of g strings [n, w] -> `stop` strings each of g/stop
    consecutive inputs, cw words: (words, bits int32, ovf bool). Each
    string holds zeros past its bit count (see the module note)."""
    if strings.device.type == "cpu":
        return pack.span_merge(strings, bits_in, g, stop, cw)
    n, w = strings.shape
    if n % g or g % stop:
        raise ValueError(f"span_merge: {n} strings in groups of {g} -> {stop}")
    build.require(strings, torch.int32, (n, w), "span_merge strings")
    build.require(bits_in, torch.int32, (n,), "span_merge bits")
    n_strings = n // g * stop
    words, bits, ovf = _outputs(n_strings, cw, strings.device)
    err = build.lib().tvc_span_merge(
        strings.data_ptr(), bits_in.data_ptr(), n, w, g // stop, cw,
        n_strings, words.data_ptr(), bits.data_ptr(), ovf.data_ptr(),
        build.stream_ptr(strings.device))
    build.check(err, "span_merge")
    build.LAUNCHES["span_merge"] += 1
    return words, bits, ovf


def chunk_merge(words, bits_in, k: int):
    """Each run of k piece strings -> two half-chunk strings of k/2
    pieces at the exact worst-case width (k/2) * w + 1: words [(G,) n, w]
    int32, bits [(G,) n] int32, n a multiple of k (k even). Returns (words
    [(G,) 2n/k, (k/2) * w + 1] int32, bits [(G,) 2n/k] int32); a leading
    G folds into the chunk axis (one launch). Each piece holds zeros past
    its bit count (see the module note)."""
    if words.device.type == "cpu":
        return pack.chunk_merge(words, bits_in, k)
    *lead, n, w = words.shape
    if len(lead) > 1 or k < 2 or k % 2 or n % k:
        raise ValueError(f"chunk_merge: {tuple(words.shape)} pieces in "
                         f"chunks of {k}")
    build.require(words, torch.int32, (*lead, n, w), "chunk_merge words")
    build.require(bits_in, torch.int32, (*lead, n), "chunk_merge bits")
    total = n * (lead[0] if lead else 1)
    cw = (k // 2) * w + 1
    out = torch.empty((*lead, 2 * n // k, cw), dtype=torch.int32,
                      device=words.device)
    bits = torch.empty((*lead, 2 * n // k), dtype=torch.int32,
                       device=words.device)
    err = build.lib().tvc_chunk_merge(
        words.data_ptr(), bits_in.data_ptr(), total, w, k, out.data_ptr(),
        bits.data_ptr(), build.stream_ptr(words.device))
    build.check(err, "chunk_merge")
    build.LAUNCHES["chunk_merge"] += 1
    return out, bits
