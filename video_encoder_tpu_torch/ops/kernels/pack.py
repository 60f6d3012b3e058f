"""Wrappers of the span-merge kernels (csrc/span_merge.cu).

A CPU tensor takes the plain version in `codec/pack.py`; a CUDA tensor
launches the kernel, which is built at first use.
"""

from __future__ import annotations

import torch

from ...codec import pack
from . import build


def _outputs(n_strings: int, cw: int, device):
    return (torch.empty((n_strings, cw), dtype=torch.int64, device=device),
            torch.empty((n_strings,), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.bool, device=device))


def span_merge_mb(hw, yw, cbw, crw, piece_bits, m: int, cw: int,
                  n_strings: int):
    """Per-MB piece sources -> n_strings strings of m pieces, cw words:
    (words [n_strings, cw] int64, bits [n_strings] int32, ovf bool)."""
    if yw.device.type == "cpu":
        return pack.span_merge_mb(hw, yw, cbw, crw, piece_bits, m, cw,
                                  n_strings)
    n_mbs, _, w = yw.shape
    if n_strings * m < 8 * n_mbs:
        raise ValueError(f"span_merge_mb: {n_strings} strings of {m} pieces "
                         f"do not hold {n_mbs} MBs")
    build.require(hw, torch.int64, (n_mbs, hw.shape[-1]), "span_merge_mb hw")
    build.require(yw, torch.int64, (n_mbs, 4, w), "span_merge_mb yw")
    build.require(cbw, torch.int64, (n_mbs, w), "span_merge_mb cbw")
    build.require(crw, torch.int64, (n_mbs, w), "span_merge_mb crw")
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
    consecutive inputs, cw words: (words, bits int32, ovf bool)."""
    if strings.device.type == "cpu":
        return pack.span_merge(strings, bits_in, g, stop, cw)
    n, w = strings.shape
    if n % g or g % stop:
        raise ValueError(f"span_merge: {n} strings in groups of {g} -> {stop}")
    build.require(strings, torch.int64, (n, w), "span_merge strings")
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
