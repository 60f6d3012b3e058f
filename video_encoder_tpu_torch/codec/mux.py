"""Host glue of the chunk emit: a frame's span strings, in order, become
its payload bytes.

Numpy twin of `video_encoder_tpu/parallel/tiles.py` `bit_concat` (that
module imports JAX, so the port keeps its own copy).
"""

from __future__ import annotations

import numpy as np


def bit_concat(payloads: list[tuple[np.ndarray, int]]) -> tuple[bytes, int]:
    """Bit-concatenate MSB-first strings (uint32 words, nbits) into one
    big-endian payload: (bytes, total_bits). Pure numpy shift-or."""
    total_bits = sum(b for _, b in payloads)
    out = np.zeros((total_bits + 31) // 32 + 1, dtype=np.uint64)
    pos = 0
    for words, nbits in payloads:
        if nbits == 0:
            continue
        nw = (nbits + 31) // 32
        w = words[:nw].astype(np.uint64)
        word0, sh = pos >> 5, pos & 31
        if sh == 0:
            out[word0:word0 + nw] |= w
        else:
            out[word0:word0 + nw] |= w >> np.uint64(sh)
            out[word0 + 1:word0 + 1 + nw] |= (
                (w << np.uint64(32 - sh)) & np.uint64(0xFFFFFFFF))
        pos += nbits
    nw_total = (total_bits + 31) // 32
    return out[:nw_total].astype(np.uint32).astype(">u4").tobytes(), total_bits
