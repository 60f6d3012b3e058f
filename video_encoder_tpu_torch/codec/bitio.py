"""Host-side bit I/O, MSB first (SPEC.md §6): the port's own copy of
`video_encoder_tpu/codec/bitio.py`, kept equal to it by
tests/test_torch_copies.py.

This is the golden model's bit layer (`codec/golden.py`). The port's
encode paths pack bits on the device (`codec/entropy.py`,
`ops/kernels/`), and its decoders parse with the C++ reader
(`codec/native.py`).
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Appends (value, length) codes MSB-first; emits big-endian words."""

    def __init__(self):
        self._bits: list[tuple[int, int]] = []
        self._nbits = 0

    def put(self, value: int, length: int) -> None:
        if length == 0:
            return
        assert 0 < length <= 32 and 0 <= value < (1 << length), (value, length)
        self._bits.append((int(value), int(length)))
        self._nbits += length

    def put_ue(self, v: int) -> None:
        assert v >= 0
        code = v + 1
        k = code.bit_length() - 1
        self.put(code, 2 * k + 1)

    def put_se(self, v: int) -> None:
        self.put_ue(2 * v - 1 if v > 0 else -2 * v)

    @property
    def nbits(self) -> int:
        return self._nbits

    def words(self) -> np.ndarray:
        """Pack to uint32 words, stream bit 0 = bit 31 of word 0."""
        nwords = (self._nbits + 31) // 32
        out = np.zeros(nwords, dtype=np.uint64)
        pos = 0
        for value, length in self._bits:
            w, s = pos >> 5, pos & 31
            avail = 32 - s
            if length <= avail:
                out[w] += np.uint64(value) << np.uint64(avail - length)
            else:
                hi = length - avail  # bits that spill into the next word
                out[w] += np.uint64(value >> hi)
                out[w + 1] += np.uint64(value & ((1 << hi) - 1)) << np.uint64(32 - hi)
            pos += length
        return out.astype(np.uint32)

    def tobytes(self) -> bytes:
        """Big-endian serialization of the word array (SPEC.md §6)."""
        return self.words().astype(">u4").tobytes()


class BitReader:
    """MSB-first reader over big-endian-serialized payload bytes."""

    def __init__(self, payload: bytes, nbits: int):
        self._words = np.frombuffer(payload, dtype=">u4").astype(np.uint64)
        self._nbits = nbits
        self._pos = 0

    @property
    def pos(self) -> int:
        return self._pos

    def get(self, length: int) -> int:
        if length == 0:
            return 0
        assert self._pos + length <= self._nbits, "bitstream overrun"
        w, s = self._pos >> 5, self._pos & 31
        avail = 32 - s
        if length <= avail:
            val = (int(self._words[w]) >> (avail - length)) & ((1 << length) - 1)
        else:
            hi = length - avail
            val = (int(self._words[w]) & ((1 << avail) - 1)) << hi
            val |= int(self._words[w + 1]) >> (32 - hi)
        self._pos += length
        return val

    def get_ue(self) -> int:
        zeros = 0
        while self.get(1) == 0:
            zeros += 1
            assert zeros <= 32, "corrupt ue() code"
        return ((1 << zeros) | self.get(zeros)) - 1 if zeros else 0

    def get_se(self) -> int:
        m = self.get_ue()
        return (m + 1) >> 1 if m & 1 else -(m >> 1)
