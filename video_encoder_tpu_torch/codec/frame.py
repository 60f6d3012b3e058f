"""Frame model (SPEC.md §1): the port's own copy of `Frame` and `mb_grid`
from `video_encoder_tpu/codec/golden.py`. The golden model itself stays
the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import spec


@dataclasses.dataclass
class Frame:
    """Padded planes: y [Hp, Wp], cb/cr [Hp/2, Wp/2], int32 in [0, 255]."""

    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray

    @classmethod
    def from_planes(cls, y, cb, cr) -> "Frame":
        return cls(
            spec.pad_plane(np.asarray(y, np.int32), spec.MB),
            spec.pad_plane(np.asarray(cb, np.int32), spec.BLK),
            spec.pad_plane(np.asarray(cr, np.int32), spec.BLK),
        )

    def crop(self, w: int, h: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (
            self.y[:h, :w].astype(np.uint8),
            self.cb[: h // 2, : w // 2].astype(np.uint8),
            self.cr[: h // 2, : w // 2].astype(np.uint8),
        )


def mb_grid(frame: Frame) -> tuple[int, int]:
    return frame.y.shape[0] // spec.MB, frame.y.shape[1] // spec.MB
