"""The codec's pinned tables as device tensors (SPEC.md §3-5).

The numpy tables in `codec/spec.py` are the single source of truth;
`load(device)` carries them onto a device as int32 tensors, once per
device. Scalars stay Python ints.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import spec

TX_SHIFT = spec.TX_SHIFT
MB = spec.MB
BLK = spec.BLK
SEARCH_R = spec.SEARCH_R
QP_MIN = spec.QP_MIN
QP_MAX = spec.QP_MAX


@dataclasses.dataclass(frozen=True)
class Tables:
    B: torch.Tensor         # [8, 8] ITX8 basis
    QSTEP: torch.Tensor     # [64] quantizer step per qp
    ZIGZAG: torch.Tensor    # [64] raster index of each scan position
    UNZIGZAG: torch.Tensor  # [64] scan position of each raster index
    QMAT: torch.Tensor      # [8, 8] v3 quant matrix, 16 = flat (SPEC.md §13.2)
    TX_SHIFT: int = TX_SHIFT
    MB: int = MB
    BLK: int = BLK
    SEARCH_R: int = SEARCH_R
    QP_MIN: int = QP_MIN
    QP_MAX: int = QP_MAX


@functools.lru_cache(maxsize=None)
def _load(device: torch.device) -> Tables:
    def t(a):
        return torch.as_tensor(a, dtype=torch.int32).to(device)

    return Tables(
        B=t(spec.B_MATRIX), QSTEP=t(spec.QSTEP),
        ZIGZAG=t(spec.ZIGZAG), UNZIGZAG=t(spec.UNZIGZAG), QMAT=t(spec.QMAT),
    )


def load(device) -> Tables:
    """The tables on `device` (a torch.device or its name)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _load(device)
