"""Checkpoint / resume at GOP boundaries (SURVEY.md §5 "Checkpoint/resume").

GOPs are closed under prediction (SURVEY.md §3.2) and RC state is GOP-local
(SPEC.md §10), so the complete resumable state of an encode is just:
(next frame index, output byte offset, aggregate stats). A killed encode
resumes losslessly; the resumed stream is byte-identical to an uninterrupted
one (tested).

Checkpoint file: JSON, written atomically after every flushed GOP.

The port's own copy of `video_encoder_tpu/pipeline/checkpoint.py` (host code),
held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..codec.config import EncoderConfig
from ..utils.metrics import RunSummary


@dataclasses.dataclass
class EncodeState:
    config_hash: int
    next_frame: int
    byte_offset: int          # bytes already written to the output stream
    frames_done: int
    total_bits: int
    total_ms: float
    sum_psnr_y: float

    def to_summary(self) -> RunSummary:
        s = RunSummary()
        s.frames = self.frames_done
        s.total_bits = self.total_bits
        s.total_ms = self.total_ms
        s.sum_psnr_y = self.sum_psnr_y
        return s


def save(path: str, state: EncodeState) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str, cfg: EncoderConfig) -> EncodeState | None:
    """Load a checkpoint; None if absent. Raises on config mismatch."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    st = EncodeState(**d)
    if st.config_hash != cfg.config_hash():
        raise ValueError(
            f"checkpoint config hash {st.config_hash:#x} does not match "
            f"current config {cfg.config_hash():#x}"
        )
    return st


def clear(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)
