"""Resumable stream writer: fresh files get the header; resumed files are
truncated back to the last checkpointed GOP boundary (half-written GOPs
from a crash are discarded and re-encoded).

The port's own copy of `video_encoder_tpu/pipeline/bitstream_writer.py` (host code),
held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import os

from ..codec.bitstream import (
    STREAM_HEADER_SIZE,
    read_stream_header,
    write_stream_header,
)
from ..codec.config import EncoderConfig


def open_stream_for_resume(path: str, cfg: EncoderConfig, n_frames: int, state):
    if state is None or not os.path.exists(path):
        f = open(path, "wb")
        write_stream_header(f, cfg, n_frames)
        return f
    # Validate the checkpoint against the partial stream before truncating:
    # byte_offset must cover at least the header and not exceed what was
    # actually written (a checkpoint ahead of the file means lost bytes —
    # resuming would silently corrupt the stream).
    size = os.path.getsize(path)
    if state.byte_offset < STREAM_HEADER_SIZE:
        raise ValueError(
            f"checkpoint byte_offset {state.byte_offset} is inside the "
            f"{STREAM_HEADER_SIZE}-byte stream header"
        )
    if state.byte_offset > size:
        raise ValueError(
            f"checkpoint byte_offset {state.byte_offset} exceeds stream size "
            f"{size}; the stream lost data since the checkpoint — re-encode"
        )
    with open(path, "rb") as probe:
        info = read_stream_header(probe)
    if info.config_hash != cfg.config_hash():
        raise ValueError(
            "partial stream was written with a different config "
            f"(hash {info.config_hash:#x} != {cfg.config_hash():#x})"
        )
    f = open(path, "r+b")
    f.truncate(state.byte_offset)
    f.seek(state.byte_offset)
    return f
