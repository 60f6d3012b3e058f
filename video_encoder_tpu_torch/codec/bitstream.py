"""Container mux/demux (SPEC.md §8): the port's own copy of
`video_encoder_tpu/codec/bitstream.py`.

The mux is host-side and order-preserving: frames may arrive out of order
from sharded encoders (SURVEY.md §2.1 DP row; [B:10] "mux in frame order")
and are written strictly by frame index.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator

from .config import EncoderConfig

MAGIC = b"TVC1"
VERSION = 1
STREAM_HEADER_FMT = "<4sHHHHHBBII"  # magic, ver, flags, w, h, gop, qp, search, nframes, cfghash
STREAM_HEADER_SIZE = struct.calcsize(STREAM_HEADER_FMT)
FRAME_HEADER_FMT = "<BBHI"  # type, base_qp, reserved, payload_bits
FRAME_HEADER_SIZE = struct.calcsize(FRAME_HEADER_FMT)


@dataclasses.dataclass
class StreamInfo:
    width: int
    height: int
    gop_n: int
    base_qp: int
    search_mode: int
    frame_count: int
    config_hash: int
    flags: int = 0
    version: int = 1
    chroma_qp_offset: int = 0  # v2 (SPEC.md §12.1): flags high byte
    intra_slice_mbrows: int = 0  # v3 (SPEC.md §13.3): header extension word

    @property
    def quant_matrix(self) -> bool:
        # v3 (SPEC.md §13.2): flags bit 1
        return self.version >= 3 and bool(self.flags & 2)


@dataclasses.dataclass
class FramePacket:
    index: int
    frame_type: int  # 0=I, 1=P
    base_qp: int
    payload_bits: int
    payload: bytes  # big-endian words, ceil(bits/32)*4 bytes

    def to_bytes(self) -> bytes:
        return (
            struct.pack(FRAME_HEADER_FMT, self.frame_type, self.base_qp, 0, self.payload_bits)
            + self.payload
        )


def write_stream_header(f: BinaryIO, cfg: EncoderConfig, frame_count: int) -> None:
    flags = 1 if cfg.intra_only else 0
    if cfg.format_version >= 2:
        flags |= (cfg.chroma_qp_offset & 0xFF) << 8  # SPEC.md §12.1
    if cfg.format_version >= 3 and cfg.quant_matrix:
        flags |= 2  # SPEC.md §13.2
    f.write(
        struct.pack(
            STREAM_HEADER_FMT,
            MAGIC,
            cfg.format_version,
            flags,
            cfg.width,
            cfg.height,
            cfg.gop_n,
            cfg.base_qp,
            cfg.search_mode_id,
            frame_count,
            cfg.config_hash(),
        )
    )
    if cfg.format_version >= 3:
        # v3 header extension (SPEC.md §13.3): one u32 LE — bits 0-15 =
        # intra-slice height in MB rows (0 = one slice per frame), bits
        # 16-31 reserved zero.
        f.write(struct.pack("<I", cfg.intra_slice_mbrows & 0xFFFF))


def read_stream_header(f: BinaryIO) -> StreamInfo:
    raw = f.read(STREAM_HEADER_SIZE)
    if len(raw) < STREAM_HEADER_SIZE:
        raise ValueError(f"not a TVC1 stream (only {len(raw)} header bytes)")
    magic, ver, flags, w, h, gop, qp, search, nframes, cfghash = struct.unpack(
        STREAM_HEADER_FMT, raw
    )
    if magic != MAGIC:
        raise ValueError(f"not a TVC1 stream (magic={magic!r})")
    if ver not in (1, 2, 3, 4):
        raise ValueError(f"unsupported TVC1 version {ver}")
    cqpo = 0
    if ver >= 2:
        cqpo = (flags >> 8) & 0xFF
        if cqpo >= 128:
            cqpo -= 256  # signed int8 (SPEC.md §12.1)
    islice = 0
    if ver >= 3:
        ext = f.read(4)  # §13.3 extension word
        if len(ext) < 4:
            raise ValueError("truncated v3 header extension")
        islice = struct.unpack("<I", ext)[0] & 0xFFFF
    return StreamInfo(w, h, gop, qp, search, nframes, cfghash, flags, ver,
                      cqpo, islice)


class OrderedMux:
    """Reorders frame packets by index and writes them in display order.

    Accepts out-of-order arrival from GOP-sharded encoders; asserts the
    monotone frame-index invariant (SURVEY.md §5 "race detection" row:
    single-writer, monotone index).
    """

    def __init__(self, f: BinaryIO, cfg: EncoderConfig, frame_count: int):
        self._f = f
        self._next = 0
        self._pending: dict[int, FramePacket] = {}
        self.bytes_written = 0
        write_stream_header(f, cfg, frame_count)

    def push(self, pkt: FramePacket) -> None:
        # real exceptions, not asserts: the mux is a durable-output path and
        # must keep its invariants under `python -O` (VERDICT r1 weak #6)
        if pkt.index < self._next:
            raise ValueError(f"frame {pkt.index} already muxed")
        if pkt.index in self._pending:
            raise ValueError(f"duplicate frame {pkt.index}")
        self._pending[pkt.index] = pkt
        while self._next in self._pending:
            data = self._pending.pop(self._next).to_bytes()
            self._f.write(data)
            self.bytes_written += len(data)
            self._next += 1

    def close(self) -> None:
        if self._pending:
            raise ValueError(f"missing frames before {min(self._pending)}")


def demux(f: BinaryIO) -> tuple[StreamInfo, Iterator[FramePacket]]:
    """Demux a TVC1 stream: header + an iterator of frame packets (C13)."""
    info = read_stream_header(f)

    def frames() -> Iterator[FramePacket]:
        for i in range(info.frame_count):
            hdr = f.read(FRAME_HEADER_SIZE)
            if len(hdr) < FRAME_HEADER_SIZE:
                raise ValueError(f"truncated stream at frame {i}")
            ftype, base_qp, _, payload_bits = struct.unpack(FRAME_HEADER_FMT, hdr)
            nbytes = ((payload_bits + 31) // 32) * 4
            payload = f.read(nbytes)
            if len(payload) < nbytes:
                raise ValueError(f"truncated payload at frame {i}")
            yield FramePacket(i, ftype, base_qp, payload_bits, payload)

    return info, frames()
