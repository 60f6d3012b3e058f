"""Encoder configuration: the port's own copy of
`video_encoder_tpu/codec/config.py`, plus `config_from_dict`.

One frozen dataclass; the CLI is a thin argparse wrapper over it. The config
is hashed (CRC32 of its canonical string) into the stream header for
reproducibility (SPEC.md §8). Mirrors reference component C1's flag surface
(mode, GOP, QP, search type, resolution — SURVEY.md §2 C1).
"""

from __future__ import annotations

import dataclasses
import zlib


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    width: int
    height: int
    gop_n: int = 30            # GOP length; 1 = intra-only [B:7,8]
    base_qp: int = 28          # QP in [1, 63]
    search: str = "full"       # "full" (±16) | "diamond" | "hier" [B:8,9; §9]
    rc: str = "none"           # "none"|"adaptive"|"bitrate"|"vbv"|"mb" (SPEC.md §10)
    target_kbps: int = 0       # rc="bitrate"/"vbv"/"mb" only
    vbv_kbits: int = 0         # rc="vbv" buffer size; 0 = 8x per-frame target
    fps_num: int = 30          # timing for bitrate RC budget
    fps_den: int = 1
    # Bitstream format (SPEC.md §8 v1 / §12 v2 / §13 v3). v2 adds left-MV
    # prediction, DC DPCM and the chroma QP offset; v3 adds I-frame
    # vertical intra prediction and the optional quant matrix.
    format_version: int = 1
    chroma_qp_offset: int = 0  # v2+ only, [-12, 12]
    quant_matrix: bool = False  # v3 only (SPEC.md §13.2), flagged in-stream
    # v3 intra slices (SPEC.md §13.3): the I-frame vertical-intra predictor
    # resets every N MB rows, making each N-row slice independent — the
    # H.264-slice move that lets v3 frames tile-shard with zero cross-shard
    # sequential state. 0 = one slice per frame (classic v3).
    intra_slice_mbrows: int = 0
    # Encoder-side AC quantizer rounding bias in 16ths of a step: 8 =
    # midpoint (historical behavior), smaller opens a deadzone that trades
    # a little PSNR for disproportionally fewer AC run/level bits. Decoder
    # and bitstream format are unaffected.
    quant_bias: int = 8
    # Parallel layout (SURVEY.md §2.1): devices along the GOP axis and the
    # spatial tile axis of the mesh.
    gop_devices: int = 1
    tile_devices: int = 1

    def __post_init__(self):
        if self.width % 2 or self.height % 2:
            raise ValueError("width/height must be even (4:2:0)")
        if not (1 <= self.base_qp <= 63):
            raise ValueError("base_qp must be in [1, 63]")
        if self.search not in ("full", "diamond", "hier"):
            raise ValueError(f"unknown search mode {self.search!r}")
        if self.rc not in ("none", "adaptive", "bitrate", "vbv", "mb"):
            raise ValueError(f"unknown rc mode {self.rc!r}")
        if self.rc in ("vbv", "mb") and self.target_kbps <= 0:
            raise ValueError(f"rc={self.rc!r} requires target_kbps > 0")
        if not (0 <= self.vbv_kbits <= 1_000_000):
            # device VBV state is int32: cap the buffer well below 2^31 bits
            raise ValueError("vbv_kbits must be in [0, 1_000_000]")
        if self.gop_n < 1:
            raise ValueError("gop_n must be >= 1")
        if self.format_version not in (1, 2, 3, 4):
            raise ValueError(f"unknown format version {self.format_version}")
        if not (-12 <= self.chroma_qp_offset <= 12):
            raise ValueError("chroma_qp_offset must be in [-12, 12]")
        if self.format_version == 1 and self.chroma_qp_offset != 0:
            raise ValueError("chroma_qp_offset requires format_version>=2")
        if self.quant_matrix and self.format_version < 3:
            raise ValueError("quant_matrix requires format_version>=3")
        if not (1 <= self.quant_bias <= 8):
            raise ValueError("quant_bias must be in [1, 8]")
        if self.intra_slice_mbrows:
            if self.format_version < 3:
                raise ValueError("intra_slice_mbrows requires format_version>=3")
            if not (0 < self.intra_slice_mbrows <= 0xFFFF):
                raise ValueError("intra_slice_mbrows must be in [0, 65535]")

    @property
    def intra_only(self) -> bool:
        return self.gop_n == 1

    @property
    def search_mode_id(self) -> int:
        return {"full": 0, "diamond": 1, "hier": 2}[self.search]

    def canonical(self) -> str:
        s = (
            f"tvc1:w={self.width}:h={self.height}:gop={self.gop_n}"
            f":qp={self.base_qp}:search={self.search}:rc={self.rc}"
            f":kbps={self.target_kbps}:fps={self.fps_num}/{self.fps_den}"
        )
        if self.format_version != 1:
            s += f":v={self.format_version}:cqpo={self.chroma_qp_offset}"
        if self.quant_bias != 8:
            s += f":qb={self.quant_bias}"
        if self.quant_matrix:
            s += ":qm=1"
        if self.intra_slice_mbrows:
            s += f":is={self.intra_slice_mbrows}"
        if self.rc == "vbv":
            s += f":vbv={self.vbv_kbits}"
        return s

    def config_hash(self) -> int:
        return zlib.crc32(self.canonical().encode()) & 0xFFFFFFFF

    def target_bits_per_frame(self) -> int:
        if self.rc not in ("bitrate", "vbv", "mb") or self.target_kbps <= 0:
            return 0
        return (self.target_kbps * 1000 * self.fps_den) // self.fps_num

    def vbv_bits(self) -> int:
        """rc=vbv buffer size in bits (0 when vbv is off)."""
        if self.rc != "vbv":
            return 0
        if self.vbv_kbits > 0:
            return self.vbv_kbits * 1000
        return 8 * self.target_bits_per_frame()


def config_from_dict(d: dict) -> EncoderConfig:
    """An EncoderConfig from a mapping of its field names (for example
    `dataclasses.asdict` of another package's config object). Unknown keys
    raise, as the constructor does."""
    return EncoderConfig(**d)
