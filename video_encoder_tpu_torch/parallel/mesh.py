"""The shard layout of a parallel encode on one explicit device.

Twin of `video_encoder_tpu/parallel/mesh.py` `make_codec_mesh`. Axes:
'gop' (independent GOPs encoded in lockstep, no traffic between them) and
'tile' (row shards of one frame's MB grid, with a halo exchange), or for
the 2-D tile grid 'tr' and 'tc' (MB rows and MB columns). The mesh is a
small value object: the shards of every axis live on `device` as leading
axes of the tensors (`parallel/tiles.py`), so it names sizes, not devices.
"""

from __future__ import annotations

import dataclasses

from ..codec import tables


@dataclasses.dataclass(frozen=True)
class CodecMesh:
    """Axis names, their sizes and the one device that holds every shard."""

    axis_names: tuple
    sizes: tuple
    device: str = "cuda"

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def check_frame(self, height: int, width: int) -> None:
        """Raise unless the padded frame's MB grid divides over the tile
        axes: MB rows over 'tile' or 'tr', MB columns over 'tc'."""
        nby, nbx = -(-height // tables.MB), -(-width // tables.MB)
        shape = self.shape
        rows = shape.get("tile", shape.get("tr", 1))
        cols = shape.get("tc", 1)
        if nby % rows:
            raise ValueError(f"{nby} MB rows ({height} px) do not divide "
                             f"over {rows} row shards")
        if nbx % cols:
            raise ValueError(f"{nbx} MB columns ({width} px) do not divide "
                             f"over {cols} column shards")


def _mesh(names, sizes, device) -> CodecMesh:
    if any(int(s) < 1 for s in sizes):
        raise ValueError(f"mesh axes {names} need sizes >= 1, got {sizes}")
    return CodecMesh(tuple(names), tuple(int(s) for s in sizes), str(device))


def make_codec_mesh(gop_devices: int = 1, tile_devices: int = 1,
                    device="cuda") -> CodecMesh:
    """('gop', 'tile') layout: gop_devices GOPs in lockstep, each frame in
    tile_devices row shards."""
    return _mesh(("gop", "tile"), (gop_devices, tile_devices), device)


def make_tile_mesh_2d(row_shards: int, col_shards: int,
                      device="cuda") -> CodecMesh:
    """('tr', 'tc') layout: one GOP, each frame in row_shards x col_shards
    tiles."""
    return _mesh(("tr", "tc"), (row_shards, col_shards), device)
