"""Host side of the sharded encode on one device.

Twin of `video_encoder_tpu/parallel/gop_parallel.py` `ShardedGopEncoder`
for the ('gop', 'tile') layout of `parallel/mesh.py`: G equal-length GOPs
in lockstep, every frame in S row shards (`parallel/tiles.py`
`encode_gop_batch_2d`), all on one device. A frame's payload is the
bit-concatenation of its shards in tile order, under chunk emit of each
shard's span strings in order. With one tile it is the engine's own
batched encode (`GopEngine.encode_gops`). GOPs spread over several devices
are the next parallel slice (ROADMAP.md A13b).
"""

from __future__ import annotations

import time

from ..codec import entropy, tables
from ..codec.config import EncoderConfig
from ..codec.frame import Frame
from ..pipeline.gop_engine import GopEngine, block_words_for_qp
from . import tiles
from .mesh import CodecMesh, make_codec_mesh


class ShardedGopEncoder:
    """encode_gop_batch(gops, first_indices, base_qp) -> one (packets,
    stats) pair per GOP, as GopEngine.encode_gops gives them and with the
    same bytes. `mesh` is a ('gop', 'tile') CodecMesh (default: one GOP,
    one tile); `device` defaults to the mesh's. The tile path exchanges
    halos and packs under chunk emit."""

    emit = "chunks"     # of the tile path

    def __init__(self, cfg: EncoderConfig, mesh: CodecMesh | None = None,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh or make_codec_mesh()
        self.n_gop_devices = self.mesh.shape["gop"]
        self.n_tile_devices = self.mesh.shape.get("tile", 1)
        # uploads, downloads and packets are the single-device engine's;
        # with one tile so is the whole encode
        self.engine = GopEngine(cfg, device=device or self.mesh.device)
        self.device = self.engine.device
        if self.n_tile_devices > 1:
            if cfg.search != "full":
                raise ValueError("the tile-sharded encode needs search='full' "
                                 "(the pre-haloed full search)")
            tiles.check_tile_config(self.mesh, cfg.height, cfg.width,
                                    cfg.format_version, cfg.intra_slice_mbrows)

    def run(self, y, cb, cr, base_qp: int, xl: bool = False):
        """One lockstep encode of G GOPs in S row shards each: [T, G, H, W]
        / [T, G, H/2, W/2] uint8 planes on the encoder's device; launches
        only, no host wait. xl selects the exact worst-case capacities;
        per-shard capacities come from the per-shard MB count. Returns
        tiles.encode_gop_batch_2d's stacked per-frame device tensors."""
        cfg = self.cfg
        n_mbs = ((y.shape[-2] // tables.MB) * (y.shape[-1] // tables.MB)
                 // self.n_tile_devices)
        if xl:
            bw, cap = entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs)
        else:
            bw, cap = block_words_for_qp(base_qp), entropy.capacity_words(n_mbs)
        return tiles.encode_gop_batch_2d(
            y, cb, cr, base_qp, mesh=self.mesh, rc=cfg.rc, block_words=bw,
            cap_words=cap, target_bits=cfg.target_bits_per_frame(),
            ref_mode="halo", fmt=cfg.format_version,
            cqpo=cfg.chroma_qp_offset, qbias=cfg.quant_bias,
            vbv_bits=cfg.vbv_bits(), qmat=cfg.quant_matrix,
            islice=cfg.intra_slice_mbrows, emit="chunks")

    def encode_gop_batch(self, gops: list[list[Frame]],
                         first_indices: list[int], base_qp: int | None = None):
        """gops: as many equal-length GOPs as the mesh's 'gop' axis."""
        base_qp = self.cfg.base_qp if base_qp is None else base_qp
        if len(gops) != self.n_gop_devices:
            raise ValueError(f"{len(gops)} GOPs for a mesh of "
                             f"{self.n_gop_devices} on its gop axis")
        if self.n_tile_devices == 1:
            return self.engine.encode_gops(gops, first_indices,
                                           [base_qp] * len(gops))
        n = len(gops[0])
        if any(len(g) != n for g in gops):
            raise ValueError("batched GOPs must be of equal length")
        t0 = time.perf_counter()
        eng = self.engine

        def up(plane):   # [T, G, H, W]: the frame axis leads
            return eng.upload([getattr(g[t], plane) for t in range(n)
                                for g in gops], (n, len(gops)))

        y, cb, cr = up("y"), up("cb"), up("cr")
        outs = self.run(y, cb, cr, base_qp)
        if bool(outs["ovf"].any()):   # the batch's one wait on the device
            outs = self.run(y, cb, cr, base_qp, xl=True)
        # a frame's strings in order: tile by tile, span by span
        host = eng.download(dict(
            words=outs["words"].flatten(2, 3),
            cbits=outs["cbits"].flatten(2, 3), bits=tiles.psum(outs["bits"]),
            n_inter=tiles.psum(outs["n_inter"]), qp=outs["qp"],
            sse=tiles.psum(outs["sse"], -2)))
        ms = (time.perf_counter() - t0) * 1e3 / (n * len(gops))
        return [
            eng.gop_packets(
                frames, first_index,
                {k: v if v is None else v[:, gi] for k, v in host.items()}, ms)
            for gi, (frames, first_index)
            in enumerate(zip(gops, first_indices))]
