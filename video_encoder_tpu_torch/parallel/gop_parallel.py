"""Host side of the sharded encode: GOPs over the 'gop' axis, every frame
in row shards over the 'tile' axis, on one device or over ranks.

Twin of `video_encoder_tpu/parallel/gop_parallel.py` `ShardedGopEncoder`
for the ('gop', 'tile') layout of `parallel/mesh.py`.

- On one device, G equal-length GOPs run in lockstep, every frame in S
  row shards (`parallel/tiles.py` `encode_gop_batch_2d`). A frame's
  payload is the bit-concatenation of its shards in tile order, under
  chunk emit of each shard's span strings in order. On a CUDA device
  that loop is one CUDA graph per key (`ShardedGopEncoder.run`), the
  counterpart of the reference's jitted `encode_gop_batch_2d`.
- Over ranks (the DP branch, the reference's `encode_gop_batch_sharded`),
  'gop' rank g encodes GOP k * N_gop + g of batch k, together with the S
  ranks of its 'tile' group. Tile rank 0 gathers its group's span strings
  (all_gather_object over the 'tile' group) and glues them in tile order,
  so the packets leave the ranks whole; the other tile ranks return none.
- With one tile the encode is the engine's own (`GopEngine.start`: one
  GOP on the single-plane path, several in lockstep), under chunk emit as
  the tile path, and the stats keep each frame's sse: the reference's DP
  branch runs the frame emit and drops sse (its PSNR reads 0), which is
  not copied.

`ShardedGopEncoder.start` uploads and launches and returns a
`gop_engine.Launch`; `GopEngine.finish` (also `ShardedGopEncoder.finish`)
waits once, reruns the batch at the worst-case capacities if any shard
overflowed (over ranks, the whole 'tile' group decides by an
all_reduce(MAX) of the flag and reruns together), downloads and makes the
packets.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
import torch.distributed as dist

from ..codec import entropy, tables
from ..codec.config import EncoderConfig
from ..codec.frame import Frame
from ..ops import dispatch
from ..ops.kernels import sad as ksad
from ..pipeline.gop_engine import GopEngine, Launch, block_words_for_qp
from . import mesh as dmesh
from . import tiles
from .mesh import CodecMesh, make_codec_mesh

# what a captured tile loop bakes in (ShardedGopEncoder.graph_key)
TileKey = collections.namedtuple(
    "TileKey", "n_tile n_gop rc block_words cap_words target_bits ref_mode "
    "fmt cqpo qbias vbv_bits qmat islice emit y_shape c_shape sea force")


class ShardedGopEncoder:
    """finish(start(gops, first_indices, base_qps)) -> one (packets,
    stats) pair per GOP, as the GopEngine's give them and with the same
    bytes. `mesh` is a ('gop', 'tile') CodecMesh (default: one GOP, one
    tile, one device); `device` defaults to the mesh's. On a mesh over
    ranks the GOPs are this rank's (one), and only tile rank 0 gets
    packets. The tile path exchanges halos and packs under chunk emit."""

    emit = "chunks"

    def __init__(self, cfg: EncoderConfig, mesh: CodecMesh | None = None,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh or make_codec_mesh()
        self.n_gop_devices = self.mesh.shape["gop"]
        self.n_tile_devices = self.mesh.shape.get("tile", 1)
        # uploads, downloads and packets are the single-device engine's;
        # with one tile so is the whole encode
        self.engine = GopEngine(cfg, device=device or self.mesh.device,
                                emit=self.emit)
        self.device = self.engine.device
        # the tile graphs live beside the engine's: one pool, one stream
        self.cache = self.engine.cache
        if self.n_tile_devices > 1:
            if cfg.search != "full":
                raise ValueError("the tile-sharded encode needs search='full' "
                                 "(the pre-haloed full search)")
            tiles.check_tile_config(self.mesh, cfg.height, cfg.width,
                                    cfg.format_version, cfg.intra_slice_mbrows)

    def _capacities(self, y, qps: list[int], xl: bool):
        """(block words, capacity words) of a shard: per-shard capacities
        from the per-shard MB count; with xl the exact worst case, else
        budgeted for the smallest base qp of the batch."""
        n_mbs = ((y.shape[-2] // tables.MB) * (y.shape[-1] // tables.MB)
                 // self.mesh.local("tile"))
        if xl:
            return entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs)
        return block_words_for_qp(min(qps)), entropy.capacity_words(n_mbs)

    def graph_key(self, y_shape, c_shape, bw: int, cap: int) -> TileKey:
        """The key of a batch's graph: the arguments encode_gop_batch_2d
        passes as static (S and G, rc, block words, capacity words, target
        bits, ref_mode, fmt, cqpo, qbias, vbv bits, qmat, islice, emit),
        the [T, G, H, W] luma and chroma shapes, and the routes the
        wrappers read at every call (TVC_SEA, dispatch.force). The base
        qps are an input."""
        cfg = self.cfg
        return TileKey(self.mesh.local("tile"), y_shape[1], cfg.rc, bw, cap,
                       cfg.target_bits_per_frame(), "halo", cfg.format_version,
                       cfg.chroma_qp_offset, cfg.quant_bias, cfg.vbv_bits(),
                       cfg.quant_matrix, cfg.intra_slice_mbrows, self.emit,
                       tuple(y_shape), tuple(c_shape), ksad._sea_enabled(),
                       dispatch._FORCE)

    def _run(self, y, cb, cr, qp, bw: int, cap: int):
        """The tile loop (tiles.encode_gop_batch_2d) at the given
        capacities, qp the [G] int32 base qps on the device: the body a
        graph captures."""
        cfg = self.cfg
        return tiles.encode_gop_batch_2d(
            y, cb, cr, qp, mesh=self.mesh, rc=cfg.rc, block_words=bw,
            cap_words=cap, target_bits=cfg.target_bits_per_frame(),
            ref_mode="halo", fmt=cfg.format_version,
            cqpo=cfg.chroma_qp_offset, qbias=cfg.quant_bias,
            vbv_bits=cfg.vbv_bits(), qmat=cfg.quant_matrix,
            islice=cfg.intra_slice_mbrows, emit=self.emit)

    def run(self, y, cb, cr, base_qp, xl: bool = False):
        """One lockstep encode of this process's GOPs in row shards: [T, G,
        H, W] / [T, G, H/2, W/2] uint8 planes on the encoder's device (over
        ranks, G = 1 and the rows are this rank's), base_qp one int or one
        per GOP; launches only, no host wait. xl selects the exact
        worst-case capacities. Returns tiles.encode_gop_batch_2d's
        per-frame device tensors, of the call's own.

        On one CUDA device this is one graph per graph_key, replayed from
        the key's second call on, in the GopEngine's GraphCache: the same
        memory pool and the same one-stream rule as the engine's own
        graphs, since both run the merges. Over ranks (a 'tile' group) it
        stays eager: the exchange is a gloo collective, which a CUDA graph
        cannot capture."""
        qps = ([int(base_qp)] * y.shape[1] if np.ndim(base_qp) == 0
               else [int(q) for q in base_qp])
        bw, cap = self._capacities(y, qps, xl)
        key = (self.graph_key(y.shape, cb.shape, bw, cap)
               if self.mesh.group("tile") is None else None)
        return self.engine.budgeted(self.cache.launch(
            key, lambda *planes_qp: self._run(*planes_qp, bw, cap),
            (y, cb, cr), qps), xl)

    def start(self, gops: list[list[Frame]], first_indices: list[int],
              base_qps: list[int] | None = None) -> Launch:
        """Upload this process's GOPs of a batch and launch their encode,
        without waiting on the device: as many equal-length GOPs as the
        mesh's 'gop' axis on one device, one over ranks. With one tile
        this is GopEngine.start; with S tiles the Launch reruns through
        `run`, decides an overflow over the 'tile' group and fetches the
        whole frames' host arrays (`_fetch`)."""
        want = self.mesh.local("gop")
        if len(gops) != want:
            where = ("per rank" if self.mesh.spans_ranks
                     else f"for a mesh of {want} on its gop axis")
            raise ValueError(f"{len(gops)} GOPs {where}; want {want}")
        eng = self.engine
        if self.n_tile_devices == 1:
            return eng.start(gops, first_indices, base_qps)
        n = len(gops[0])
        if any(len(g) != n for g in gops):
            raise ValueError("batched GOPs must be of equal length")
        qps = (list(base_qps) if base_qps is not None
               else [self.cfg.base_qp] * len(gops))
        t0 = time.perf_counter()
        rows = {plane: slice(None) for plane in ("y", "cb", "cr")}
        if self.mesh.spans_ranks:     # this rank's rows of the padded frame
            s = self.mesh.coords["tile"]
            for plane in rows:
                h = getattr(gops[0][0], plane).shape[0] // self.n_tile_devices
                rows[plane] = slice(s * h, (s + 1) * h)
        # [T, G, H, W]: the frame axis leads
        y, cb, cr = eng.upload(lambda p: [getattr(g[t], p)[rows[p]]
                                          for t in range(n) for g in gops],
                               (n, len(gops)))
        return Launch(gops, first_indices, y, cb, cr, qps,
                      self.run(y, cb, cr, qps), t0, self.run, self._fetch,
                      dmesh.group_max(self.mesh.group("tile")))

    finish = staticmethod(GopEngine.finish)

    def _fetch(self, outs):
        """The host arrays of the whole frames from the shards' outputs:
        a frame's strings in order, tile by tile and span by span, the
        bits, inter MBs and sse summed over the shards. Over ranks tile
        rank 0 gathers and glues its group's downloads; the others get
        None."""
        host = self.engine.download(dict(
            words=outs["words"].flatten(2, 3),
            cbits=outs["cbits"].flatten(2, 3), bits=tiles.psum(outs["bits"]),
            n_inter=tiles.psum(outs["n_inter"]), qp=outs["qp"],
            sse=tiles.psum(outs["sse"], -2)))
        group = self.mesh.group("tile")
        if group is None:
            return host
        shares = [None] * self.n_tile_devices
        dist.all_gather_object(shares, host, group=group)
        return None if self.mesh.coords["tile"] else _glue_shards(shares)


def _glue_shards(shares: list) -> dict:
    """The host arrays of a frame's S row shards (GopEngine.download's,
    one per tile rank, in tile order) as one download of the whole frame:
    span strings concatenated in tile order (words padded to the widest
    share), bits, inter MBs and sse summed."""
    width = max(h["words"].shape[-1] for h in shares)
    words = np.concatenate([np.pad(
        h["words"], [(0, 0)] * (h["words"].ndim - 1)
        + [(0, width - h["words"].shape[-1])]) for h in shares], -2)
    return dict(words=words,
                cbits=np.concatenate([h["cbits"] for h in shares], -1),
                bits=sum(h["bits"] for h in shares),
                n_inter=sum(h["n_inter"] for h in shares),
                qp=shares[0]["qp"], sse=sum(h["sse"] for h in shares))


def encode_gops_on_ranks(senc: ShardedGopEncoder, gops, emit) -> int:
    """This rank's share of a sharded encode. gops yields (first_index,
    frames) of the GOPs of this rank's 'gop' coordinate, batch by batch
    (its tile group yields the same ones). Batch k + 1 is read and
    launched before batch k is finished, as the CLI's GOP path does.
    emit(k, results) takes each batch's (packets, stats) list ([] on tile
    ranks other than 0). After each batch the bits of its packets are
    summed over every rank (all_reduce, the reference's psum of total
    bits). Returns that sum over all batches."""
    total = 0
    pending = None

    def finish(k, handle):
        results = senc.finish(handle)
        emit(k, results)
        bits = sum(p.payload_bits for packets, _ in results for p in packets)
        return int(dmesh.all_reduce(
            torch.tensor(bits, dtype=torch.int64, device=senc.device),
            dist.group.WORLD))

    for k, (first, frames) in enumerate(gops):
        handle = senc.start([frames], [first])
        if pending is not None:
            total += finish(*pending)
        pending = (k, handle)
    if pending is not None:
        total += finish(*pending)
    return total
