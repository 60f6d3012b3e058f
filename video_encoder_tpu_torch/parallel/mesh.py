"""The shard layout of a parallel encode, and the process model of one
that spans ranks.

Twin of `video_encoder_tpu/parallel/mesh.py` (`make_codec_mesh`,
`init_distributed`). Axes: 'gop' (independent GOPs, no traffic between
them) and 'tile' (row shards of one frame's MB grid, with a halo
exchange); for the 2-D tile grid 'tr' and 'tc' (MB rows and MB columns);
for the temporal ring 'ring' (`parallel/ring.py`).

**On one device** the mesh is a small value object of sizes: the shards of
every axis live on `device` as leading axes of the tensors
(`parallel/tiles.py`), and the collectives are functions of those axes.

**Over ranks** the process model is PyTorch's idiom (torchrun, DDP): one
process per rank, each holding one shard of every axis.

- Why processes: the encoder is host-bound (PERF.md §5: the device idles
  79-93 % of every cell), so one Python thread driving N cards would keep
  them all waiting on it; a process per rank gives each card its own host
  thread.
- Rank r runs on `cuda:(r % torch.cuda.device_count())`, or on the CPU only
  when asked (`device="cpu"`, as the tests do).
- The backend follows from the layout: NCCL when every rank has a card of
  its own; gloo when ranks share a card or run on the CPU. Under gloo the
  exchanged CUDA tensors are staged through host memory explicitly
  (`.cpu()` before, `.to(device)` after), without relying on gloo's CUDA
  support. An NCCL error raises: nothing falls back to gloo or moves the
  encode to the CPU.
- `init_process_group` always gets a timeout, so a rank that hangs fails
  its group instead of stalling it.
- Rank r has the coordinates of r in the row-major layout of the mesh's
  sizes, and a process group along each axis: the ranks that share its
  other coordinates. For ('gop', 'tile') the 'tile' group is the ranks
  that exchange halos for one GOP.
- A coordinator process (the CLI) spawns the ranks and muxes their
  packets: `parallel/multiprocess.py`.

Every rank must issue the same collectives in the same order: a
rank-local branch that skips one deadlocks its group (an overflow rerun
is decided by an all_reduce(MAX) over the group; an injected fault is
checked by the coordinator before it dispatches work).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..codec import tables
from ..pipeline.gop_engine import resolve_device

DIST_TIMEOUT_S = 300.0

# What this process's collectives moved: bytes sent and wall seconds spent
# in them (under gloo with CUDA tensors, after a synchronise, so the time
# is the staging and the exchange and not the work queued before them;
# under NCCL the enqueue). Read per rank by parallel/multiprocess.py.
TRANSPORT = {"bytes": 0, "seconds": 0.0, "calls": 0}


def reset_transport() -> None:
    TRANSPORT.update(bytes=0, seconds=0.0, calls=0)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in an initialised default process group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def backend_for(world_size: int, device) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and (
            world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """cuda:(rank % cards) on a CUDA request (raises without CUDA), or the
    CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device="cuda", timeout_s: float = DIST_TIMEOUT_S
                     ) -> Ranks | None:
    """Join the default process group; returns this process's Ranks, or
    None (and does nothing) when unconfigured: no world_size and no
    WORLD_SIZE in the environment. Unset arguments come from the
    environment (torchrun's WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).
    The backend follows from the layout (backend_for); there is no
    fallback."""
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return None
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = rank_device(rank, device)
    backend = backend_for(world_size, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return Ranks(rank, world_size, dev, backend)


@dataclasses.dataclass(frozen=True)
class CodecMesh:
    """Axis names, their sizes and the device of this process's shards.
    `ranks` is None on one device (every shard on `device`); over ranks it
    is this process's place, and `groups` holds, per axis, the process
    group along that axis that contains this rank."""

    axis_names: tuple
    sizes: tuple
    device: str = "cuda"
    ranks: Ranks | None = None
    groups: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def spans_ranks(self) -> bool:
        return self.ranks is not None

    @property
    def coords(self) -> dict:
        """This rank's index on each axis (all 0 on one device)."""
        if self.ranks is None:
            return {n: 0 for n in self.axis_names}
        idx = np.unravel_index(self.ranks.rank, self.sizes)
        return {n: int(i) for n, i in zip(self.axis_names, idx)}

    def local(self, axis: str) -> int:
        """How many shards of an axis this process holds: the axis's size
        on one device, 1 over ranks."""
        return 1 if self.ranks is not None else self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group along an axis, or None on one device."""
        if self.ranks is None:
            return None
        return dict(zip(self.axis_names, self.groups))[axis]

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


def _axis_groups(sizes, ranks: Ranks) -> tuple:
    """Per axis, the group of the ranks that differ from this one in that
    axis's coordinate only. Every rank creates every group, in the same
    order, as torch.distributed.new_group requires."""
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    mine = []
    for ax, size in enumerate(sizes):
        for members in np.moveaxis(grid, ax, -1).reshape(-1, size):
            group = dist.new_group([int(m) for m in members])
            if ranks.rank in members:
                mine.append(group)
    return tuple(mine)


def _mesh(names, sizes, device, ranks: Ranks | None = None) -> CodecMesh:
    if any(int(s) < 1 for s in sizes):
        raise ValueError(f"mesh axes {names} need sizes >= 1, got {sizes}")
    sizes = tuple(int(s) for s in sizes)
    if ranks is None:
        return CodecMesh(tuple(names), sizes, str(device))
    if math.prod(sizes) != ranks.world_size:
        raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, the group has "
                         f"{ranks.world_size}")
    return CodecMesh(tuple(names), sizes, str(ranks.device), ranks,
                     _axis_groups(sizes, ranks))


def make_codec_mesh(gop_devices: int = 1, tile_devices: int = 1,
                    device="cuda", ranks: Ranks | None = None) -> CodecMesh:
    """('gop', 'tile') layout: gop_devices GOPs, each frame in tile_devices
    row shards; on one device (`device`), or one shard per rank of an
    initialised group (`ranks`)."""
    return _mesh(("gop", "tile"), (gop_devices, tile_devices), device, ranks)


def make_tile_mesh_2d(row_shards: int, col_shards: int, device="cuda",
                      ranks: Ranks | None = None) -> CodecMesh:
    """('tr', 'tc') layout: one GOP, each frame in row_shards x col_shards
    tiles; rank r holds tile (r // col_shards, r % col_shards)."""
    return _mesh(("tr", "tc"), (row_shards, col_shards), device, ranks)


def make_ring_mesh(streams: int, device="cuda",
                   ranks: Ranks | None = None) -> CodecMesh:
    """('ring',) layout of the temporal ring: one stream slot per shard."""
    return _mesh(("ring",), (streams,), device, ranks)


# ---- the transport over a process group ------------------------------------

def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective takes: a CUDA tensor goes through host
    memory under gloo."""
    t = t.contiguous()      # a column strip is a strided view
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


class _Timed:
    """Counts a collective's bytes and wall time into TRANSPORT."""

    def __init__(self, tensors, group):
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self.sync = next((t.device for t in tensors if t.is_cuda
                          and dist.get_backend(group) == "gloo"), None)

    def __enter__(self):
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        TRANSPORT["seconds"] += time.perf_counter() - self.t0
        TRANSPORT["bytes"] += self.nbytes
        TRANSPORT["calls"] += 1


def exchange(sends, recvs, group) -> list:
    """One batch of point-to-point transfers in a group: sends is a list
    of (tensor, peer), recvs of (tensor of the shape and dtype to receive,
    peer), peers as ranks of the group. Returns the received tensors on
    the devices of their templates."""
    if not sends and not recvs:
        return []
    with _Timed([t for t, _ in sends], group):
        ops, bufs = [], []
        for t, peer in sends:
            ops.append(dist.P2POp(dist.isend, _staged(t, group),
                                  dist.get_global_rank(group, peer), group))
        for like, peer in recvs:
            buf = _staged(torch.empty_like(like), group)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, peer), group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [b.to(like.device) for b, (like, _) in zip(bufs, recvs)]


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """all_reduce of a tensor over a group, returned on its device."""
    with _Timed([t], group):
        buf = _staged(t, group).clone()
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device)


def group_max(group):
    """A 0-dim flag's maximum over a process group (all_reduce MAX), the
    reduction gop_engine.overflowed takes, so that the group decides an
    overflow rerun together; None on one device (no group)."""
    if group is None:
        return None
    return functools.partial(all_reduce, group=group, op=dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, group) -> list:
    """The group's tensors of t's shape, in group-rank order, on t's
    device."""
    with _Timed([t], group):
        buf = _staged(t, group)
        out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, buf, group=group)
        return [o.to(t.device) for o in out]


def group_rank(group) -> tuple:
    """(this rank's index in the group, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)
