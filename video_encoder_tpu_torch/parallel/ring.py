"""Temporal ring: D independent streams over D ranks (or D shards on one
device), the sequence-parallel analogue.

Twin of `video_encoder_tpu/parallel/ring.py` (`encode_ring_jit`,
`RingEncoder`). The P-frame chain t -> t + 1 is serial, so one GOP cannot
be frame-parallel; but D streams can share D ranks in a rotating
schedule. At micro-step m, rank d encodes frame m of stream (d - m) mod D,
then sends its reconstruction to rank d + 1, which encodes frame m + 1 of
the same stream at the next step. The hop carries the stream's
rate-control state with the three recon planes (the qp, and the vbv
fullness in int64 as `gop_engine.rc_carry_step` keeps it), so rc
bitrate/vbv/mb streams follow the single-device trajectory and every
stream is byte-identical to its single-device encode.

Over ranks each rank runs the engine's frame loop (`GopEngine.run_batch`)
on its own column of the schedule, with the hop a batch_isend_irecv over
the mesh's 'ring' group; on one device the D columns are one lockstep
batch and the hop is a roll of its axis. The worst-case rerun is global:
one all_reduce(MAX) of the overflow flag over the ring
(`gop_engine.overflowed` with `mesh.group_max`). The packets of every
stream are returned on every rank (all_gather_object of the columns'
bits, qps and words from `GopEngine.download`). There is no CLI flag, as
in the reference.

On one CUDA device the loop with its roll is one CUDA graph per key, the
counterpart of the reference's jitted `encode_ring_jit`: the engine asks
for the hop by name ("roll", `gop_engine.roll_hop`), which joins its
`GraphKey`, so a ring graph and a plain lockstep graph of the same shapes
never share a key; a key's first call runs eagerly, the second captures,
later calls replay, and the worst-case rerun is a key of its own (its
block and frame capacities). The overflow check stays outside the graph:
it is the host's one wait. Over ranks the hop is a function of the
group's collective, which a capture cannot take (gloo), so the loop has
no key and runs eagerly at every call. The ring's GopEngine is its own,
under frame emit, with a GraphCache of its own: it runs no span merge, so
the merges' one ticket per device is not touched.
"""

from __future__ import annotations

import functools

import numpy as np
import torch.distributed as dist

from ..codec.bitstream import FramePacket
from ..codec.frame import Frame
from ..pipeline.gop_engine import GopEngine, overflowed
from . import mesh as dmesh
from .mesh import CodecMesh


def ring_hop(carry, group):
    """The ring's ppermute over ranks: this rank's column's carry (tensors
    with the one column on axis 0) is sent to group rank d + 1 and the
    carry of d - 1 received, in one batch. On one device the hop is
    gop_engine.roll_hop, which the engine takes by the name "roll"."""
    d, n = dmesh.group_rank(group)
    if n == 1:
        return tuple(carry)
    return tuple(dmesh.exchange([(t, (d + 1) % n) for t in carry],
                                [(t, (d - 1) % n) for t in carry], group))


class RingEncoder:
    """encode_streams(streams, first_indices) -> the packets of each
    stream. `mesh` is a ('ring',) CodecMesh (parallel/mesh.py
    make_ring_mesh): D ranks, each calling encode_streams with the same
    streams, or D columns on one device, where on CUDA the loop replays
    one graph per key from the key's second call on (`engine.graphs`; the
    module docstring)."""

    def __init__(self, cfg, mesh: CodecMesh):
        self.cfg = cfg
        self.mesh = mesh
        self.d = mesh.shape["ring"]
        self.group = mesh.group("ring")
        self.engine = GopEngine(cfg, device=mesh.device, emit="frame")

    def encode_streams(self, streams: list[list[Frame]],
                       first_indices: list[int]) -> list[list[FramePacket]]:
        """streams: up to D streams of any (nonzero) lengths.

        Drain/fill as the reference's: shorter streams are padded with
        repeats of their last frame up to the longest length, and missing
        streams with a dummy stream; padded slots ride the ring like real
        work and their packets are dropped. Per-stream outputs stay
        byte-identical to a single-device encode because streams are
        independent and padding follows each stream's real frames."""
        d = self.d
        if not 0 < len(streams) <= d:
            raise ValueError(
                f"need 1..{d} streams for a {d}-device ring, got {len(streams)}")
        real_t = [len(s) for s in streams]
        n_real = len(streams)
        t = max(real_t)
        streams = [s + [s[-1]] * (t - len(s)) for s in streams]
        first_indices = list(first_indices)
        while len(streams) < d:
            streams.append([streams[0][0]] * t)
            first_indices.append(0)
        # rotate: column dev, step m holds frame m of stream (dev - m) % d
        cols = [self.mesh.coords["ring"]] if self.group is not None else range(d)
        eng = self.engine

        # [T, B, H, W], B the columns this process holds
        y, cb, cr = eng.upload(lambda p: [getattr(streams[(dev - m) % d][m], p)
                                          for m in range(t) for dev in cols],
                               (t, len(cols)))
        base = [self.cfg.base_qp] * len(cols)

        # on one device the roll by name (a graph per key); over ranks the
        # group's exchange, eager at every call
        hop = ("roll" if self.group is None
               else functools.partial(ring_hop, group=self.group))
        outs = eng.run_batch(y, cb, cr, base, hop=hop)
        group_max = dmesh.group_max(self.group)
        if overflowed(outs["ovf"], group_max):
            outs = eng.run_batch(y, cb, cr, base, xl=True, hop=hop)
            if overflowed(outs["ovf"], group_max):
                raise RuntimeError(
                    "ring encode overflowed worst-case payload capacity "
                    "(corrupt input or internal bug)")
        host = eng.download(outs)       # [T, B, ...]: B the columns held here
        bits, qps, words = host["bits"], host["qp"], host["words"]
        if self.group is not None:
            parts = [None] * d
            dist.all_gather_object(parts, (bits, qps, words), group=self.group)
            nw = max(p[2].shape[-1] for p in parts)
            bits = np.concatenate([p[0] for p in parts], 1)
            qps = np.concatenate([p[1] for p in parts], 1)
            words = np.concatenate([np.pad(p[2], ((0, 0), (0, 0),
                                                  (0, nw - p[2].shape[-1])))
                                    for p in parts], 1)
        packets: list[list[FramePacket]] = [[] for _ in range(n_real)]
        for m in range(t):
            for dev in range(d):
                s = (dev - m) % d
                if s >= n_real or m >= real_t[s]:
                    continue  # padded slot: drop
                n = (int(bits[m, dev]) + 31) // 32
                packets[s].append(FramePacket(
                    first_indices[s] + m, 0 if m == 0 else 1,
                    int(qps[m, dev]), int(bits[m, dev]),
                    words[m, dev, :n].astype(">u4").tobytes()))
        return packets
