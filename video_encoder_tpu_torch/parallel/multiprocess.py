"""Encode over ranks: the coordinator's launcher and the rank entry.

Twin of `video_encoder_tpu/parallel/multiprocess.py`. A coordinator (the
CLI, a test, `spawn`) starts N rank processes of this module, one per
rank (`parallel/mesh.py` states the process model). They join one
torch.distributed group: a `file://` rendezvous in the launch's own
temporary directory (so concurrent launches never share a port), or
`tcp://127.0.0.1:PORT` for ranks started by hand with `--port`. Each rank
runs the jobs of a JSON file in order, reading its own GOPs from the input
clip (the coordinator sends no frames), and hands each batch's results
back as a pickle in the launch's directory, announced by one JSON line on
its standard output; its last line is its rows (device, backend, GOPs,
encode seconds, kernel launches, transport bytes and seconds).

Jobs (`kind`):
- "gops": the sharded clip encode of `--devices N [--tile S]` and
  `--multiprocess N` (`gop_parallel.encode_gops_on_ranks` over a ('gop',
  'tile') mesh; `schedule` lists each batch's GOP first frames, one per
  'gop' rank);
- "ring": `ring.RingEncoder` over all ranks on streams cut from the clip;
- "tiles": the row-sharded (`rows`: 'tile' over all ranks, with
  `ref_mode` and `emit`) or 2-D (`grid`) tile program of one GOP, every
  rank returning its shard's tensors;
- "transport": each transport body of `parallel/tiles.py` over the group
  against its tensor-axis body on the same random planes, and the overflow
  decision over a group of two ranks.

    python -m video_encoder_tpu_torch.parallel.multiprocess --spawn 2 --device cpu

spawns two ranks that encode a synthetic GOP batch and check each rank's
GOPs byte for byte against the single-device GopEngine (the reference's
self-check). TVC_FAULT_RANK=r:k makes rank r raise before its k-th batch
of a "gops" job, to exercise the coordinator's failure path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..codec.config import EncoderConfig, config_from_dict
from ..codec.frame import Frame
from ..io import yuv
from ..ops.kernels import build
from ..pipeline.gop_engine import GopEngine, overflowed
from . import mesh as dmesh
from . import tiles
from .gop_parallel import ShardedGopEncoder, encode_gops_on_ranks
from .mesh import (init_distributed, make_codec_mesh, make_ring_mesh,
                   make_tile_mesh_2d)
from .ring import RingEncoder

DEFAULT_TIMEOUT_S = 600.0
_MODULE = "video_encoder_tpu_torch.parallel.multiprocess"
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def init_localhost(process_id: int, num_processes: int, port: int,
                   device="cuda", init_method: str | None = None):
    """Join a localhost group as rank process_id of num_processes:
    `tcp://127.0.0.1:port`, or `init_method`. On the CPU each rank keeps
    one thread: N ranks of N threads each would thrash the host (the
    reference pins each worker to a core for the same reason)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    return init_distributed(init_method or f"tcp://127.0.0.1:{port}",
                            num_processes, process_id, device)


def synth_gops(n_gops: int, t: int, h: int, w: int, seed: int = 7):
    """Deterministic 4:2:0 GOP batch every process can rebuild identically:
    textured pan + moving square + noise. Returns uint8 [G,T,H,W] planes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    ys = np.empty((n_gops, t, h, w), np.uint8)
    cbs = np.empty((n_gops, t, h // 2, w // 2), np.uint8)
    crs = np.empty((n_gops, t, h // 2, w // 2), np.uint8)
    for g in range(n_gops):
        for k in range(t):
            oy, ox = (2 * (g * t + k)) % 48, (3 * (g * t + k)) % 48
            y = base[oy : oy + h, ox : ox + w].copy()
            sy, sx = (5 * k + 11 * g) % max(h - 16, 1), (7 * k) % max(w - 16, 1)
            y[sy : sy + 16, sx : sx + 16] = 230
            ys[g, k] = np.clip(y + rng.integers(-2, 3, y.shape), 0, 255)
            cbs[g, k] = 110 + (g + k) % 8
            crs[g, k] = 145
    return ys, cbs, crs


def read_gops(path: str, width: int, height: int, gop_n: int,
              firsts, limit: int | None = None):
    """Yield (first, frames) for GOPs starting at the given frame indices,
    in ascending order, reading the clip once; a GOP cut by the clip's end
    or by frame `limit` is short."""
    firsts = list(firsts)
    if firsts != sorted(firsts):
        raise ValueError("GOPs are read in ascending order")
    wanted = iter(firsts)
    first = next(wanted, None)
    _, _, _, frames = yuv.open_clip(path, width, height)
    gop = []
    for i, planes in enumerate(frames):
        if first is None or (limit is not None and i >= limit):
            break
        if i >= first:
            gop.append(Frame.from_planes(*planes))
        if len(gop) == gop_n:
            yield first, gop
            gop, first = [], next(wanted, None)
    if gop:
        yield first, gop


def encode_gops_multiprocess(cfg, y: np.ndarray, cb: np.ndarray,
                             cr: np.ndarray, ranks, warmup: bool = True):
    """Encode a replicated [G, T, ...] GOP batch over the group: rank r
    encodes GOPs [r G/N, (r + 1) G/N). Returns (owned GOP indices,
    {gop_index: [(qp, bits, payload_bytes)]}, encode wall seconds, encode
    CPU seconds). With warmup, the first owned GOP is encoded once before
    the timed pass (the kernels' first launches); the timed pass starts
    and ends at a barrier."""
    g, n = y.shape[0], ranks.world_size
    if g % n:
        raise ValueError(f"G={g} must divide over {n} ranks")
    senc = ShardedGopEncoder(cfg, make_codec_mesh(n, 1, ranks=ranks))
    per = g // n
    owned = list(range(ranks.rank * per, (ranks.rank + 1) * per))

    def gops():
        for gi in owned:
            yield gi * y.shape[1], [Frame.from_planes(y[gi, t], cb[gi, t],
                                                      cr[gi, t])
                                    for t in range(y.shape[1])]

    if warmup:
        senc.finish(senc.start([next(gops())[1]], [0]))
        dist.barrier()
    local = {}

    def keep(_, results):
        for packets, _ in results:
            local[packets[0].index // y.shape[1]] = [
                (p.base_qp, p.payload_bits, p.payload) for p in packets]

    t0, c0 = time.perf_counter(), time.process_time()
    encode_gops_on_ranks(senc, gops(), keep)
    _sync(senc.device)
    cpu_dt = time.process_time() - c0
    dist.barrier()
    return owned, local, time.perf_counter() - t0, cpu_dt


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---- the rank side ----------------------------------------------------------

def _rank_fault(rank: int):
    """TVC_FAULT_RANK=r:k -> the batch index at which this rank raises."""
    spec = os.environ.get("TVC_FAULT_RANK")
    if not spec:
        return None
    r, k = (int(x) for x in spec.split(":"))
    return k if r == rank else None


def _job_gops(job, ranks, emit):
    cfg = config_from_dict(job["cfg"])
    mesh = make_codec_mesh(*job["mesh"], ranks=ranks)
    senc = ShardedGopEncoder(cfg, mesh)
    firsts = [batch[mesh.coords["gop"]] for batch in job["schedule"]]
    fault = _rank_fault(ranks.rank)

    def gops():
        for k, item in enumerate(read_gops(job["clip"], job["width"],
                                           job["height"], cfg.gop_n, firsts)):
            if k == fault:
                raise RuntimeError(f"injected fault on rank {ranks.rank} "
                                   f"before its batch {k}")
            yield item

    t0, c0 = time.perf_counter(), time.process_time()
    total = encode_gops_on_ranks(senc, gops(), emit)
    _sync(senc.device)
    return dict(gops=firsts, encode_s=time.perf_counter() - t0,
                cpu_s=time.process_time() - c0, total_bits=total,
                p_frames=len(firsts) * (cfg.gop_n - 1),
                tile=mesh.coords["tile"])


def _clip_frames(job, indices):
    """{frame index: Frame} of the clip's frames at these indices."""
    want = set(indices)
    _, _, _, frames = yuv.open_clip(job["clip"], job["width"], job["height"])
    out = {}
    for i, planes in enumerate(frames):
        if i in want:
            out[i] = Frame.from_planes(*planes)
        if len(out) == len(want):
            break
    return out


def _job_ring(job, ranks, emit):
    cfg = config_from_dict(job["cfg"])
    spans = [range(first, first + n) for first, n in job["streams"]]
    frames = _clip_frames(job, [i for s in spans for i in s])
    t0 = time.perf_counter()
    enc = RingEncoder(cfg, make_ring_mesh(ranks.world_size, ranks=ranks))
    packets = enc.encode_streams([[frames[i] for i in s] for s in spans],
                                 job["first_indices"])
    _sync(ranks.device)
    if ranks.rank == 0:
        emit(0, packets)
    return dict(streams=len(spans), encode_s=time.perf_counter() - t0,
                p_frames=max(map(len, spans)) - 1)


def _job_tiles(job, ranks, emit):
    cfg = config_from_dict(job["cfg"])
    frames = list(_clip_frames(job, range(job["first"], job["first"]
                                          + cfg.gop_n)).values())
    grid = job.get("grid")
    if grid:
        mesh = make_tile_mesh_2d(*grid, ranks=ranks)
        r, c = mesh.coords["tr"], mesh.coords["tc"]
    else:
        mesh = make_codec_mesh(1, ranks.world_size, ranks=ranks)
        r, c, grid = mesh.coords["tile"], 0, (ranks.world_size, 1)

    def up(plane):   # this rank's tile of each frame, [T, h, w]
        full = np.stack([getattr(f, plane) for f in frames])
        h, w = full.shape[1] // grid[0], full.shape[2] // grid[1]
        return torch.from_numpy(np.ascontiguousarray(
            full[:, r * h:(r + 1) * h, c * w:(c + 1) * w])).to(ranks.device)

    kw = dict(mesh=mesh, rc=cfg.rc, block_words=job["block_words"],
              target_bits=cfg.target_bits_per_frame(), qbias=cfg.quant_bias,
              vbv_bits=cfg.vbv_bits(), fmt=cfg.format_version)
    if job.get("grid"):
        outs = tiles.encode_gop_tiled2d(up("y"), up("cb"), up("cr"),
                                        cfg.base_qp, row_words=job["row_words"],
                                        **kw)
    else:
        outs = tiles.encode_gop_tiled(
            up("y"), up("cb"), up("cr"), cfg.base_qp,
            cap_words=job["cap_words"], ref_mode=job["ref_mode"],
            emit=job["emit"], cqpo=cfg.chroma_qp_offset,
            qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows, **kw)
    emit(0, {k: v.cpu().numpy() for k, v in outs.items()})
    return dict(tile=[r, c], p_frames=cfg.gop_n - 1)


def _job_transport(job, ranks, emit):
    """Each body over the group against the tensor-axis body, on planes
    every rank makes from the seed; emits {case: (rank's result, max abs
    error)}."""
    n, me, dev = ranks.world_size, ranks.rank, ranks.device
    h, w = job["shape"]
    rng = np.random.default_rng(job["seed"])
    planes = torch.from_numpy(rng.integers(0, 256, (2, n, h, w),
                                           dtype=np.int32)).to(dev)
    group = make_codec_mesh(1, n, ranks=ranks).group("tile")
    mine = planes[:, me:me + 1]
    cases = {}
    for halo in job["halos"]:
        cases[f"rows{halo}"] = (
            tiles.exchange_halo(mine, halo, group=group),
            tiles.exchange_halo(planes, halo)[:, me:me + 1])
        cases[f"cols{halo}"] = (
            tiles.exchange_halo(mine, halo, axis=1, group=group),
            tiles.exchange_halo(planes, halo, axis=1)[:, me:me + 1])
        cases[f"gather{halo}"] = (
            tiles.gather_ref(mine, halo, group=group),
            tiles.gather_ref(planes, halo)[:, me:me + 1])
    cases["psum"] = (tiles.psum(mine.sum(-1), -2, group=group),
                     tiles.psum(planes.sum(-1), -2))
    sr, sc = job["grid"]
    m2 = make_tile_mesh_2d(sr, sc, ranks=ranks)
    r, c = m2.coords["tr"], m2.coords["tc"]
    groups = (m2.group("tr"), m2.group("tc"))
    grid_planes = planes.reshape(2, sr, sc, h, w)
    tile = grid_planes[:, r:r + 1, c:c + 1]
    for halo in job["halos"]:
        cases[f"2d{halo}"] = (
            tiles.exchange_halo_2d(tile, halo, groups=groups),
            tiles.exchange_halo_2d(grid_planes, halo)[:, r:r + 1, c:c + 1])
    est = torch.from_numpy(rng.integers(0, 4000, (sr, sc, 3, 4))).to(dev)
    cases["mb_rc_2d"] = (
        tiles.mb_rc_offsets_tile2d(est[r:r + 1, c:c + 1], group=groups[1]),
        tiles.mb_rc_offsets_tile2d(est)[r:r + 1, c:c + 1])
    # the overflow decision over each 'tc' group: a flag set on the last
    # tile of row 0 only, so every rank of row 0 decides true, the others
    # false
    ovf = torch.tensor([False, (r, c) == (0, sc - 1)], device=dev)
    cases["overflow"] = (
        torch.tensor([overflowed(ovf, dmesh.group_max(groups[1]))]),
        torch.tensor([r == 0]))
    out = {k: (got.cpu().numpy(), int((got.long() - want.long()).abs().max()))
           for k, (got, want) in cases.items()}
    emit(0, out)
    return dict(cases=len(out), max_abs_err=max(e for _, e in out.values()))


JOBS = {"gops": _job_gops, "ring": _job_ring, "tiles": _job_tiles,
        "transport": _job_transport}


def _announce(dump: str, job: int, batch: int, rank: int, obj) -> None:
    """A batch's results for the coordinator: the pickle first, then its
    line."""
    path = os.path.join(dump, f"j{job}_b{batch}_r{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)
    print(json.dumps({"job": job, "batch": batch, "rank": rank,
                      "file": path}), flush=True)


def _clip_worker(a) -> int:
    """One rank: join the group, run the job file's jobs in order, print
    one row per job."""
    ranks = init_localhost(a.process_id, a.num_processes, a.port, a.device,
                           a.init_method)
    with open(a.job) as f:
        jobs = json.load(f)["jobs"]
    rows = []
    try:
        for j, job in enumerate(jobs):
            build.reset_launches()
            dmesh.reset_transport()
            row = JOBS[job["kind"]](job, ranks, lambda k, obj, j=j: _announce(
                a.dump, j, k, ranks.rank, obj))
            rows.append(dict(
                row, rank=ranks.rank, device=str(ranks.device),
                backend=ranks.backend,
                launches={k: v for k, v in build.LAUNCHES.items() if v},
                transport_bytes=dmesh.TRANSPORT["bytes"],
                transport_s=dmesh.TRANSPORT["seconds"],
                transport_calls=dmesh.TRANSPORT["calls"]))
        print(json.dumps({"rows": rows}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _worker(a) -> int:
    """One rank of the self-check: the synthetic GOP batch over the group,
    each owned GOP against the single-device GopEngine."""
    if a.job:
        return _clip_worker(a)
    ranks = init_localhost(a.process_id, a.num_processes, a.port, a.device,
                           a.init_method)
    try:
        cfg = EncoderConfig(
            width=a.width, height=a.height, gop_n=a.frames, base_qp=a.qp,
            search=a.search, rc=a.rc,
            target_kbps=256 if a.rc != "none" else 0,
            fps_num=30 if a.rc != "none" else 0)
        y, cb, cr = synth_gops(a.gops, a.frames, a.height, a.width)
        owned, local, dt, cpu_dt = encode_gops_multiprocess(cfg, y, cb, cr,
                                                            ranks)
        eng = GopEngine(cfg, device=ranks.device)
        n_bad = 0
        for g in owned:
            frames = [Frame.from_planes(y[g, t], cb[g, t], cr[g, t])
                      for t in range(a.frames)]
            want, _ = eng.encode_gop(frames, g * a.frames)
            if [(p.base_qp, p.payload_bits, p.payload) for p in want] != local[g]:
                n_bad += 1
        print(json.dumps({"rows": [{
            "process_id": a.process_id, "device": str(ranks.device),
            "backend": ranks.backend, "owned_gops": owned,
            "encode_s": round(dt, 4), "cpu_s": round(cpu_dt, 4),
            "mismatched_gops": n_bad,
            "fps": round(a.gops * a.frames / dt, 2),
            "own_frames": len(owned) * a.frames}]}), flush=True)
    finally:
        dist.destroy_process_group()
    return 1 if n_bad else 0


# ---- the coordinator side ---------------------------------------------------

class RankFailure(RuntimeError):
    """A rank exited with an error, or none reported within the timeout."""


class RankGroup:
    """N rank processes of this module, started at construction: with
    `jobs`, each runs them (`_clip_worker`); else the self-check with
    `args`. events() yields each announced batch result as it arrives and
    raises RankFailure, after stopping every rank, when a rank exits
    non-zero (with the tail of its standard error) or when no rank
    reports for timeout_s. rows holds each rank's rows once all exited.
    Use it as a context manager: leaving it stops every rank and removes
    the launch's directory."""

    def __init__(self, n: int, jobs: list | None = None, args=(),
                 device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
                 port: int = 0):
        self.n, self.timeout_s = n, timeout_s
        self.workdir = tempfile.mkdtemp(prefix="tvc_ranks_")
        self.rows: list = [None] * n
        init = (f"tcp://127.0.0.1:{port}" if port
                else f"file://{self.workdir}/rendezvous")
        argv = ["--num-processes", str(n), "--init-method", init,
                "--device", str(device), "--dump", self.workdir, *args]
        if jobs is not None:
            path = os.path.join(self.workdir, "jobs.json")
            with open(path, "w") as f:
                json.dump({"jobs": jobs}, f)
            argv += ["--job", path]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
        if torch.device(device).type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        # the ranks are this host's: their transports bind to loopback
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            env.setdefault(var, "lo")
        self._queue: queue.Queue = queue.Queue()
        self.procs, self._errs = [], []
        for i in range(n):
            err = open(os.path.join(self.workdir, f"rank{i}.err"), "w+")
            self._errs.append(err)
            proc = subprocess.Popen(
                [sys.executable, "-m", _MODULE, "--process-id", str(i), *argv],
                stdout=subprocess.PIPE, stderr=err, env=env, text=True,
                cwd=_PKG_ROOT)
            self.procs.append(proc)
            threading.Thread(target=self._read, args=(i, proc),
                             daemon=True).start()

    def _read(self, i: int, proc) -> None:
        for line in proc.stdout:
            self._queue.put((i, line))
        self._queue.put((i, None))

    def _tail(self, i: int, n: int = 2000) -> str:
        self._errs[i].flush()
        with open(self._errs[i].name) as f:
            return f.read()[-n:]

    def _fail(self, msg: str):
        self.stop()
        return RankFailure(msg)

    def events(self):
        """Yield dict(job, batch, rank, result) for each announced batch,
        in arrival order, until every rank has exited."""
        live = set(range(self.n))
        while live:
            try:
                i, line = self._queue.get(timeout=self.timeout_s)
            except queue.Empty:
                tails = {i: self._tail(i, 400) for i in live}
                raise self._fail(f"no rank reported for {self.timeout_s} s "
                                 f"(ranks {sorted(live)} still running); "
                                 f"their stderr ends: {tails}") from None
            if line is None:
                try:
                    rc = self.procs[i].wait(timeout=self.timeout_s)
                except subprocess.TimeoutExpired:
                    rc = None
                if rc != 0:
                    raise self._fail(f"rank {i} exited with code {rc}; its "
                                     f"stderr ends:\n{self._tail(i)}")
                if self.rows[i] is None:
                    raise self._fail(f"rank {i} exited without its rows; its "
                                     f"stderr ends:\n{self._tail(i)}")
                live.discard(i)
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue        # not one of ours
            if "rows" in msg:
                self.rows[i] = msg["rows"]
            elif "file" in msg:
                with open(msg["file"], "rb") as f:   # written by our rank
                    msg["result"] = pickle.load(f)
                yield msg

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        for f in self._errs:
            f.close()
        shutil.rmtree(self.workdir, ignore_errors=True)


def run_jobs(jobs: list, n: int, device="cuda",
             timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run jobs on n ranks to the end: ({job: {batch: {rank: result}}},
    each rank's rows)."""
    results: dict = {}
    with RankGroup(n, jobs, device=device, timeout_s=timeout_s) as group:
        for ev in group.events():
            results.setdefault(ev["job"], {}).setdefault(
                ev["batch"], {})[ev["rank"]] = ev["result"]
        return results, group.rows


def _free_port() -> int:
    """An OS-assigned free TCP port for a tcp rendezvous (`--spawn`)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_clip_encode(cfg, in_path: str, width: int, height: int,
                      n_frames: int, nproc: int, port: int = 0,
                      device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """Coordinator of `--multiprocess N`: nproc ranks over the clip's full
    GOPs (their count rounded down to a multiple of nproc; the caller
    encodes the rest), rank i the i-th contiguous share. Returns (each
    rank's rows, FramePackets sorted by frame index, their FrameStats)."""
    n_full = n_frames // cfg.gop_n
    per = (n_full - n_full % nproc) // nproc
    if per == 0:
        return [], [], []
    schedule = [[(i * per + k) * cfg.gop_n for i in range(nproc)]
                for k in range(per)]
    job = dict(kind="gops", cfg=dataclasses.asdict(cfg),
               clip=os.path.abspath(in_path), width=width, height=height,
               mesh=[nproc, 1], schedule=schedule)
    packets, stats = [], []
    with RankGroup(nproc, [job], device=device, timeout_s=timeout_s,
                   port=port) as group:
        for ev in group.events():
            for pk, st in ev["result"]:
                packets += pk
                stats += st
        rows = [r for rank_rows in group.rows for r in rank_rows]
    packets.sort(key=lambda p: p.index)
    return rows, packets, stats


def spawn(n: int, port: int, extra: list[str], device="cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list[dict]:
    """Launch the self-check on n localhost ranks; returns their rows.
    Raises on a failed rank or mismatched bytes."""
    with RankGroup(n, args=extra, device=device, timeout_s=timeout_s,
                   port=port) as group:
        for _ in group.events():
            pass
        rows = [r for rank_rows in group.rows for r in rank_rows]
    if any(r["mismatched_gops"] for r in rows):
        raise RuntimeError(f"distributed bytes != single-device bytes: {rows}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="launch N localhost ranks and verify")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--port", type=int, default=12731)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (file://... or tcp://...); "
                         "default tcp://127.0.0.1:PORT")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r % cards) or cpu")
    ap.add_argument("--gops", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--qp", type=int, default=28)
    ap.add_argument("--search", default="full")
    ap.add_argument("--rc", default="none")
    ap.add_argument("--job", default="",
                    help="JSON file of jobs (the coordinator's launch)")
    ap.add_argument("--dump", default="",
                    help="directory for this rank's result pickles")
    a = ap.parse_args()
    if a.spawn:
        extra = ["--gops", str(a.gops), "--frames", str(a.frames),
                 "--width", str(a.width), "--height", str(a.height),
                 "--qp", str(a.qp), "--search", a.search, "--rc", a.rc]
        rows = spawn(a.spawn, _free_port(), extra, a.device)
        print(json.dumps({"ok": True, "workers": rows}, indent=1))
        return 0
    return _worker(a)


if __name__ == "__main__":
    sys.exit(main())
