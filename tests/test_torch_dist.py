"""The port's parallel/ over ranks on the CPU: four gloo processes started
by the port's own launcher (parallel/multiprocess.py RankGroup), once for
the module, run every job below; the tests read their results.

- The transport bodies over a process group (rows, columns, the 2-D grid,
  gather, sum and the 2-D grid's rc-mb pace) against their tensor-axis
  bodies on the same random int32 planes.
- DP over 4 ranks, row shards over 2 and 4 ranks and the tile program
  itself (halo and allgather, formats 1-4, rc none / vbv / mb, the 2-D
  grid), each against the port's single-device encode; a subset also
  against the reference's ShardedGopEncoder and encode_gop_tiled on the
  fake CPU devices of tests/conftest.py.
- The temporal ring over 4 ranks (rc none, bitrate, vbv; format 4;
  unequal streams) against the single-device GOP engine and the
  reference's RingEncoder (tests/test_aux.py's cases).
- encode_gops_with_recovery with a FaultInjector against the reference's,
  the start/finish seam of ShardedGopEncoder, and the overflow decision
  over a group of two ranks.

Tolerance 0 everywhere: the codec is integer-only."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.config import EncoderConfig as RefConfig
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.parallel import failover as jfailover
from video_encoder_tpu.parallel import gop_parallel as jgop_parallel
from video_encoder_tpu.parallel import ring as jring
from video_encoder_tpu.parallel import tiles as jtiles
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.codec.mux import bit_concat
from video_encoder_tpu_torch.parallel import failover, multiprocess as mp, tiles
from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder
from video_encoder_tpu_torch.parallel.mesh import (make_codec_mesh,
                                                   make_ring_mesh,
                                                   make_tile_mesh_2d)
from video_encoder_tpu_torch.parallel.ring import RingEncoder
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

W, H, T, N_FRAMES, RANKS = 96, 64, 3, 27, 4
TIMEOUT_S = 240.0


def _cfg(**kw):
    return EncoderConfig(width=W, height=H, gop_n=T, **dict(search="full") | kw)


CFGS = {
    "v1": _cfg(base_qp=26),
    "v1-mb": _cfg(base_qp=24, rc="mb", target_kbps=400),
    "v1-vbv": _cfg(base_qp=24, rc="vbv", target_kbps=300),
    "v2-diamond-vbv": _cfg(base_qp=24, format_version=2, chroma_qp_offset=2,
                           search="diamond", rc="vbv", target_kbps=300,
                           vbv_kbits=40),
    "v2-vbv": _cfg(base_qp=24, format_version=2, chroma_qp_offset=2,
                   rc="vbv", target_kbps=300, vbv_kbits=40),
    "v4-mb": _cfg(base_qp=24, format_version=4, chroma_qp_offset=2,
                  quant_matrix=True, intra_slice_mbrows=1, rc="mb",
                  target_kbps=400),
    "v3-islice-qmat": _cfg(base_qp=24, format_version=3, chroma_qp_offset=2,
                           quant_matrix=True, intra_slice_mbrows=1),
}
# (config, 'gop' ranks, 'tile' ranks) of the sharded clip encodes: DP over
# 4 ranks, rows over 2 (two GOPs a batch) and over 4
GOPS = [("v1", 4, 1), ("v2-diamond-vbv", 4, 1), ("v4-mb", 4, 1),
        ("v3-islice-qmat", 4, 1), ("v1", 2, 2), ("v2-vbv", 2, 2),
        ("v4-mb", 2, 2), ("v3-islice-qmat", 2, 2), ("v1-mb", 1, 4),
        ("v3-islice-qmat", 1, 4)]
# the tile program itself: (config, ref_mode, emit) on 4 row ranks, and
# the 2-D grid (config, rows, columns)
TILES = [("v1", "allgather", "frame"), ("v2-vbv", "halo", "chunks"),
         ("v4-mb", "allgather", "chunks"), ("v3-islice-qmat", "halo", "frame")]
GRIDS = [("v1", 2, 2), ("v1-mb", 2, 2), ("v1-vbv", 4, 1)]
# the ring: config, streams as (first frame, length) and their first indices
RINGS = {
    "none": (_cfg(base_qp=30), [(0, 3), (3, 3), (6, 3), (9, 3)]),
    "bitrate": (_cfg(base_qp=30, rc="bitrate", target_kbps=64, fps_num=10),
                [(0, 4), (4, 4), (8, 4), (12, 4)]),
    "vbv": (_cfg(base_qp=30, rc="vbv", target_kbps=64, fps_num=10),
            [(0, 4), (4, 4), (8, 4), (12, 4)]),
    "v4-vbv": (_cfg(base_qp=28, format_version=4, chroma_qp_offset=2,
                    rc="vbv", target_kbps=400), [(0, 3), (3, 3), (6, 3),
                                                 (9, 3)]),
    "unequal": (_cfg(base_qp=30), [(0, 3), (3, 2), (5, 1)]),
}
HALOS = [1, 8, 16]
TRANSPORT = dict(seed=5, shape=[24, 40], halos=HALOS, grid=[2, 2])


def _ring_firsts(streams):
    return [10 * s for s in range(len(streams))]


@functools.lru_cache(maxsize=None)
def _planes():
    """The clip: a smoothed texture panning (2, 3) px a frame, a moving
    square, textured chroma."""
    y, cb, cr = mp.synth_gops(1, N_FRAMES, H, W, seed=3)
    return y[0], cb[0], cr[0]


def _frames(first=0, n=N_FRAMES):
    y, cb, cr = _planes()
    return [Frame.from_planes(y[t], cb[t], cr[t]) for t in range(first, first + n)]


def _schedule(n_gop):
    n_full = N_FRAMES // T
    return [[(k * n_gop + g) * T for g in range(n_gop)]
            for k in range(n_full // n_gop)]


def _tile_kw(cfg, s):
    n_mbs = (H // 16) * (W // 16) // s
    return dict(block_words=entropy.BLOCK_WORDS_MAX,
                cap_words=entropy.max_words(n_mbs),
                row_words=entropy.max_words(W // 16))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job on one group of four CPU ranks: ({job: {batch: {rank:
    result}}}, rows per rank, job indices by name)."""
    clip = str(tmp_path_factory.mktemp("dist") / "clip.yuv")
    y, cb, cr = _planes()
    with open(clip, "wb") as f:
        for t in range(N_FRAMES):
            f.write(y[t].tobytes() + cb[t].tobytes() + cr[t].tobytes())
    jobs, names = [], {}

    def add(name, kind, cfg=None, **kw):
        names[name] = len(jobs)
        if cfg is not None:
            kw.update(cfg=dataclasses.asdict(cfg), clip=clip, width=W, height=H)
        jobs.append(dict(kind=kind, **kw))

    add("transport", "transport", **TRANSPORT)
    for name, g, s in GOPS:
        add(("gops", name, g, s), "gops", CFGS[name], mesh=[g, s],
            schedule=_schedule(g))
    for name, ref_mode, emit in TILES:
        add(("tiles", name, ref_mode, emit), "tiles", CFGS[name], first=3,
            ref_mode=ref_mode, emit=emit, **_tile_kw(CFGS[name], RANKS))
    for name, sr, sc in GRIDS:
        add(("grid", name, sr, sc), "tiles", CFGS[name], first=3,
            grid=[sr, sc], **_tile_kw(CFGS[name], sr * sc))
    for name, (cfg, streams) in RINGS.items():
        add(("ring", name), "ring", cfg, streams=[list(s) for s in streams],
            first_indices=_ring_firsts(streams))
    results, rows = mp.run_jobs(jobs, RANKS, device="cpu", timeout_s=TIMEOUT_S)
    return results, rows, names


def _job(ranks, name):
    results, rows, names = ranks
    j = names[name]
    return results.get(j, {}), [r[j] for r in rows]


# ---- the transport ------------------------------------------------------------

def _transport_want(case):
    """The tensor-axis body's result for the whole group, as the ranks'
    planes are made (parallel/multiprocess.py _job_transport)."""
    n = RANKS
    h, w = TRANSPORT["shape"]
    rng = np.random.default_rng(TRANSPORT["seed"])
    planes = torch.from_numpy(rng.integers(0, 256, (2, n, h, w), dtype=np.int32))
    sr, sc = TRANSPORT["grid"]
    est = torch.from_numpy(rng.integers(0, 4000, (sr, sc, 3, 4)))
    kind = case.rstrip("0123456789")
    halo = int(case[len(kind):] or 0)
    if kind == "rows":
        return tiles.exchange_halo(planes, halo)
    if kind == "cols":
        return tiles.exchange_halo(planes, halo, axis=1)
    if kind == "gather":
        return tiles.gather_ref(planes, halo)
    if kind == "psum":
        return tiles.psum(planes.sum(-1), -2)
    if kind == "2d":
        return tiles.exchange_halo_2d(planes.reshape(2, sr, sc, h, w), halo)
    return tiles.mb_rc_offsets_tile2d(est)


@pytest.mark.parametrize("case", [f"{k}{h}" for k in ("rows", "cols", "gather",
                                                       "2d") for h in HALOS]
                         + ["psum", "mb_rc_2d"])
def test_transport_over_ranks_equals_the_tensor_axis(ranks, case):
    """Each body over the group equals the tensor-axis body, rank by rank:
    the ranks check it themselves (max abs error 0), and their results
    put together equal the body run here on the whole tensor."""
    results, rows = _job(ranks, "transport")
    got = {r: results[0][r][case] for r in range(RANKS)}
    assert all(err == 0 for _, err in got.values())
    want = _transport_want(case).numpy()
    sr, sc = TRANSPORT["grid"]
    for r, (arr, _) in got.items():
        if case.startswith("2d") or case == "mb_rc_2d":
            i, j = divmod(r, sc)
            sl = (slice(None), slice(i, i + 1), slice(j, j + 1))
            if case == "mb_rc_2d":
                sl = sl[1:]
        elif case == "psum":
            sl = (slice(None),)
        else:
            sl = (slice(None), slice(r, r + 1))
        np.testing.assert_array_equal(arr, want[sl])
    assert all(row["max_abs_err"] == 0 and row["backend"] == "gloo"
               for row in rows)


def test_overflow_is_decided_by_the_group(ranks):
    """gop_engine.overflowed over a group of two ranks (mesh.group_max, the
    2 x 2 grid's 'tc' groups), one rank's flag set: both ranks of that
    group decide true, both of the other group false."""
    results, _ = _job(ranks, "transport")
    got = {r: bool(results[0][r]["overflow"][0][0]) for r in range(RANKS)}
    assert got == {0: True, 1: True, 2: False, 3: False}
    assert all(results[0][r]["overflow"][1] == 0 for r in range(RANKS))


# ---- DP and row shards over ranks -----------------------------------------------

@functools.lru_cache(maxsize=None)
def _single(name):
    """{first: (packets, stats)} of the port's single-device GOP engine."""
    eng = GopEngine(CFGS[name], device="cpu")
    frames = _frames()
    return {f: eng.encode_gop(frames[f:f + T], f)
            for f in range(0, N_FRAMES - N_FRAMES % T, T)}


def _gop_results(results):
    got = {}
    for per_rank in results.values():
        for items in per_rank.values():
            for packets, stats in items:
                assert packets[0].index not in got
                got[packets[0].index] = (packets, stats)
    return got


def _same(got, want):
    assert [p.to_bytes() for p in got[0]] == [p.to_bytes() for p in want[0]]
    for a, b in zip(got[1], want[1]):
        assert dataclasses.replace(a, ms=0.0) == dataclasses.replace(b, ms=0.0)
        assert np.isfinite(a.psnr_y) and a.psnr_y > 20


@pytest.mark.parametrize("name,n_gop,n_tile", GOPS)
def test_ranks_match_the_single_device_encode(ranks, name, n_gop, n_tile):
    """Every GOP of every batch: the packets and stats (PSNR from the
    shards' summed sse) of the single-device engine; only tile rank 0
    returns packets; each rank's psum of total bits equals the bits the
    coordinator received; each rank encoded its own GOPs."""
    results, rows = _job(ranks, ("gops", name, n_gop, n_tile))
    got = _gop_results(results)
    want = _single(name)
    sched = _schedule(n_gop)
    assert sorted(got) == sorted(f for b in sched for f in b)
    for f, res in got.items():
        _same(res, want[f])
    total = sum(p.payload_bits for pk, _ in got.values() for p in pk)
    for r, row in enumerate(rows):
        assert row["total_bits"] == total
        assert row["gops"] == [b[r // n_tile] for b in sched]
        assert row["tile"] == r % n_tile and row["device"] == "cpu"
        assert row["transport_bytes"] > 0       # the psum of total bits
    for batch in results.values():
        assert all(items == [] for r, items in batch.items() if r % n_tile)


@functools.lru_cache(maxsize=None)
def _reference_sharded(name, n_gop, n_tile):
    """The reference's ShardedGopEncoder on n_gop x n_tile fake devices,
    batch by batch: {first: packet bytes}."""
    rcfg = RefConfig(**dataclasses.asdict(CFGS[name]))
    y, cb, cr = _planes()
    frames = [golden.Frame.from_planes(y[t], cb[t], cr[t])
              for t in range(N_FRAMES)]
    mesh = Mesh(np.array(jax.devices()[:n_gop * n_tile]).reshape(n_gop, n_tile),
                ("gop", "tile"))
    senc = jgop_parallel.ShardedGopEncoder(rcfg, mesh=mesh)
    out = {}
    jdispatch.force("jnp")
    try:
        for firsts in _schedule(n_gop):
            for p in senc.encode_gop_batch([frames[f:f + T] for f in firsts],
                                           firsts):
                out.setdefault(p.index - p.index % T, []).append(p.to_bytes())
    finally:
        jdispatch.force(None)
    return out


@pytest.mark.parametrize("name,n_gop,n_tile", [("v1", 4, 1), ("v2-vbv", 2, 2)])
def test_ranks_match_the_reference_sharded_encoder(ranks, name, n_gop, n_tile):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (fake) devices")
    got = _gop_results(_job(ranks, ("gops", name, n_gop, n_tile))[0])
    want = _reference_sharded(name, n_gop, n_tile)
    assert {f: [p.to_bytes() for p in pk] for f, (pk, _) in got.items()} == want


def _tiles_single(name, ref_mode, emit, s):
    cfg = CFGS[name]
    y, cb, cr = (torch.from_numpy(np.stack([getattr(f, p) for f in _frames(3, T)]))
                 for p in ("y", "cb", "cr"))
    kw = _tile_kw(cfg, s)
    return tiles.encode_gop_tiled(
        y, cb, cr, cfg.base_qp, mesh=make_codec_mesh(1, s, "cpu"), rc=cfg.rc,
        block_words=kw["block_words"], cap_words=kw["cap_words"],
        target_bits=cfg.target_bits_per_frame(), ref_mode=ref_mode,
        fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
        qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(), qmat=cfg.quant_matrix,
        islice=cfg.intra_slice_mbrows, emit=emit)


@pytest.mark.parametrize("name,ref_mode,emit", TILES)
def test_tile_program_over_ranks_equals_one_device(ranks, name, ref_mode, emit):
    """encode_gop_tiled over 4 row ranks: each rank's tensors equal its
    shard of the one-device program's; the frames' payloads, glued over
    the shards, those of the reference's encode_gop_tiled (v1)."""
    results, _ = _job(ranks, ("tiles", name, ref_mode, emit))
    want = _tiles_single(name, ref_mode, emit, RANKS)
    for r in range(RANKS):
        got = results[0][r]
        for k, v in want.items():
            np.testing.assert_array_equal(
                got[k], v.numpy() if k in ("qp", "ovf") else v[:, r:r + 1].numpy())
    if name != "v1" or len(jax.devices()) < RANKS:
        return
    rcfg = RefConfig(**dataclasses.asdict(CFGS[name]))
    y, cb, cr = (jax.numpy.asarray(np.stack([getattr(f, p)
                                             for f in _frames(3, T)]))
                 for p in ("y", "cb", "cr"))
    kw = _tile_kw(rcfg, RANKS)
    jdispatch.force("jnp")
    try:
        ref = jtiles.encode_gop_tiled(
            y, cb, cr, rcfg.base_qp,
            mesh=Mesh(np.array(jax.devices()[:RANKS]), ("tile",)), rc="none",
            block_words=kw["block_words"], cap_words=kw["cap_words"],
            target_bits=0, ref_mode=ref_mode, emit=emit)
    finally:
        jdispatch.force(None)
    words, bits = np.asarray(ref["words"]), np.asarray(ref["bits"])
    for t in range(T):
        ours = bit_concat([(results[0][r]["words"][t, 0],
                            int(results[0][r]["bits"][t, 0]))
                           for r in range(RANKS)])
        assert ours == jtiles.bit_concat([(words[s, t], int(bits[s, t]))
                                          for s in range(RANKS)])


@pytest.mark.parametrize("name,sr,sc", GRIDS)
def test_tile_grid_over_ranks_equals_one_device(ranks, name, sr, sc):
    """encode_gop_tiled2d with one tile per rank (the row totals and share
    sums of rc mb along the 'tc' group): each rank's tensors equal its
    tile of the one-device program's, and the glued frames its payloads."""
    results, _ = _job(ranks, ("grid", name, sr, sc))
    cfg = CFGS[name]
    y, cb, cr = (torch.from_numpy(np.stack([getattr(f, p) for f in _frames(3, T)]))
                 for p in ("y", "cb", "cr"))
    kw = _tile_kw(cfg, sr * sc)
    want = tiles.encode_gop_tiled2d(
        y, cb, cr, cfg.base_qp, mesh=make_tile_mesh_2d(sr, sc, "cpu"),
        rc=cfg.rc, block_words=kw["block_words"], row_words=kw["row_words"],
        target_bits=cfg.target_bits_per_frame(), qbias=cfg.quant_bias,
        vbv_bits=cfg.vbv_bits())
    for r in range(RANKS):
        i, j = divmod(r, sc)
        for k, v in want.items():
            np.testing.assert_array_equal(
                results[0][r][k],
                v.numpy() if k in ("qp", "ovf") else v[:, i:i + 1, j:j + 1].numpy())


# ---- the ring ----------------------------------------------------------------

def _stream_frames(streams):
    frames = _frames()
    return [frames[a:a + n] for a, n in streams]


@pytest.mark.parametrize("name", sorted(RINGS))
def test_ring_over_ranks_matches_single_device(ranks, name):
    """Each stream of the 4-rank ring equals its single-device GOP-engine
    encode, and the one-device ring (the hop a roll of the stream axis)
    gives the same packets."""
    results, rows = _job(ranks, ("ring", name))
    cfg, streams = RINGS[name]
    firsts = _ring_firsts(streams)
    got = results[0][0]
    eng = GopEngine(cfg, device="cpu")
    want = [eng.encode_gop(s, f)[0]
            for s, f in zip(_stream_frames(streams), firsts)]
    assert [len(s) for s in got] == [n for _, n in streams]
    assert ([[p.to_bytes() for p in s] for s in got]
            == [[p.to_bytes() for p in s] for s in want])
    one = RingEncoder(cfg, make_ring_mesh(RANKS, "cpu")).encode_streams(
        _stream_frames(streams), firsts)
    assert ([[p.to_bytes() for p in s] for s in one]
            == [[p.to_bytes() for p in s] for s in got])
    assert all(row["transport_bytes"] > 0 for row in rows)


@pytest.mark.parametrize("name", ["bitrate", "unequal", "v4-vbv"])
def test_ring_over_ranks_matches_the_reference_ring(ranks, name):
    if len(jax.devices()) < RANKS:
        pytest.skip("needs 4 (fake) devices")
    cfg, streams = RINGS[name]
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    y, cb, cr = _planes()
    ref_streams = [[golden.Frame.from_planes(y[t], cb[t], cr[t])
                    for t in range(a, a + n)] for a, n in streams]
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("ring",))
    jdispatch.force("jnp")
    try:
        want = jring.RingEncoder(rcfg, mesh).encode_streams(
            ref_streams, _ring_firsts(streams))
    finally:
        jdispatch.force(None)
    got = _job(ranks, ("ring", name))[0][0][0]
    assert ([[p.to_bytes() for p in s] for s in got]
            == [[p.to_bytes() for p in s] for s in want])


def test_ring_refuses_more_streams_than_slots():
    ring = RingEncoder(_cfg(), make_ring_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="need 1..2 streams"):
        ring.encode_streams([_frames(0, 1)] * 3, [0, 1, 2])


# ---- failover ------------------------------------------------------------------

def test_recovery_matches_the_reference():
    """encode_gops_with_recovery with a FaultInjector: the port's GOP
    engine retried, then its survivor, give the reference's packets
    (its recovery around its golden GOP adapter); past the budget the
    injected failure propagates."""
    from video_encoder_tpu.pipeline.encoder import GoldenGopAdapter

    cfg = _cfg(base_qp=27)
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    frames = _frames(0, 6)
    y, cb, cr = _planes()
    rframes = [golden.Frame.from_planes(y[t], cb[t], cr[t]) for t in range(6)]
    want = jfailover.encode_gops_with_recovery(
        GoldenGopAdapter(rcfg), [rframes[:3], rframes[3:]], [0, 3],
        fault=jfailover.FaultInjector({3}))
    eng = GopEngine(cfg, device="cpu")
    survivor = GopEngine(cfg, device=failover.survivor_device("cpu"))
    for times in (1, 3):    # retried on the engine; then on the survivor
        fault = failover.FaultInjector({3}, times=times)
        stats = []
        got = failover.encode_gops_with_recovery(
            eng, [frames[:3], frames[3:]], [0, 3], fallback=survivor,
            fault=fault, stats=stats)
        assert fault.injected == times
        assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]
        assert [s.index for s in stats] == list(range(6))
    with pytest.raises(failover.GopFailure):
        failover.encode_gops_with_recovery(
            eng, [frames[:3]], [0], fault=failover.FaultInjector({0}, times=3))
    assert failover.survivor_device("cpu") == torch.device("cpu")


# ---- the start/finish seam -------------------------------------------------------

def test_batch_start_does_not_wait_on_the_device(monkeypatch):
    """start uploads and launches: no host read of a device value (bool,
    item, tolist, numpy, cpu) until finish."""
    cfg = _cfg(base_qp=26)
    senc = ShardedGopEncoder(cfg, make_codec_mesh(2, 2, "cpu"))
    frames = _frames(0, 6)
    reads = []

    def spy(name, real):
        def read(self, *a, **k):
            reads.append(name)
            return real(self, *a, **k)
        return read

    for name in ("__bool__", "__int__", "__float__", "item", "tolist",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name,
                            spy(name, getattr(torch.Tensor, name)))
    handle = senc.start([frames[:3], frames[3:]], [0, 3])
    assert reads == []
    got = senc.finish(handle)
    assert reads                       # the finish waits, once it must
    monkeypatch.undo()
    eng = GopEngine(cfg, device="cpu")
    want = eng.finish(eng.start([frames[:3], frames[3:]], [0, 3]))
    for g, w in zip(got, want):
        _same(g, w)
