"""The tile-sharded encode of the port (parallel/tiles.py,
ShardedGopEncoder, `--tile S`) on the CPU, at the sizes of
tests/test_parallel.py (64x32 in 4 row shards; 64x128 on the 2-D grid):
its payloads, glued over the shards, equal byte for byte the reference's
tiled encode on the fake-device CPU mesh and the port's own unsharded
encode, for formats 1 to 4, rc none / vbv / mb, both ref_modes and both
emits. Tolerance 0: the codec is integer-only."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from conftest import make_clip
from video_encoder_tpu.codec import entropy as jentropy
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.parallel import gop_parallel as jgop_parallel
from video_encoder_tpu.parallel import tiles as jtiles
from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.codec.mux import bit_concat
from video_encoder_tpu_torch.parallel import tiles
from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder
from video_encoder_tpu_torch.parallel.mesh import (make_codec_mesh,
                                                   make_tile_mesh_2d)
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

H, W, NTILE = 64, 32, 4


def _smooth_planes(h, w, n, slide=3, seed=1234):
    """tests/test_parallel.py's clip: a smoothed texture sliding (2, slide)
    px per frame, flat chroma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, 2, 1)) // 4
    return [(base[2 * t:2 * t + h, slide * t:slide * t + w].astype(np.uint8),
             np.full((h // 2, w // 2), 90 + t, np.uint8),
             np.full((h // 2, w // 2), 150, np.uint8)) for t in range(n)]


def _stack(clip, lib):
    return tuple(lib(np.stack([p[i] for p in clip])) for i in range(3))


def _word_bytes(words, nbits):
    """A payload from MSB-first 32-bit words (any integer dtype)."""
    return bit_concat([(np.asarray(words), int(nbits))])[0]


# name -> (config fields, frames)
_TILED = {
    "v1": (dict(base_qp=30), 2),
    "v2": (dict(base_qp=24, format_version=2, chroma_qp_offset=2), 2),
    "rc-vbv": (dict(base_qp=24, rc="vbv", target_kbps=50, vbv_kbits=10), 3),
    "rc-mb": (dict(base_qp=24, rc="mb", target_kbps=300), 3),
    "v3-islice": (dict(base_qp=24, format_version=3, chroma_qp_offset=2,
                       intra_slice_mbrows=1), 2),
    "v3-islice-qmat": (dict(base_qp=24, format_version=3, chroma_qp_offset=2,
                            intra_slice_mbrows=1, quant_matrix=True), 2),
    "v3-islice-mb": (dict(base_qp=24, format_version=3, chroma_qp_offset=2,
                          intra_slice_mbrows=1, rc="mb", target_kbps=300), 2),
    "v4": (dict(base_qp=24, format_version=4, chroma_qp_offset=2,
                intra_slice_mbrows=1), 3),
}


def _cfg(case):
    kw, t = _TILED[case]
    return EncoderConfig(width=W, height=H, gop_n=t, search="full", **kw), t


def _tile_kw(cfg, lib_entropy, emit):
    n_mbs_shard = (H // NTILE // 16) * (W // 16)
    return dict(rc=cfg.rc, block_words=lib_entropy.BLOCK_WORDS_MAX,
                cap_words=lib_entropy.max_words(n_mbs_shard),
                target_bits=cfg.target_bits_per_frame(),
                fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
                qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(),
                qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows, emit=emit)


@functools.lru_cache(maxsize=None)
def _reference_payloads(case, ref_mode, emit):
    """Per-frame (payload bytes, bits) of the reference's encode_gop_tiled
    on a 4-device CPU mesh, its shards glued by its bit_concat."""
    cfg, t = _cfg(case)
    y, cb, cr = _stack(_smooth_planes(H, W, t), jnp.asarray)
    mesh = Mesh(np.array(jax.devices()[:NTILE]), ("tile",))
    jdispatch.force("jnp")
    try:
        outs = jtiles.encode_gop_tiled(
            y, cb, cr, cfg.base_qp, mesh=mesh, ref_mode=ref_mode,
            **_tile_kw(cfg, jentropy, emit))
    finally:
        jdispatch.force(None)
    assert not bool(np.asarray(outs["ovf"]).any())
    words, bits = np.asarray(outs["words"]), np.asarray(outs["bits"])
    frames = []
    for k in range(t):
        if emit == "chunks":
            strings = [(words[s, k, c], int(bits[s, k, c])) for s in range(NTILE)
                       for c in range(bits.shape[2]) if bits[s, k, c]]
        else:
            strings = [(words[s, k], int(bits[s, k])) for s in range(NTILE)]
        frames.append(jtiles.bit_concat(strings))
    return frames


def _port_payloads(outs, t, emit):
    """Per-frame (payload bytes, bits) of the port's [T, S, ...] results."""
    words = outs["words"].numpy()
    frames = []
    for k in range(t):
        if emit == "chunks":
            cbits = outs["cbits"].numpy()
            strings = [(words[k, s, c], int(cbits[k, s, c])) for s in range(NTILE)
                       for c in range(cbits.shape[2]) if cbits[k, s, c]]
        else:
            strings = [(words[k, s], int(outs["bits"][k, s])) for s in range(NTILE)]
        frames.append(bit_concat(strings))
    return frames


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("ref_mode", ["halo", "allgather"])
@pytest.mark.parametrize("case", sorted(_TILED))
def test_tiled_gop_matches_reference_and_unsharded(case, ref_mode, emit):
    if len(jax.devices()) < NTILE:
        pytest.skip("needs 4 (fake) devices")
    rcfg, t = _cfg(case)
    # the reference side: both ref_modes for formats 1 and 4 (where the
    # modes differ in code), both emits for format 1 and 2; else halo, frame
    r_mode = ref_mode if case in ("v1", "v4") else "halo"
    r_emit = emit if case in ("v1", "v2") else "frame"
    want = _reference_payloads(case, r_mode, r_emit)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    clip = _smooth_planes(H, W, t)
    y, cb, cr = _stack(clip, torch.from_numpy)
    outs = tiles.encode_gop_tiled(
        y, cb, cr, cfg.base_qp, mesh=make_codec_mesh(1, NTILE, "cpu"),
        ref_mode=ref_mode, **_tile_kw(cfg, entropy, emit))
    assert not bool(outs["ovf"].any())
    got = _port_payloads(outs, t, emit)
    assert got == want
    unsharded, stats = GopEngine(cfg, device="cpu").encode_gop(
        [Frame.from_planes(*p) for p in clip], 0)
    assert [(p.payload, p.payload_bits) for p in unsharded] == got
    assert outs["qp"].tolist() == [p.base_qp for p in unsharded]
    assert outs["bits"].sum(1).tolist() == [p.payload_bits for p in unsharded]
    assert outs["n_inter"].sum(1).tolist() == [s.n_inter_mb for s in stats]
    assert int(outs["n_inter"].sum()) > 0
    if case.startswith("rc-"):
        assert len(set(outs["qp"].tolist())) > 1        # the carry moved


def test_tiled_v3_requires_islice():
    y, cb, cr = _stack(_smooth_planes(H, W, 2), torch.from_numpy)
    kw = dict(mesh=make_codec_mesh(1, NTILE, "cpu"), rc="none",
              block_words=entropy.BLOCK_WORDS_MAX,
              cap_words=entropy.max_words(2), target_bits=0)
    with pytest.raises(ValueError, match="intra_slice_mbrows"):
        tiles.encode_gop_tiled(y, cb, cr, 24, fmt=3, **kw)
    with pytest.raises(ValueError, match=r"per-shard MB rows \(2\)"):
        tiles.encode_gop_tiled(y, cb, cr, 24, fmt=4, islice=4,
                               **dict(kw, mesh=make_codec_mesh(1, 2, "cpu")))
    with pytest.raises(ValueError, match="do not divide"):
        tiles.encode_gop_tiled(y, cb, cr, 24, **dict(
            kw, mesh=make_codec_mesh(1, 3, "cpu")))


def test_haloed_kernels_are_the_tile_path(monkeypatch):
    """Every P step goes through the pre-haloed search and one pre-haloed
    predictor for its three planes (plus one refine under format 4), never
    through the unsharded ones nor a single-plane fetch; I frames run no
    search and no exchange."""
    from video_encoder_tpu_torch.ops import dispatch

    counts = {}
    for name in ("full_search_pre_haloed", "mc_predict_pre_haloed",
                 "mc_fetch_pre_haloed", "sad_at_mv_pre_haloed", "full_search",
                 "mc_predict", "mc_fetch_luma_plane", "mc_fetch_chroma_plane",
                 "sad_at_mv"):
        real = getattr(dispatch, name)
        monkeypatch.setattr(dispatch, name, lambda *a, _n=name, _f=real, **kw: (
            counts.__setitem__(_n, counts.get(_n, 0) + 1) or _f(*a, **kw)))
    exchanges = []
    real_x = tiles.exchange_halo
    monkeypatch.setattr(tiles, "exchange_halo", lambda *a, **kw: (
        exchanges.append(1) or real_x(*a, **kw)))
    for case, want in (("v1", dict(full_search_pre_haloed=1, mc_predict_pre_haloed=1)),
                       ("v4", dict(full_search_pre_haloed=2, mc_predict_pre_haloed=2,
                                   sad_at_mv_pre_haloed=2))):
        counts.clear()
        exchanges.clear()
        rcfg, t = _cfg(case)
        cfg = config_from_dict(dataclasses.asdict(rcfg))
        y, cb, cr = _stack(_smooth_planes(H, W, 1), torch.from_numpy)
        kw = dict(mesh=make_codec_mesh(1, NTILE, "cpu"), **_tile_kw(cfg, entropy, "frame"))
        tiles.encode_gop_tiled(y, cb, cr, cfg.base_qp, **kw)       # an I frame
        assert counts == {} and exchanges == []
        y, cb, cr = _stack(_smooth_planes(H, W, t), torch.from_numpy)
        tiles.encode_gop_tiled(y, cb, cr, cfg.base_qp, **kw)
        assert counts == want
        assert len(exchanges) > 0


# ---- ShardedGopEncoder -----------------------------------------------------

_SHARDED = {
    "v1": (dict(base_qp=27), 2, 8),
    "v2-vbv": (dict(base_qp=24, rc="vbv", target_kbps=50, vbv_kbits=10,
                    format_version=2, chroma_qp_offset=2), 3, 4),
}


@functools.lru_cache(maxsize=None)
def _reference_sharded(case, n_gop, n_tile):
    kw, t, g = _SHARDED[case]
    rcfg = EncoderConfig(width=W, height=H, gop_n=t, search="full", **kw)
    frames = [golden.Frame.from_planes(*p) for p in _smooth_planes(H, W, g * t)]
    gops = [frames[i:i + t] for i in range(0, g * t, t)]
    mesh = Mesh(np.array(jax.devices()[:n_gop * n_tile]).reshape(n_gop, n_tile),
                ("gop", "tile"))
    jdispatch.force("jnp")
    try:
        pk = jgop_parallel.ShardedGopEncoder(rcfg, mesh=mesh).encode_gop_batch(
            gops, [i * t for i in range(g)])
    finally:
        jdispatch.force(None)
    return rcfg, sorted((p.index, p.to_bytes()) for p in pk)


@pytest.mark.parametrize("case,n_gop,n_tile", [
    ("v1", 4, 2), ("v1", 2, 4), ("v2-vbv", 4, 2)])
def test_sharded_encoder_matches_reference_and_encode_gops(case, n_gop, n_tile):
    """(G, S) = (4, 2) and (2, 4): the reference's ShardedGopEncoder on an
    8-device CPU mesh takes 8 GOPs at once over its 'gop' axis (local
    batches of 2 or 4); the port takes G per call. Same packets, and the
    port's unsharded lockstep encode's packets and stats (the shards'
    sse summed: the reference drops it on this path)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (fake) devices")
    _, t, g = _SHARDED[case]
    rcfg, want = _reference_sharded(case, n_gop, n_tile)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    frames = [Frame.from_planes(*p) for p in _smooth_planes(H, W, g * t)]
    gops = [frames[i:i + t] for i in range(0, g * t, t)]
    firsts = [i * t for i in range(g)]
    senc = ShardedGopEncoder(cfg, make_codec_mesh(n_gop, n_tile, "cpu"))
    assert (senc.n_gop_devices, senc.n_tile_devices) == (n_gop, n_tile)
    got = []
    for i in range(0, g, n_gop):
        got += senc.finish(senc.start(gops[i:i + n_gop], firsts[i:i + n_gop]))
    assert sorted((p.index, p.to_bytes()) for pk, _ in got for p in pk) == want
    eng = GopEngine(cfg, device="cpu")
    plain = eng.finish(eng.start(gops, firsts))
    for (gp, gs), (pp, ps) in zip(got, plain):
        assert [p.to_bytes() for p in gp] == [p.to_bytes() for p in pp]
        for a, b in zip(gs, ps):
            assert dataclasses.replace(a, ms=0.0) == dataclasses.replace(b, ms=0.0)
            assert np.isfinite(a.psnr_y) and a.psnr_y > 20


@pytest.mark.parametrize("n_tile", [2, 4])
def test_sharded_encoder_reruns_an_overflowing_batch(rng, n_tile, monkeypatch):
    """Black-and-white luma noise overflows the 16-word block budget of
    the first run at qp 28 (span strings of worst-case blocks are exact);
    the batch is run again at the exact worst case, to the unsharded
    bytes."""
    def noise(h, w):     # black-and-white noise: the largest residuals
        return (rng.integers(0, 2, (h, w)) * 255).astype(np.uint8)

    clip = [(noise(H, W), rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
            for _ in range(4)]
    frames = [Frame.from_planes(*p) for p in clip]
    gops, firsts = [frames[:2], frames[2:]], [0, 2]
    cfg = config_from_dict(dict(width=W, height=H, gop_n=2, base_qp=28))
    senc = ShardedGopEncoder(cfg, make_codec_mesh(2, n_tile, "cpu"))
    runs = []
    real = senc.run
    monkeypatch.setattr(senc, "run", lambda *a, xl=False: (
        runs.append(xl) or real(*a, xl=xl)))
    got = senc.finish(senc.start(gops, firsts))
    assert runs == [False, True]
    eng = GopEngine(cfg, device="cpu")
    want = eng.finish(eng.start(gops, firsts))
    for (gp, gs), (wp, ws) in zip(got, want):
        assert [p.to_bytes() for p in gp] == [p.to_bytes() for p in wp]
        assert [s.psnr_y for s in gs] == [s.psnr_y for s in ws]


def test_sharded_encoder_with_one_tile_is_encode_gops():
    """With one tile the sharded encoder's start is the engine's: its
    lockstep launch for two GOPs, its single-plane launch for one, and the
    engine's bytes."""
    cfg = config_from_dict(dict(width=W, height=H, gop_n=2, search="diamond"))
    frames = [Frame.from_planes(*p) for p in _smooth_planes(H, W, 4)]
    gops = [frames[:2], frames[2:]]
    senc = ShardedGopEncoder(cfg, make_codec_mesh(2, 1, "cpu"))
    launch = senc.start(gops, [0, 2], [30, 30])
    assert launch.run == senc.engine.run_batch and launch.y.shape[:2] == (2, 2)
    got = senc.finish(launch)
    eng = GopEngine(cfg, device="cpu")
    want = eng.finish(eng.start(gops, [0, 2], [30, 30]))
    assert ([p.to_bytes() for pk, _ in got for p in pk]
            == [p.to_bytes() for pk, _ in want for p in pk])
    assert got[0][0][0].base_qp == 30
    one = ShardedGopEncoder(cfg, make_codec_mesh(1, 1, "cpu"))
    launch = one.start(gops[:1], [0], [30])
    assert launch.run == one.engine.run and launch.y.ndim == 3
    assert ([p.to_bytes() for p in one.finish(launch)[0][0]]
            == [p.to_bytes() for p in want[0][0]])


def test_sharded_encoder_preconditions():
    cfg = config_from_dict(dict(width=W, height=H, gop_n=2))
    mesh = make_codec_mesh(2, 2, "cpu")
    with pytest.raises(ValueError, match="search='full'"):
        ShardedGopEncoder(dataclasses.replace(cfg, search="diamond"), mesh)
    with pytest.raises(ValueError, match="intra_slice_mbrows"):
        ShardedGopEncoder(dataclasses.replace(cfg, format_version=3), mesh)
    with pytest.raises(ValueError, match="do not divide"):
        ShardedGopEncoder(cfg, make_codec_mesh(1, 3, "cpu"))
    senc = ShardedGopEncoder(cfg, mesh)
    frames = [Frame.from_planes(*p) for p in _smooth_planes(H, W, 3)]
    with pytest.raises(ValueError, match="2 on its gop axis"):
        senc.start([frames[:2]], [0])
    with pytest.raises(ValueError, match="equal length"):
        senc.start([frames[:2], frames[2:]], [0, 2])
    if not torch.cuda.is_available():    # the mesh's device defaults to the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedGopEncoder(cfg, make_codec_mesh(2, 2))


# ---- the 2-D tile grid ----------------------------------------------------

def test_pack_frame_rows_concat_equals_frame(rng):
    """The per-MB-row strings glue to exactly the frame pack."""
    nby, nbx = 4, 6

    def levels(by, bx):
        return (rng.integers(-3, 4, (by, bx, 64))
                * (rng.random((by, bx, 64)) < 0.2)).astype(np.int32)

    lz_y, lz_c = levels(2 * nby, 2 * nbx), levels(nby, nbx)
    qpd = rng.integers(-2, 3, (nby, nbx)).astype(np.int32)
    inter = rng.random((nby, nbx)) < 0.7
    dy = rng.integers(-8, 9, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-8, 9, (nby, nbx)).astype(np.int32)
    bw, cap = entropy.BLOCK_WORDS_MAX, entropy.max_words(nby * nbx)
    row_words = entropy.max_words(nbx)
    t = torch.from_numpy
    args = (t(lz_y), t(lz_c), t(lz_c), t(qpd), True, t(inter), t(dy), t(dx), bw)
    w_f, bits_f, mb_f, ovf_f = entropy.pack_frame_planes(*args, cap)
    w_r, bits_r, mb_r, ovf_r = entropy.pack_frame_rows(*args, row_words)
    assert not bool(ovf_f) and not bool(ovf_r)
    assert w_r.shape == (nby, row_words) and torch.equal(mb_r, mb_f)
    payload, nbits = bit_concat([(w_r[r].numpy(), int(bits_r[r])) for r in range(nby)])
    assert nbits == int(bits_f) and payload == _word_bytes(w_f.numpy(), nbits)
    # two frames at once: each row string is its frame's own
    two = tuple(torch.stack([a, a.flip(0)]) if isinstance(a, torch.Tensor) else a
                for a in args)
    w2, b2, _, _ = entropy.pack_frame_rows(*two, row_words)
    assert torch.equal(w2[0], w_r) and torch.equal(b2[0], bits_r)
    assert bool(entropy.pack_frame_rows(*args, int(bits_r.max()) // 32 - 1)[3])


_GRID = {"none": dict(), "vbv": dict(rc="vbv", target_kbps=80, vbv_kbits=16),
         "mb": dict(rc="mb", target_kbps=80)}


@functools.lru_cache(maxsize=None)
def _reference_grid(sr, sc, rc):
    h, w, t = 64, 128, 3
    rcfg = EncoderConfig(width=w, height=h, gop_n=t, base_qp=26, search="full",
                         **_GRID[rc])
    y, cb, cr = _stack(_smooth_planes(h, w, t, slide=5), jnp.asarray)
    mesh = Mesh(np.array(jax.devices()[:sr * sc]).reshape(sr, sc), ("tr", "tc"))
    jdispatch.force("jnp")
    try:
        outs = jtiles.encode_gop_tiled2d(
            y, cb, cr, 26, mesh=mesh, rc=rcfg.rc,
            block_words=jentropy.BLOCK_WORDS_MAX,
            row_words=jentropy.max_words(w // sc // 16),
            target_bits=rcfg.target_bits_per_frame(), vbv_bits=rcfg.vbv_bits())
    finally:
        jdispatch.force(None)
    words, row_bits = np.asarray(outs["words"]), np.asarray(outs["row_bits"])
    return rcfg, [jtiles.assemble_frame_2d(words, row_bits, k) for k in range(t)]


@pytest.mark.parametrize("sr,sc,rc", [(2, 2, "none"), (2, 2, "vbv"),
                                      (2, 2, "mb"), (1, 4, "mb")])
def test_tile2d_matches_reference_and_unsharded(sr, sc, rc):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (fake) devices")
    h, w, t = 64, 128, 3
    rcfg, want = _reference_grid(sr, sc, rc)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    clip = _smooth_planes(h, w, t, slide=5)
    y, cb, cr = _stack(clip, torch.from_numpy)
    outs = tiles.encode_gop_tiled2d(
        y, cb, cr, 26, mesh=make_tile_mesh_2d(sr, sc, "cpu"), rc=cfg.rc,
        block_words=entropy.BLOCK_WORDS_MAX,
        row_words=entropy.max_words(w // sc // 16),
        target_bits=cfg.target_bits_per_frame(), vbv_bits=cfg.vbv_bits())
    assert not bool(outs["ovf"].any())
    assert outs["words"].shape[:4] == (t, sr, sc, h // 16 // sr)
    words, row_bits = outs["words"].numpy(), outs["row_bits"].numpy()
    got = [tiles.assemble_frame_2d(words, row_bits, k) for k in range(t)]
    assert got == want
    unsharded, stats = GopEngine(cfg, device="cpu").encode_gop(
        [Frame.from_planes(*p) for p in clip], 0)
    assert [(p.payload, p.payload_bits) for p in unsharded] == got
    assert outs["qp"].tolist() == [p.base_qp for p in unsharded]
    assert outs["n_inter"].sum((1, 2)).tolist() == [s.n_inter_mb for s in stats]
    if rc != "none":
        assert len(set(outs["qp"].tolist())) > 1


def test_tile2d_rejects_other_formats_and_grids():
    y, cb, cr = _stack(_smooth_planes(64, 128, 2), torch.from_numpy)
    kw = dict(rc="none", block_words=entropy.BLOCK_WORDS_MAX,
              row_words=entropy.max_words(4), target_bits=0)
    for fmt in (2, 4):
        with pytest.raises(ValueError, match="v1 only"):
            tiles.encode_gop_tiled2d(y, cb, cr, 26, fmt=fmt,
                                     mesh=make_tile_mesh_2d(2, 2, "cpu"), **kw)
    with pytest.raises(ValueError, match="column shards"):
        tiles.encode_gop_tiled2d(y, cb, cr, 26,
                                 mesh=make_tile_mesh_2d(2, 3, "cpu"), **kw)


# ---- the CLI ---------------------------------------------------------------

@pytest.fixture
def clip_file(rng, tmp_path):
    """64x64, 11 frames: at GOP 3, three full GOPs and a short one of 2."""
    clip = make_clip(rng, 64, 64, 11)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    return str(path)


def _encode(path, out, *extra):
    return cli.main(["encode", "-i", path, "-W", "64", "-H", "64", "-o", str(out),
                     "--gop", "3", "--qp", "26", "--device", "cpu", *extra])


@pytest.mark.parametrize("flags", [
    [], ["--format", "2", "--chroma-qp-offset", "2", "--rc", "vbv", "--kbps", "200"],
    ["--format", "4", "--quant-matrix", "--intra-slice", "1"]],
    ids=["v1", "v2-vbv", "v4-qmat"])
def test_cli_tile_gives_the_plain_file(clip_file, tmp_path, capsys, flags):
    """`--tile 2` and `--gop-batch 2 --tile 2` write the file the plain
    encode writes; the tail (a full GOP short of a batch, the short last
    GOP) goes through the single-device engine."""
    plain, tiled, both = (tmp_path / n for n in ("p.tvc", "t.tvc", "b.tvc"))
    assert _encode(clip_file, plain, *flags) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _encode(clip_file, tiled, "--tile", "2", *flags) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _encode(clip_file, both, "--gop-batch", "2", "--tile", "2", "-v",
                   *flags) == 0
    verbose = capsys.readouterr()
    assert tiled.read_bytes() == plain.read_bytes()
    assert both.read_bytes() == plain.read_bytes()
    assert got["frames"] == 11 and got["mean_psnr_y"] == want["mean_psnr_y"]
    per_frame = [json.loads(ln) for ln in verbose.err.splitlines()
                 if ln.startswith("{")]
    assert len(per_frame) == 11 and all(s["psnr_y"] > 20 for s in per_frame)


@pytest.mark.parametrize("extra", [
    ["--tile", "2", "--search", "diamond"],
    ["--tile", "2", "--two-pass", "--kbps", "300"],
    ["--tile", "3"],                                   # 4 MB rows
    ["--tile", "2", "--format", "3"],                  # no intra slices
    ["--tile", "0"],
    ["--tile", "2", "--devices", "3"],                 # 3 ranks, 2 tiles
    ["--devices", "2", "--two-pass", "--kbps", "300"],
    ["--multiprocess", "2", "--engine", "device"],
    ["--tile", "2", "--failover", "--gop-batch", "2"],
])
def test_cli_tile_preconditions_exit_2(clip_file, tmp_path, capsys, extra):
    out = tmp_path / "x.tvc"
    assert _encode(clip_file, out, *extra) == 2
    err = capsys.readouterr().err
    assert "error" in err
    assert not out.exists()             # checked before the file is opened
    ranked = {"--devices", "--multiprocess", "--failover"} & set(extra)
    if ranked:                          # the message names the flag at fault
        assert any(flag in err for flag in ranked)
