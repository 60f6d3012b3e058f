"""Each CUDA kernel of the port against its plain PyTorch version on the
card, exact equality (tolerance 0: integer codec), and the GOP engine's
packets on the card against the CPU's. These tests need a CUDA device and
skip without one. The card host has no JAX, so this file needs nothing
from tests/conftest.py; run it there with

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from video_encoder_tpu_torch.codec import entropy, tables
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.ops.kernels import build
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(4321)


@pytest.fixture
def plain_and_kernel():
    def run(fn, *args):
        dispatch.force("plain")
        try:
            want = fn(*args)
        finally:
            dispatch.force(None)
        before = sum(build.LAUNCHES.values())
        got = fn(*args)
        torch.cuda.synchronize()
        assert sum(build.LAUNCHES.values()) == before + 1
        return got, want
    return run


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


@pytest.mark.parametrize("h,w", [(1088, 1920), (368, 640), (48, 80)])
def test_full_search_kernel(cuda, plain_and_kernel, rng, h, w):
    cur = rng.integers(0, 256, (h, w))
    ref = np.roll(cur, (5, -9), (0, 1)) + rng.integers(-2, 3, (h, w))
    cur[:32, :32] = 9
    ref[:48, :48] = 9
    got, want = plain_and_kernel(dispatch.full_search, _t(cur, cuda),
                                 _t(np.clip(ref, 0, 255), cuda))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("bs,h,w", [(16, 1088, 1920), (8, 544, 960),
                                    (16, 368, 640), (8, 184, 320)])
def test_mc_fetch_kernel(cuda, plain_and_kernel, rng, bs, h, w):
    ref = _t(rng.integers(0, 256, (h, w)), cuda)
    dy = rng.integers(-bs, bs + 1, (h // bs, w // bs))
    dx = rng.integers(-bs, bs + 1, (h // bs, w // bs))
    dy[0, 0], dx[0, 0], dy[-1, -1], dx[-1, -1] = -bs, -bs, bs, bs
    fn = dispatch.mc_fetch_luma_plane if bs == 16 else dispatch.mc_fetch_chroma_plane
    got, want = plain_and_kernel(fn, ref, _t(dy, cuda), _t(dx, cuda))
    assert torch.equal(got, want)


@pytest.mark.parametrize("qbias", [8, 5])
@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (368, 640), (24, 40)])
def test_code_plane_kernel(cuda, plain_and_kernel, rng, h, w, qbias):
    cur = rng.integers(0, 256, (h, w))
    pred = np.clip(cur + rng.integers(-40, 41, (h, w)), 0, 255)
    qp = rng.choice([1, 28, 63], (h // 8, w // 8))
    q_blk = tables.load(cuda).QSTEP[_t(qp, cuda).long()].contiguous()
    got, want = plain_and_kernel(dispatch.code_plane, _t(cur, cuda),
                                 _t(pred, cuda), q_blk, qbias)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("qbias", [8, 5])
@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (368, 640), (8, 1920)])
def test_code_plane_qmat_kernel(cuda, plain_and_kernel, rng, h, w, qbias):
    cur = rng.integers(0, 256, (h, w))
    pred = np.clip(cur + rng.integers(-40, 41, (h, w)), 0, 255)
    qp = rng.choice([1, 28, 63], (h // 8, w // 8))
    q_blk = tables.load(cuda).QSTEP[_t(qp, cuda).long()].contiguous()
    got, want = plain_and_kernel(dispatch.code_plane, _t(cur, cuda),
                                 _t(pred, cuda), q_blk, qbias, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = dispatch.code_plane(_t(cur, cuda), _t(pred, cuda), q_blk, qbias)
    assert not torch.equal(got[0], flat[0])       # the matrix took effect


@pytest.mark.parametrize("reset_rows", [0, 2])
def test_intra_rows_on_card(cuda, rng, reset_rows):
    """The v3 I-frame row scan: one code_plane launch per stripe."""
    cur = _t(rng.integers(0, 256, (64, 960)), cuda)
    q_blk = tables.load(cuda).QSTEP[_t(rng.choice([20, 28], (8, 120)), cuda).long()]
    dispatch.force("plain")
    try:
        want = dispatch.intra_rows_code_plane(cur, q_blk, 8, reset_rows, True)
    finally:
        dispatch.force(None)
    build.reset_launches()
    got = dispatch.intra_rows_code_plane(cur, q_blk, 8, reset_rows, True)
    assert build.LAUNCHES["code_plane_qmat"] == 8
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_words", [16, 24, entropy.BLOCK_WORDS_MAX])
@pytest.mark.parametrize("by,bx", [(272, 240), (68, 120), (46, 80)])
def test_block_pack_v2_kernel(cuda, plain_and_kernel, rng, by, bx, n_words):
    """Format-2 syntax on a plane's block grid (1080p luma and chroma,
    368x640 luma) with the left-DC predictor: zero blocks, DC-only
    blocks, dc - pred at +-7850, and dense blocks that overflow."""
    lv = np.zeros((by, bx, 64), np.int64)
    mask = rng.random(lv.shape) < 0.1
    lv[mask] = rng.integers(-300, 301, mask.sum())
    lv[0, :40] = rng.integers(-3925, 3926, (40, 64))   # these overflow 16/24
    lv[1] = 0
    lv[1, ::2, 0] = 3925                               # dc - pred = +-3925
    lv[2] = 0
    lv[2, ::2, 0], lv[2, 1::2, 0] = 3925, -3925        # dc - pred = +-7850
    lv[3] = 0                                          # all-zero blocks
    lvt = _t(lv, cuda)
    dc_pred = entropy._dc_pred_left(lvt).reshape(-1).contiguous()
    got, want = plain_and_kernel(dispatch.block_pack, lvt.reshape(-1, 64),
                                 n_words, dc_pred, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].reshape(by, bx)[3].max()) == 1   # cbf 0 alone
    assert int(got[1].reshape(by, bx)[2, 1:].max()) == 1 + 27 + 1


@pytest.mark.parametrize("n_words", [16, 24, entropy.BLOCK_WORDS_MAX])
def test_block_pack_kernel(cuda, plain_and_kernel, rng, n_words):
    lv = np.zeros((5000, 64), np.int64)
    mask = rng.random(lv.shape) < 0.15
    lv[mask] = rng.integers(-300, 301, mask.sum())
    lv[:50] = rng.integers(-3925, 3926, (50, 64))     # these overflow 16/24
    got, want = plain_and_kernel(dispatch.block_pack, _t(lv, cuda), n_words)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", [(1088, 1920), (368, 640), (48, 80)])
def test_sad_map_even_kernel(cuda, plain_and_kernel, rng, h, w):
    cur = rng.integers(0, 256, (h, w))
    ref = np.roll(cur, (6, -12), (0, 1)) + rng.integers(-2, 3, (h, w))
    cur[:32, :32] = 9
    ref[:48, :48] = 9
    got, want = plain_and_kernel(dispatch.sad_map_even, _t(cur, cuda),
                                 _t(np.clip(ref, 0, 255), cuda))
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,h,w", [(4, 1088, 1920), (1, 368, 640), (3, 48, 80)])
def test_sad_at_mv_kernel(cuda, plain_and_kernel, rng, k, h, w):
    cur = _t(rng.integers(0, 256, (h, w)), cuda)
    ref = _t(rng.integers(0, 256, (h, w)), cuda)
    dy = rng.integers(-16, 17, (k, h // 16, w // 16))
    dx = rng.integers(-16, 17, (k, h // 16, w // 16))
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -16, -16, 16, 16
    got, want = plain_and_kernel(dispatch.sad_at_mv, cur, ref, _t(dy, cuda),
                                 _t(dx, cuda))
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(1088, 1920), (368, 640)])
def test_sad_at_mv_kernel_on_planes(cuda, plain_and_kernel, rng, h, w):
    """Nine candidates, each on its own plane of four, in one launch: all
    [9, H/16, W/16] SADs equal the plain version's."""
    plane_of = [3, 2, 3, 1, 0, 1, 3, 2, 3]
    cur = _t(rng.integers(0, 256, (h, w)), cuda)
    planes = _t(rng.integers(0, 256, (4, h, w)), cuda)
    dy = rng.integers(-16, 17, (9, h // 16, w // 16))
    dx = rng.integers(-16, 17, (9, h // 16, w // 16))
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -16, -16, 16, 16
    build.reset_launches()
    got, want = plain_and_kernel(dispatch.sad_at_mv, cur, planes, _t(dy, cuda),
                                 _t(dx, cuda), plane_of)
    assert build.LAUNCHES["sad_at_mv"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,h,w", [(4, 544, 960), (1, 184, 320), (3, 24, 40)])
def test_sad_at_mv_chroma_kernel(cuda, plain_and_kernel, rng, k, h, w):
    cur = _t(rng.integers(0, 256, (h, w)), cuda)
    ref = _t(rng.integers(0, 256, (h, w)), cuda)
    dy = rng.integers(-8, 9, (k, h // 8, w // 8))
    dx = rng.integers(-8, 9, (k, h // 8, w // 8))
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -8, -8, 8, 8
    got, want = plain_and_kernel(dispatch.sad_at_mv_chroma, cur, ref,
                                 _t(dy, cuda), _t(dx, cuda))
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(1088, 1920), (368, 640), (48, 80)])
def test_hpel_refine_on_card(cuda, plain_and_kernel, rng, h, w):
    """The nine half-pel candidates in one sad_at_mv launch over the four
    parity planes, with vectors on the +-16 edge and a flat tied region."""
    cur = rng.integers(0, 256, (h, w))
    ref = np.roll(cur, (1, -2), (0, 1)) + rng.integers(-2, 3, (h, w))
    cur[:32, :32] = 9
    ref[:48, :48] = 9
    dy = rng.integers(-16, 17, (h // 16, w // 16))
    dx = rng.integers(-16, 17, (h // 16, w // 16))
    dy[0], dx[:, 0], dy[-1], dx[:, -1] = -16, -16, 16, 16
    got, want = plain_and_kernel(dispatch.hpel_refine, _t(cur, cuda),
                                 _t(np.clip(ref, 0, 255), cuda), _t(dy, cuda),
                                 _t(dx, cuda))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert int(got[0].abs().max()) <= 32 and int(got[1].abs().max()) <= 32
    assert bool(((got[0] & 1) | (got[1] & 1)).any())    # some half-pel wins


def _sources(rng, n_mbs, w, dense, dev):
    bits = np.full((n_mbs, 8), 300) if dense else rng.integers(0, 200, (n_mbs, 8))
    bits[:, 0] = np.minimum(bits[:, 0], 38)
    bits[:, 7] = 0
    words = np.zeros((n_mbs, 8, w), np.int64)
    col = np.arange(w)[None, None, :] * 32
    keep = np.clip(bits[..., None] - col, 0, 32)
    vals = rng.integers(0, 2**32, words.shape, dtype=np.uint64)
    words = (vals >> (32 - keep).astype(np.uint64) << (32 - keep).astype(np.uint64))
    words = torch.from_numpy(words.astype(np.int64)).to(dev)
    return (words[:, 0, :2].contiguous(), words[:, 1:5].contiguous(),
            words[:, 5].contiguous(), words[:, 6].contiguous(),
            _t(bits.reshape(-1), dev))


@pytest.mark.parametrize("n_mbs,w,dense", [(8160, 16, False), (240, 16, False),
                                           (128, 16, True), (100, 78, False)])
def test_span_merge_kernels(cuda, plain_and_kernel, rng, n_mbs, w, dense):
    from video_encoder_tpu_torch.codec import pack

    plan = pack.span_plan(n_mbs, w)
    src = _sources(rng, n_mbs, w, dense, cuda)
    got, want = plain_and_kernel(dispatch.span_merge_mb, *src, plan.m1,
                                 plan.cw1, plan.n1)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert bool(got[2]) == dense
    if plan.two_stage:
        got2, want2 = plain_and_kernel(dispatch.span_merge, got[0], got[1],
                                       plan.g, plan.stop, plan.cwf)
        for g, w_ in zip(got2, want2):
            assert torch.equal(g, w_)


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("search,rc", [("full", "none"), ("diamond", "mb")])
def test_gop_engine_on_card_matches_cpu(cuda, rng, search, rc, emit):
    base = rng.integers(0, 256, (80, 112))
    frames = [Frame.from_planes(
        base[2 * t:2 * t + 64, 3 * t:3 * t + 96].astype(np.uint8),
        np.full((32, 48), 100 + t, np.uint8), np.full((32, 48), 150, np.uint8))
        for t in range(4)]
    cfg = EncoderConfig(width=96, height=64, gop_n=4, base_qp=24,
                        search=search, rc=rc, target_kbps=300)
    build.reset_launches()
    got, _ = GopEngine(cfg, device=cuda, emit=emit).encode_gop(frames, 0)
    used = ["mc_fetch_luma", "mc_fetch_chroma", "code_plane", "block_pack"]
    used += ["full_search"] if search == "full" else ["sad_map_even", "sad_at_mv"]
    used += ["span_merge_mb"] if emit == "chunks" else []
    assert all(build.LAUNCHES[k] > 0 for k in used), build.LAUNCHES
    want, _ = GopEngine(cfg, device="cpu", emit=emit).encode_gop(frames, 0)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("kw", [
    dict(format_version=2, chroma_qp_offset=4, search="diamond", rc="vbv",
         target_kbps=300),
    dict(format_version=3, quant_matrix=True, intra_slice_mbrows=2,
         rc="adaptive"),
    dict(format_version=3, rc="mb", target_kbps=300),
    dict(format_version=4, quant_matrix=True, chroma_qp_offset=2),
    dict(format_version=4, search="diamond", quant_bias=5),
    dict(format_version=2, base_qp=4),                  # overflow rerun
], ids=lambda kw: "-".join(f"{k[:6]}{v}" for k, v in kw.items()))
def test_gop_engine_formats_on_card_match_cpu(cuda, rng, kw, emit):
    big = rng.integers(0, 256, (176, 240)).astype(np.int64)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1) + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for t in range(4):      # 2x2 means at an odd offset: true half-pel motion
        o = big[3 * t:3 * t + 128, 5 * t:5 * t + 192]
        y = (o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2] + 2) // 4
        frames.append(Frame.from_planes(
            y.astype(np.uint8), np.full((32, 48), 100 + t, np.uint8),
            np.full((32, 48), 150, np.uint8)))
    cfg = EncoderConfig(**{**dict(width=96, height=64, gop_n=4, base_qp=24), **kw})
    build.reset_launches()
    got, _ = GopEngine(cfg, device=cuda, emit=emit).encode_gop(frames, 0)
    used = ["mc_fetch_luma", "mc_fetch_chroma", "block_pack_v2",
            "code_plane_qmat" if cfg.quant_matrix else "code_plane"]
    used += ["sad_at_mv"] if cfg.format_version == 4 else []
    assert all(build.LAUNCHES[k] > 0 for k in used), build.LAUNCHES
    assert build.LAUNCHES["block_pack"] == 0
    want, _ = GopEngine(cfg, device="cpu", emit=emit).encode_gop(frames, 0)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]
