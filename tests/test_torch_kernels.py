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

from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec import entropy, tables
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
    frames = [golden.Frame.from_planes(
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
