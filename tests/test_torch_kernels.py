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


# the single-plane fetches, which no encode path launches since the
# predictor serves a P step in one launch
_SINGLE_FETCHES = ("mc_fetch_luma", "mc_fetch_chroma", "mc_fetch_luma_g",
                   "mc_fetch_chroma_g", "mc_fetch_haloed_luma",
                   "mc_fetch_haloed_chroma")


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
    """The v3 I-frame row scan: one code_plane_rows launch per plane, no
    code_plane launch."""
    cur = _t(rng.integers(0, 256, (64, 960)), cuda)
    q_blk = tables.load(cuda).QSTEP[_t(rng.choice([20, 28], (8, 120)), cuda).long()]
    dispatch.force("plain")
    try:
        want = dispatch.intra_rows_code_plane(cur, q_blk, 8, reset_rows, True)
    finally:
        dispatch.force(None)
    build.reset_launches()
    got = dispatch.intra_rows_code_plane(cur, q_blk, 8, reset_rows, True)
    assert build.LAUNCHES["code_plane_rows"] == 1
    assert sum(build.LAUNCHES.values()) == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _row_scan_case(rng, lead, h, w):
    """A plane (or planes) with vertical structure, so that the recon row
    above predicts well, and steps mixing qp 1, 12, 28 and 63."""
    base = rng.integers(0, 256, (*lead, h + 1, w))
    cur = (base[..., :h, :] + base[..., 1:, :]) // 2
    qp = rng.choice([1, 12, 28, 63], (*lead, h // 8, w // 8))
    return cur, qp


@pytest.mark.parametrize("g", [None, 3])
@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("reset_rows", [0, 17])
@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (368, 640)])
def test_row_scan_kernel(cuda, plain_and_kernel, rng, h, w, reset_rows, qmat, g):
    """code_plane_rows against the plain stripe loop at the main paths'
    plane shapes; luma slices of 17 MB rows reset every 34 block rows."""
    lead = () if g is None else (g,)
    reset = 2 * reset_rows if h in (1088, 368) else reset_rows
    cur, qp = _row_scan_case(rng, lead, h, w)
    q_blk = tables.load(cuda).QSTEP[_t(qp, cuda).long()].contiguous()
    args = (_t(cur, cuda), q_blk, 6, reset, qmat)
    got, want = plain_and_kernel(dispatch.intra_rows_code_plane, *args)
    assert _same(got, want)
    assert build.LAUNCHES["code_plane_rows_g" if g else "code_plane_rows"] > 0


@pytest.mark.parametrize("g", [None, 4])
@pytest.mark.parametrize("qmat", [False, True])
def test_code_plane_extremes_on_card(cuda, plain_and_kernel, rng, qmat, g):
    """Whole planes at the arithmetic's edges: residuals of +-255, flat
    blocks, qp 1, 28 and 63 mixed per block, both biases."""
    lead = () if g is None else (g,)
    h, w = 544, 960
    cur = rng.integers(0, 256, (*lead, h, w))
    pred = rng.integers(0, 256, (*lead, h, w))
    cur[..., :64, :] = np.where(rng.random((*lead, 64, w)) < 0.5, 255, 0)
    pred[..., :64, :] = 255 - cur[..., :64, :]
    pred[..., 64:128, :] = cur[..., 64:128, :]
    qp = rng.choice([1, 28, 63], (*lead, h // 8, w // 8))
    q_blk = tables.load(cuda).QSTEP[_t(qp, cuda).long()].contiguous()
    for qbias in (8, 1):
        args = (_t(cur, cuda), _t(pred, cuda), q_blk, qbias, qmat)
        got, want = plain_and_kernel(dispatch.code_plane, *args)
        assert _same(got, want)


def test_code_plane_rejects_misaligned(cuda):
    """The kernel moves rows as 16-byte vectors: a plane that does not
    start on a 16-byte boundary is refused, not coded."""
    buf = torch.zeros(8 * 16 + 1, dtype=torch.int32, device=cuda)
    cur = buf[1:].view(8, 16)
    q_blk = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        dispatch.code_plane(cur, cur, q_blk)
    with pytest.raises(ValueError, match="aligned"):
        dispatch.intra_rows_code_plane(cur, q_blk)


@pytest.mark.parametrize("n_words", [1, 2, 16, entropy.BLOCK_WORDS_MAX])
@pytest.mark.parametrize("fmt", [1, 2])
def test_block_pack_edges_on_card(cuda, plain_and_kernel, rng, fmt, n_words):
    """All-zero blocks, 64 nonzeros at |level| = 3925 (overflowing 1, 2
    and 16 words, exact at BLOCK_WORDS_MAX) and dc - dc_pred = +-7850;
    strings of up to two words take the kernel's register path."""
    lv = np.zeros((64, 64), np.int64)
    mask = rng.random(lv.shape) < 0.15
    lv[mask] = rng.integers(-300, 301, mask.sum())
    lv[0:8] = 0
    lv[8:24] = rng.choice([-3925, 3925], (16, 64))
    lv[24:26, 1:] = 0
    lv[24, 0], lv[25, 0] = 3925, -3925
    dcp = rng.integers(-40, 41, 64)
    dcp[24], dcp[25] = -3925, 3925
    dc_pred = _t(dcp, cuda) if fmt >= 2 else None
    got, want = plain_and_kernel(dispatch.block_pack, _t(lv, cuda), n_words,
                                 dc_pred, fmt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][:8].tolist() == [1] * 8
    assert bool((got[1][8:24] > 32 * n_words).all()) == (
        n_words < entropy.BLOCK_WORDS_MAX)
    if fmt >= 2:
        assert got[1][24:26].tolist() == [1 + 27 + 1] * 2


def test_block_pack_rejects_too_many_words(cuda):
    lv = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="n_words"):
        dispatch.block_pack(lv, entropy.BLOCK_WORDS_MAX + 1)


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
    col = np.arange(w)[None, None, :] * 32
    keep = np.clip(bits[..., None] - col, 0, 32)
    vals = rng.integers(0, 2**32, (n_mbs, 8, w), dtype=np.uint64)
    words = (vals >> (32 - keep).astype(np.uint64) << (32 - keep).astype(np.uint64))
    words = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    return (words[:, 0, :2].contiguous(), words[:, 1:5].contiguous(),
            words[:, 5].contiguous(), words[:, 6].contiguous(),
            _t(bits.reshape(-1), dev))


def _frame_sources(rng, h, w, dev):
    """The per-MB sources of a real frame: code_plane at qp 28 on textured
    planes, block_pack at 16 words, random vectors and qp deltas."""
    q28 = int(tables.load(dev).QSTEP[28])
    levels = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        tex = rng.integers(0, 256, (ph + 2, pw + 2))
        tex = (tex[:-2, :-2] + tex[1:-1, 1:-1] + tex[2:, 2:]) // 3
        cur = _t(tex, dev)
        pred = _t(np.clip(tex + rng.integers(-3, 4, tex.shape), 0, 255), dev)
        q = torch.full((ph // 8, pw // 8), q28, dtype=torch.int32, device=dev)
        levels.append(dispatch.code_plane(cur, pred, q, 8)[0])
    nby, nbx = h // 16, w // 16
    (hw, yw, cbw, crw), bits7, _ = entropy._mb_sources(
        *levels, _t(rng.integers(-2, 3, (nby, nbx)), dev), True,
        torch.from_numpy(rng.random((nby, nbx)) < 0.7).to(dev),
        _t(rng.integers(-16, 17, (nby, nbx)), dev),
        _t(rng.integers(-16, 17, (nby, nbx)), dev), 16)
    bits = torch.nn.functional.pad(bits7, (0, 1)).reshape(-1).contiguous()
    return hw.contiguous(), yw.contiguous(), cbw.contiguous(), crw.contiguous(), bits


@pytest.mark.parametrize("n_mbs,w,kind", [
    (8160, 16, "random"), (240, 16, "random"), (128, 16, "dense"),
    (100, 78, "random"), (8160, 16, "real"), (240, 16, "real")])
def test_span_merge_kernels(cuda, plain_and_kernel, rng, n_mbs, w, kind):
    """Both stages against their plain versions on random pieces, dense
    pieces that overflow the budgeted width (the flag), and the sources
    of a real 1088x1920 or 192x320 frame."""
    from video_encoder_tpu_torch.codec import pack

    plan = pack.span_plan(n_mbs, w)
    if kind == "real":
        h, wd = (1088, 1920) if n_mbs == 8160 else (192, 320)
        src = _frame_sources(rng, h, wd, cuda)
    else:
        src = _sources(rng, n_mbs, w, kind == "dense", cuda)
    got, want = plain_and_kernel(dispatch.span_merge_mb, *src, plan.m1,
                                 plan.cw1, plan.n1)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert bool(got[2]) == (kind == "dense")
    if plan.two_stage:
        got2, want2 = plain_and_kernel(dispatch.span_merge, got[0], got[1],
                                       plan.g, plan.stop, plan.cwf)
        for g, w_ in zip(got2, want2):
            assert torch.equal(g, w_)


def test_merges_are_one_device_op(cuda, rng):
    """Each merge call is one device op (the overflow flag is derived in
    the launch), and a flag raised by one call does not stay raised in
    the next."""
    from torch.profiler import ProfilerActivity, profile

    from video_encoder_tpu_torch.codec import pack

    plan = pack.span_plan(128, 16)
    dense = (*_sources(rng, 128, 16, True, cuda), plan.m1, plan.cw1, plan.n1)
    sparse = (*_sources(rng, 128, 16, False, cuda), plan.m1, plan.cw1, plan.n1)
    stage1 = dispatch.span_merge_mb(*sparse)
    words, bits = (torch.from_numpy(a).to(cuda) for a in _pieces(rng, (), 256, 8, "random"))
    for call in (lambda: dispatch.span_merge_mb(*dense),
                 lambda: dispatch.span_merge(stage1[0], stage1[1], 8, 4, 99),
                 lambda: dispatch.chunk_merge(words, bits, 32)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert names and all("merge_kernel" in n for n in names), names
    for args, raised in ((dense, True), (sparse, False), (dense, True), (sparse, False)):
        assert bool(dispatch.span_merge_mb(*args)[2]) == raised


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
    used = ["mc_predict", "code_plane", "block_pack"]
    used += (["full_search"] if search == "full"
             else ["sad_map_even", "diamond_descent"])
    used += ["span_merge_mb"] if emit == "chunks" else []
    assert all(build.LAUNCHES[k] > 0 for k in used), build.LAUNCHES
    assert build.LAUNCHES["sad_at_mv"] == 0     # the final step is the descent's
    # once per P frame of each run (an overflow encodes the GOP again)
    assert build.LAUNCHES["mc_predict"] in (3, 6), build.LAUNCHES
    assert not any(build.LAUNCHES[k] for k in _SINGLE_FETCHES), build.LAUNCHES
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
    used = ["mc_predict", "block_pack_v2",
            "code_plane_qmat" if cfg.quant_matrix else "code_plane"]
    used += ["sad_at_mv"] if cfg.format_version == 4 else []
    used += ["code_plane_rows"] if cfg.format_version >= 3 else []
    assert all(build.LAUNCHES[k] > 0 for k in used), build.LAUNCHES
    assert build.LAUNCHES["block_pack"] == 0
    if cfg.format_version >= 3:   # the I frame: one launch per plane, and
        # code_plane three per P frame (3 P frames to 1 I frame a run)
        assert build.LAUNCHES[used[2]] == 3 * build.LAUNCHES["code_plane_rows"]
    assert not any(build.LAUNCHES[k] for k in _SINGLE_FETCHES), build.LAUNCHES
    want, _ = GopEngine(cfg, device="cpu", emit=emit).encode_gop(frames, 0)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]


# ---------------------------------------------------------------------------
# The G-batched kernels: planes [G, H, W] of G GOPs in lockstep, one launch,
# equal to the plain batched version and to G launches of the single-plane
# kernel
# ---------------------------------------------------------------------------

def _per_g(fn, g, *args):
    """fn on each g's slice of the tensor arguments, stacked."""
    outs = [fn(*(a[i].contiguous() if isinstance(a, torch.Tensor) else a
                 for a in args)) for i in range(g)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _gop_planes(rng, g, h, w):
    """G plane pairs that differ: each GOP pans its own way; GOP 1 has a
    flat region where every candidate ties."""
    cur = rng.integers(0, 256, (g, h, w))
    ref = np.stack([np.roll(cur[i], (3 + 2 * i, -5 - 3 * i), (0, 1)) for i in range(g)])
    ref = ref + rng.integers(-2, 3, (g, h, w))
    cur[1, :32, :32] = 9
    ref[1, :48, :48] = 9
    return cur, np.clip(ref, 0, 255)


@pytest.mark.parametrize("g,h,w", [(4, 1088, 1920), (3, 368, 640), (2, 48, 80)])
def test_full_search_g_kernel(cuda, plain_and_kernel, rng, g, h, w):
    cur, ref = _gop_planes(rng, g, h, w)
    args = (_t(cur, cuda), _t(ref, cuda))
    got, want = plain_and_kernel(dispatch.full_search, *args)
    assert _same(got, want)
    assert _same(got, _per_g(dispatch.full_search, g, *args))
    assert build.LAUNCHES["full_search_g"] > 0


@pytest.mark.parametrize("g,h,w", [(4, 1088, 1920), (3, 368, 640), (2, 48, 80)])
def test_sad_map_even_g_kernel(cuda, plain_and_kernel, rng, g, h, w):
    cur, ref = _gop_planes(rng, g, h, w)
    args = (_t(cur, cuda), _t(ref, cuda))
    got, want = plain_and_kernel(dispatch.sad_map_even, *args)
    assert _same(got, want)
    assert _same(got, _per_g(dispatch.sad_map_even, g, *args))


@pytest.mark.parametrize("g,bs,h,w", [(4, 16, 1088, 1920), (4, 8, 544, 960),
                                      (3, 16, 368, 640), (2, 8, 24, 40)])
def test_mc_fetch_g_kernel(cuda, plain_and_kernel, rng, g, bs, h, w):
    ref = _t(rng.integers(0, 256, (g, h, w)), cuda)
    dy = rng.integers(-bs, bs + 1, (g, h // bs, w // bs))
    dx = rng.integers(-bs, bs + 1, (g, h // bs, w // bs))
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -bs, -bs, bs, bs
    fn = dispatch.mc_fetch_luma_plane if bs == 16 else dispatch.mc_fetch_chroma_plane
    args = (ref, _t(dy, cuda), _t(dx, cuda))
    got, want = plain_and_kernel(fn, *args)
    assert _same(got, want) and _same(got, _per_g(fn, g, *args))


@pytest.mark.parametrize("g,k,h,w", [(4, 4, 1088, 1920), (3, None, 368, 640),
                                     (2, 3, 48, 80)])
def test_sad_at_mv_g_kernel(cuda, plain_and_kernel, rng, g, k, h, w):
    cur = _t(rng.integers(0, 256, (g, h, w)), cuda)
    ref = _t(rng.integers(0, 256, (g, h, w)), cuda)
    shape = (g, h // 16, w // 16) if k is None else (g, k, h // 16, w // 16)
    dy, dx = rng.integers(-16, 17, shape), rng.integers(-16, 17, shape)
    dy[..., 0, 0], dx[..., 0, 0], dy[..., -1, -1], dx[..., -1, -1] = -16, -16, 16, 16
    args = (cur, ref, _t(dy, cuda), _t(dx, cuda))
    got, want = plain_and_kernel(dispatch.sad_at_mv, *args)
    assert _same(got, want) and _same(got, _per_g(dispatch.sad_at_mv, g, *args))


@pytest.mark.parametrize("g,h,w", [(4, 1088, 1920), (3, 368, 640)])
def test_sad_at_mv_g_kernel_on_planes(cuda, plain_and_kernel, rng, g, h, w):
    """Nine candidates, each on its own plane of each GOP's four."""
    plane_of = [3, 2, 3, 1, 0, 1, 3, 2, 3]
    cur = _t(rng.integers(0, 256, (g, h, w)), cuda)
    planes = _t(rng.integers(0, 256, (g, 4, h, w)), cuda)
    dy = rng.integers(-16, 17, (g, 9, h // 16, w // 16))
    dx = rng.integers(-16, 17, (g, 9, h // 16, w // 16))
    dy[..., 0, 0], dx[..., 0, 0], dy[..., -1, -1], dx[..., -1, -1] = -16, -16, 16, 16
    args = (cur, planes, _t(dy, cuda), _t(dx, cuda), plane_of)
    got, want = plain_and_kernel(dispatch.sad_at_mv, *args)
    assert _same(got, want) and _same(got, _per_g(dispatch.sad_at_mv, g, *args))


@pytest.mark.parametrize("g,k,h,w", [(4, 4, 544, 960), (3, None, 184, 320)])
def test_sad_at_mv_chroma_g_kernel(cuda, plain_and_kernel, rng, g, k, h, w):
    cur = _t(rng.integers(0, 256, (g, h, w)), cuda)
    ref = _t(rng.integers(0, 256, (g, h, w)), cuda)
    shape = (g, h // 8, w // 8) if k is None else (g, k, h // 8, w // 8)
    dy, dx = rng.integers(-8, 9, shape), rng.integers(-8, 9, shape)
    dy[..., 0, 0], dx[..., 0, 0], dy[..., -1, -1], dx[..., -1, -1] = -8, -8, 8, 8
    args = (cur, ref, _t(dy, cuda), _t(dx, cuda))
    got, want = plain_and_kernel(dispatch.sad_at_mv_chroma, *args)
    assert _same(got, want)
    assert _same(got, _per_g(dispatch.sad_at_mv_chroma, g, *args))


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("g,h,w", [(4, 1088, 1920), (4, 544, 960), (4, 8, 1920),
                                   (3, 368, 640), (2, 24, 40)])
def test_code_plane_g_kernel(cuda, plain_and_kernel, rng, g, h, w, qmat):
    """Whole planes and the row scan's [G, 8, W] stripes, each GOP at its
    own steps."""
    cur = rng.integers(0, 256, (g, h, w))
    pred = np.clip(cur + rng.integers(-40, 41, (g, h, w)), 0, 255)
    qp = rng.choice([1, 28, 63], (g, h // 8, w // 8))
    q_blk = tables.load(cuda).QSTEP[_t(qp, cuda).long()].contiguous()
    for qbias in (8, 5):
        args = (_t(cur, cuda), _t(pred, cuda), q_blk, qbias, qmat)
        got, want = plain_and_kernel(dispatch.code_plane, *args)
        assert _same(got, want)
        assert _same(got, _per_g(dispatch.code_plane, g, *args))
    assert build.LAUNCHES["code_plane_qmat_g" if qmat else "code_plane_g"] > 0


@pytest.mark.parametrize("reset_rows", [0, 2])
def test_intra_rows_g_on_card(cuda, rng, reset_rows):
    """The row scan of G planes in lockstep: one code_plane_rows_g launch
    per plane stack, no code_plane launch."""
    g = 3
    cur = _t(rng.integers(0, 256, (g, 64, 960)), cuda)
    q_blk = tables.load(cuda).QSTEP[
        _t(rng.choice([20, 28], (g, 8, 120)), cuda).long()]
    dispatch.force("plain")
    try:
        want = dispatch.intra_rows_code_plane(cur, q_blk, 8, reset_rows, True)
    finally:
        dispatch.force(None)
    build.reset_launches()
    got = dispatch.intra_rows_code_plane(cur, q_blk, 8, reset_rows, True)
    assert build.LAUNCHES["code_plane_rows_g"] == 1
    assert sum(build.LAUNCHES.values()) == 1
    assert _same(got, want)
    assert _same(got, _per_g(dispatch.intra_rows_code_plane, g, cur, q_blk, 8,
                             reset_rows, True))


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(search="diamond", rc="mb", target_kbps=300),
    dict(format_version=2, chroma_qp_offset=4, search="diamond", rc="vbv",
         target_kbps=300),
    dict(format_version=3, quant_matrix=True, intra_slice_mbrows=2,
         rc="adaptive"),
    dict(format_version=4, quant_matrix=True, chroma_qp_offset=2),
    dict(format_version=2, base_qp=4),                  # overflow rerun
], ids=lambda kw: "-".join(f"{k[:6]}{v}" for k, v in kw.items()) or "default")
def test_gop_engine_batch_on_card_matches_cpu(cuda, rng, kw, emit):
    """G = 3 GOPs of 3 frames in lockstep on the card: the CPU's packets,
    through the batched kernels only, the pack, its tail and the span merges
    launched once per frame step."""
    g, t = 3, 3
    big = rng.integers(0, 256, (176, 240)).astype(np.int64)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1) + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for i in range(g * t):   # 2x2 means at an odd offset: true half-pel motion
        o = big[3 * i:3 * i + 128, 5 * i:5 * i + 192]
        y = (o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2] + 2) // 4
        frames.append(Frame.from_planes(
            y.astype(np.uint8), np.full((32, 48), 100 + i, np.uint8),
            np.full((32, 48), 150, np.uint8)))
    gops = [frames[i * t:(i + 1) * t] for i in range(g)]
    firsts = [i * t for i in range(g)]
    cfg = EncoderConfig(**{**dict(width=96, height=64, gop_n=t, base_qp=24), **kw})
    qps = [22, 24, 30] if cfg.base_qp == 24 else None
    eng = GopEngine(cfg, device=cuda, emit=emit)
    handle = eng.start(gops, firsts, qps)
    build.reset_launches()       # count a clean first run, not a rerun
    eng.run_batch(handle.y, handle.cb, handle.cr, handle.qps)
    n = build.LAUNCHES
    qm = "_qmat" if cfg.quant_matrix else ""
    used = ["mc_predict_g", f"code_plane{qm}_g"]
    used += (["full_search_g"] if cfg.search == "full"
             else ["sad_map_even_g", "diamond_descent_g"])
    used += ["sad_at_mv_g"] if cfg.format_version == 4 else []
    assert all(n[k] > 0 for k in used), n
    single = [k for k in n if not k.endswith("_g") and k.split("_v2")[0] not in (
        "block_pack", "span_merge_mb", "span_merge", "frame_headers",
        "frame_place", "frame_mb_bits")]
    assert all(n[k] == 0 for k in single), n
    passes = 2 if cfg.rc == "mb" else 1
    packs = n["block_pack"] + n["block_pack_v2"]
    assert packs == 3 * t * passes                  # per plane, not per GOP
    # the pack's tail: once per frame step, not per GOP
    assert n["frame_headers"] == t and n["frame_mb_bits"] == t * (passes - 1)
    assert n["frame_place"] == (t if emit == "frame" else 0)
    assert n["mc_predict_g"] == t - 1               # once per P step
    if cfg.format_version >= 3:     # one row-scan launch per plane
        assert n["code_plane_rows_g"] == 3 * passes
        assert n[f"code_plane{qm}_g"] == 3 * (t - 1) * passes
    assert not any(n[k] for k in _SINGLE_FETCHES), n
    assert n["span_merge_mb"] == (t if emit == "chunks" else 0)
    got = eng.finish(handle)
    cpu = GopEngine(cfg, device="cpu", emit=emit)
    want = cpu.finish(cpu.start(gops, firsts, qps))
    for (gp, _), (wp, _) in zip(got, want):
        assert [p.to_bytes() for p in gp] == [p.to_bytes() for p in wp]


# ---- the pre-haloed kernels of the tile-sharded encode ---------------------

from video_encoder_tpu_torch.ops import motion  # noqa: E402
from video_encoder_tpu_torch.parallel import tiles  # noqa: E402
from video_encoder_tpu_torch.parallel.gop_parallel import (  # noqa: E402
    ShardedGopEncoder)
from video_encoder_tpu_torch.parallel.mesh import (  # noqa: E402
    make_codec_mesh, make_tile_mesh_2d)


def _split(p, sr, sc):
    """[.., H, W] -> [Sr * Sc, .., H / Sr, W / Sc], row-major tiles."""
    return torch.stack([q for band in p.chunk(sr, -2)
                        for q in band.chunk(sc, -1)]).contiguous()


def _join(t, sr, sc):
    return torch.cat([torch.cat(list(t[r * sc:(r + 1) * sc]), -1)
                      for r in range(sr)], -2)


def _ext(p, sr, sc, halo):
    """The tiles' pre-haloed references: a row halo alone when the frame is
    not split by columns, else both halos."""
    t = _split(p, sr, sc)
    if sc == 1:
        return tiles.exchange_halo(t, halo).contiguous()
    return tiles.exchange_halo_2d(t.unflatten(0, (sr, sc)), halo
                                  ).flatten(0, 1).contiguous()


_HALOED_SHAPES = [(4, 1, 1088, 1920), (2, 2, 1088, 1920), (2, 1, 1088, 1920),
                  (1, 1, 368, 640), (1, 3, 368, 624), (2, 1, 64, 80)]


@pytest.mark.parametrize("sr,sc,h,w", _HALOED_SHAPES)
def test_full_search_haloed_kernel(cuda, plain_and_kernel, rng, sr, sc, h, w):
    """The shards' search equals its plain version and, put together, the
    unsharded kernel's on the whole frame; a single shard also without the
    batch axis."""
    cur = rng.integers(0, 256, (h, w))
    ref = np.roll(cur, (5, -9), (0, 1)) + rng.integers(-2, 3, (h, w))
    cur[:32, :32] = 9
    ref[:48, :48] = 9
    cur, ref = _t(cur, cuda), _t(np.clip(ref, 0, 255), cuda)
    args = (_split(cur, sr, sc), _ext(ref, sr, sc, 16))
    got, want = plain_and_kernel(dispatch.full_search_pre_haloed, *args)
    assert _same(got, want)
    whole = dispatch.full_search(cur, ref)
    assert _same(tuple(_join(g, sr, sc) for g in got), whole)
    one = dispatch.full_search_pre_haloed(args[0][0], args[1][0])
    assert _same(one, tuple(g[0] for g in got))
    assert build.LAUNCHES["full_search_haloed"] > 0


@pytest.mark.parametrize("bs", [16, 8])
@pytest.mark.parametrize("sr,sc,h,w", _HALOED_SHAPES)
def test_mc_fetch_haloed_kernel(cuda, plain_and_kernel, rng, sr, sc, h, w, bs):
    if bs == 8:
        h, w = h // 2, w // 2
    ref = _t(rng.integers(0, 256, (h, w)), cuda)
    dy = rng.integers(-bs, bs + 1, (h // bs, w // bs))
    dx = rng.integers(-bs, bs + 1, (h // bs, w // bs))
    dy[0, 0], dx[0, 0], dy[-1, -1], dx[-1, -1] = -bs, -bs, bs, bs
    dy[0, -1], dx[0, -1], dy[-1, 0], dx[-1, 0] = -bs, bs, bs, -bs
    dy, dx = _t(dy, cuda), _t(dx, cuda)
    args = (_ext(ref, sr, sc, bs), _split(dy, sr, sc), _split(dx, sr, sc), bs, bs)
    got, want = plain_and_kernel(dispatch.mc_fetch_pre_haloed, *args)
    assert torch.equal(got, want)
    fn = dispatch.mc_fetch_luma_plane if bs == 16 else dispatch.mc_fetch_chroma_plane
    assert torch.equal(_join(got, sr, sc), fn(ref, dy, dx))
    one = dispatch.mc_fetch_pre_haloed(args[0][0], args[1][0], args[2][0], bs, bs)
    assert torch.equal(one, got[0])
    assert build.LAUNCHES["mc_fetch_haloed_" + ("luma" if bs == 16 else "chroma")] > 0


@pytest.mark.parametrize("sr,sc,h,w", _HALOED_SHAPES)
def test_sad_at_mv_haloed_kernel(cuda, plain_and_kernel, rng, sr, sc, h, w):
    """Nine candidates on four halo-extended parity planes (parity first,
    then the halo): the plain version's SADs and the unsharded kernel's on
    the whole frame; then the whole refine on the shards."""
    plane_of = [3, 2, 3, 1, 0, 1, 3, 2, 3]
    cur = _t(rng.integers(0, 256, (h, w)), cuda)
    ref = _t(rng.integers(0, 256, (h, w)), cuda)
    planes = motion.hpel_stack(ref)                        # [4, H, W]
    dy = rng.integers(-16, 17, (9, h // 16, w // 16))
    dx = rng.integers(-16, 17, (9, h // 16, w // 16))
    dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -16, -16, 16, 16
    dy, dx = _t(dy, cuda), _t(dx, cuda)
    planes_ext = torch.stack([_ext(q, sr, sc, 16) for q in planes], 1).contiguous()
    if sc == 1:       # the encode's own exchange gives these planes
        sh = _split(ref, sr, 1)
        for ref_mode in ("halo", "allgather"):
            assert torch.equal(planes_ext, torch.stack(
                (tiles.exchange_halo(sh, 16),
                 *tiles._parity_ext(sh, 16, ref_mode)), 1))
    args = (_split(cur, sr, sc), planes_ext, _split(dy, sr, sc),
            _split(dx, sr, sc), plane_of)
    got, want = plain_and_kernel(dispatch.sad_at_mv_pre_haloed, *args)
    assert torch.equal(got, want)
    assert torch.equal(_join(got, sr, sc),
                       dispatch.sad_at_mv(cur, planes, dy, dx, plane_of))
    one = dispatch.sad_at_mv_pre_haloed(args[0][0], planes_ext[0, 0],
                                        args[2][0, 4], args[3][0, 4])
    assert torch.equal(one, got[0, 4])                     # one plane, no K
    mv = dispatch.full_search(cur, ref)
    refined = dispatch.hpel_refine(
        args[0], None, _split(mv[0], sr, sc), _split(mv[1], sr, sc), planes_ext,
        sad_fn=dispatch.sad_at_mv_pre_haloed)
    assert _same(tuple(_join(g, sr, sc) for g in refined),
                 dispatch.hpel_refine(cur, ref, mv[0], mv[1], planes))


def _pan_frames(rng, n, h=128, w=96):
    """2x2 means at an odd offset: true half-pel motion, textured chroma."""
    big = rng.integers(0, 256, (2 * h + 64, 2 * w + 64)).astype(np.int64)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1) + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for i in range(n):
        o = big[3 * i:3 * i + 2 * h, 5 * i:5 * i + 2 * w]
        y = (o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2] + 2) // 4
        c = y.reshape(h // 2, 2, w // 2, 2).sum((1, 3)) // 4
        frames.append(Frame.from_planes(y.astype(np.uint8), c.astype(np.uint8),
                                        (255 - c).astype(np.uint8)))
    return frames


@pytest.mark.parametrize("g,s", [(1, 4), (3, 2)])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(rc="mb", target_kbps=300),
    dict(format_version=2, chroma_qp_offset=4, rc="vbv", target_kbps=300),
    dict(format_version=3, quant_matrix=True, intra_slice_mbrows=2,
         rc="adaptive"),
    dict(format_version=4, quant_matrix=True, chroma_qp_offset=2,
         intra_slice_mbrows=1),
    dict(base_qp=28),                                   # overflow rerun
], ids=lambda kw: "-".join(f"{k[:6]}{v}" for k, v in kw.items()) or "default")
def test_sharded_encoder_on_card_matches_cpu(cuda, rng, kw, g, s):
    """G GOPs of S row shards each on the card: the CPU's unsharded
    packets and stats, through the pre-haloed kernels only."""
    t = 3
    frames = _pan_frames(rng, g * t)
    if kw == dict(base_qp=28):    # black-and-white luma overflows 16-word blocks
        frames = [Frame.from_planes(
            (rng.integers(0, 2, f.y.shape) * 255).astype(np.uint8), f.cb, f.cr)
            for f in frames]
    gops = [frames[i * t:(i + 1) * t] for i in range(g)]
    firsts = [i * t for i in range(g)]
    cfg = EncoderConfig(**{**dict(width=96, height=128, gop_n=t, base_qp=24), **kw})
    senc = ShardedGopEncoder(cfg, make_codec_mesh(g, s, cuda))
    runs, run = [], senc.run
    senc.run = lambda *a, xl=False: runs.append(xl) or run(*a, xl=xl)
    build.reset_launches()
    got = senc.finish(senc.start(gops, firsts))
    n = build.LAUNCHES
    reruns = len(runs)          # 2 where a shard overflowed its budget
    assert runs == [False, True][:reruns]
    if cfg.base_qp == 28:
        assert reruns == 2
    planes = 4 if cfg.format_version == 4 else 1
    assert n["full_search_haloed"] == (t - 1) * reruns
    assert n["mc_predict_haloed"] == (t - 1) * reruns   # one per P step
    assert n["sad_at_mv_haloed"] == (planes == 4) * (t - 1) * reruns
    # the I step: one row-scan launch per plane over the G x S shards
    passes = 2 if cfg.rc == "mb" else 1
    assert n["code_plane_rows_g"] == (
        3 * reruns * passes if cfg.format_version >= 3 else 0)
    assert n["code_plane_rows"] == 0
    assert not any(n[k] for k in ("full_search", "full_search_g", "mc_predict",
                                  "mc_predict_g", "sad_at_mv", "sad_at_mv_g",
                                  *_SINGLE_FETCHES))
    cpu = GopEngine(cfg, device="cpu")
    want = cpu.finish(cpu.start(gops, firsts))
    for (gp, gs), (wp, ws) in zip(got, want):
        assert [p.to_bytes() for p in gp] == [p.to_bytes() for p in wp]
        assert [st.psnr_y for st in gs] == [st.psnr_y for st in ws]


@pytest.mark.parametrize("rc", ["none", "vbv", "mb"])
@pytest.mark.parametrize("sr,sc", [(2, 2), (1, 3), (4, 1)])
def test_tile2d_on_card_matches_cpu(cuda, rng, sr, sc, rc):
    """The 2-D tile grid on the card (both halos in the kernels): the CPU's
    unsharded payloads."""
    t = 3
    frames = _pan_frames(rng, t)
    kw = dict(rc=rc, target_kbps=300) if rc != "none" else {}
    cfg = EncoderConfig(width=96, height=128, gop_n=t, base_qp=26, **kw)
    y, cb, cr = (torch.from_numpy(np.stack([getattr(f, p) for f in frames])).to(cuda)
                 for p in ("y", "cb", "cr"))
    build.reset_launches()
    outs = tiles.encode_gop_tiled2d(
        y, cb, cr, 26, mesh=make_tile_mesh_2d(sr, sc, cuda), rc=cfg.rc,
        block_words=entropy.BLOCK_WORDS_MAX,
        row_words=entropy.max_words(96 // 16 // sc),
        target_bits=cfg.target_bits_per_frame(), vbv_bits=cfg.vbv_bits())
    assert build.LAUNCHES["full_search_haloed"] == t - 1
    assert build.LAUNCHES["mc_predict_haloed"] == t - 1
    assert not any(build.LAUNCHES[k] for k in _SINGLE_FETCHES)
    assert not bool(outs["ovf"].any())
    words, row_bits = outs["words"].cpu().numpy(), outs["row_bits"].cpu().numpy()
    got = [tiles.assemble_frame_2d(words, row_bits, k) for k in range(t)]
    want, _ = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
    assert got == [(p.payload, p.payload_bits) for p in want]


# ---- the whole SAD map, the SEA full search (TVC_SEA=1), chunk_merge and
# the hierarchical search's refine ------------------------------------------

@pytest.mark.parametrize("h,w", [(368, 640), (144, 208)])
def test_sad_map_kernel(cuda, plain_and_kernel, rng, h, w):
    """All 1089 SADs per MB; the all-tied flat region of _gop_planes' GOP
    1; the first minimum of the packed key is full_search's and the even
    sublattice is sad_map_even's."""
    cur, ref = _gop_planes(rng, 2, h, w)
    args = (_t(cur[1], cuda), _t(ref[1], cuda))
    got, want = plain_and_kernel(dispatch.sad_map, *args)
    assert torch.equal(got, want) and got.shape == (h // 16, w // 16, 1089)
    assert (got[0, 0] == got[0, 0, 0]).all()
    key = (got.long() * 2048 + torch.arange(1089, device=cuda)).amin(-1)
    dy, dx, sad = dispatch.full_search(*args)
    assert torch.equal((key >> 11).int(), sad)
    assert torch.equal(((key & 2047) // 33 - 16).int(), dy)
    assert torch.equal(((key & 2047) % 33 - 16).int(), dx)
    even = got.reshape(h // 16, w // 16, 33, 33)[..., ::2, ::2]
    assert torch.equal(even.reshape(h // 16, w // 16, 289),
                       dispatch.sad_map_even(*args))
    assert build.LAUNCHES["sad_map"] > 0


@pytest.mark.parametrize("g,h,w", [(3, 368, 640), (2, 144, 208)])
def test_sad_map_g_kernel(cuda, plain_and_kernel, rng, g, h, w):
    cur, ref = _gop_planes(rng, g, h, w)
    args = (_t(cur, cuda), _t(ref, cuda))
    got, want = plain_and_kernel(dispatch.sad_map, *args)
    assert torch.equal(got, want)
    assert torch.equal(got, _per_g(dispatch.sad_map, g, *args))
    assert build.LAUNCHES["sad_map_g"] > 0


def _sea_pair(rng, kind, h, w):
    """pan: a smooth clean pan by (+2, -3), on which the bound prunes;
    recon: the pan against a qp-28 recon of its reference (what the engine
    searches); noise: i.i.d. planes, on which it prunes nothing; tied:
    textured planes with a flat region where every candidate ties; flat:
    two flat planes of different levels (every candidate ties, every bound
    equals its SAD); equal: MB (1, 1) matches +1 everywhere at (0, 0) and
    at (-16, -16), where its bound is exact, so a bound equal to the best
    must still be evaluated."""
    if kind == "flat":
        return np.full((h, w), 77), np.full((h, w), 100)
    if kind == "noise":
        return rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h, w))
    base = rng.integers(0, 256, (h + 16, w + 16))
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    cur, ref = base[2:2 + h, :w].copy(), base[:h, 3:3 + w].copy()
    if kind == "tied":
        cur[:64, :64] = 9
        ref[:96, :96] = 9
    elif kind == "recon":
        q = torch.full((h // 8, w // 8), int(tables.load("cpu").QSTEP[28]),
                       dtype=torch.int32)
        ref = dispatch.code_plane(_t(ref, "cpu"), torch.full((h, w), 128, dtype=torch.int32),
                                  q, 8)[1].numpy()
    elif kind == "equal":
        ref = rng.integers(0, 200, (h, w))
        cur[16:32, 16:32] = np.minimum(cur[16:32, 16:32], 254)
        ref[16:32, 16:32] = cur[16:32, 16:32] + 1
        ref[0:16, 0:16] = cur[16:32, 16:32] + 1
    return cur, ref


@pytest.mark.parametrize("kind", ["pan", "recon", "noise", "tied", "flat", "equal"])
@pytest.mark.parametrize("h,w", [(1088, 1920), (368, 640), (144, 208)])
def test_full_search_sea_kernel(cuda, rng, monkeypatch, kind, h, w):
    """The stats entry against the plain SEA (vectors and rows per MB);
    with TVC_SEA=1 the full_search wrapper launches the SEA entry and not
    the exhaustive one, with the exhaustive search's result."""
    args = tuple(_t(a, cuda) for a in _sea_pair(rng, kind, h, w))
    dispatch.force("plain")
    try:
        want = dispatch.full_search_sea_stats(*args)
    finally:
        dispatch.force(None)
    n = dict(build.LAUNCHES)
    got = dispatch.full_search_sea_stats(*args)
    torch.cuda.synchronize()
    assert _same(got, want)
    exhaustive = dispatch.full_search(*args)
    assert _same(got[:3], exhaustive)
    monkeypatch.setenv("TVC_SEA", "1")
    assert _same(dispatch.full_search(*args), exhaustive)
    assert build.LAUNCHES["full_search_sea"] == n["full_search_sea"] + 2
    assert build.LAUNCHES["full_search"] == n["full_search"] + 1
    rows = got[3]
    assert int(rows.min()) >= 1 and int(rows.max()) <= 33
    if kind == "pan":
        assert rows.float().mean() < 20
    elif kind == "noise":
        assert (rows == 33).all()
    elif kind == "flat":       # ties: `<=` evaluates every row, first minimum
        assert (rows == 33).all() and (got[0] == -16).all() and (got[1] == -16).all()
    elif kind == "equal":
        assert [int(t[1, 1]) for t in got[:3]] == [-16, -16, 256]
    elif kind == "tied":
        assert (rows[:4, :4] == 33).all() and (got[0][:4, :4] == -16).all()


@pytest.mark.parametrize("g,h,w", [(4, 1088, 1920), (3, 368, 640), (2, 144, 208)])
def test_full_search_sea_g_kernel(cuda, rng, monkeypatch, g, h, w):
    cur, ref = _gop_planes(rng, g, h, w)
    cur[0], ref[0] = _sea_pair(rng, "pan", h, w)
    args = (_t(cur, cuda), _t(ref, cuda))
    want = dispatch.full_search(*args)
    monkeypatch.setenv("TVC_SEA", "1")
    n = dict(build.LAUNCHES)
    got = dispatch.full_search(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["full_search_sea_g"] == n["full_search_sea_g"] + 1
    assert build.LAUNCHES["full_search_g"] == n["full_search_g"]
    assert _same(got, want)
    assert _same(got, motion.full_search_sea(*args)[:3])
    assert _same(got, _per_g(dispatch.full_search, g, *args))


@pytest.mark.parametrize("sr,sc,h,w", _HALOED_SHAPES)
def test_full_search_sea_haloed_kernel(cuda, rng, monkeypatch, sr, sc, h, w):
    """The shards' SEA search equals the plain pre-haloed search (and the
    plain pre-haloed SEA) and, put together, the whole frame's search."""
    cur, ref = _sea_pair(rng, "tied", h, w)
    cur, ref = _t(cur, cuda), _t(ref, cuda)
    args = (_split(cur, sr, sc), _ext(ref, sr, sc, 16))
    want = dispatch.full_search_pre_haloed(*args)
    monkeypatch.setenv("TVC_SEA", "1")
    n = dict(build.LAUNCHES)
    got = dispatch.full_search_pre_haloed(*args)
    one = dispatch.full_search_pre_haloed(args[0][0], args[1][0])
    torch.cuda.synchronize()
    assert build.LAUNCHES["full_search_sea_haloed"] == n["full_search_sea_haloed"] + 2
    assert build.LAUNCHES["full_search_haloed"] == n["full_search_haloed"]
    assert _same(got, want)
    assert _same(got, motion.full_search_sea_pre_haloed(*args)[:3])
    assert _same(tuple(_join(g, sr, sc) for g in got), dispatch.full_search(cur, ref))
    assert _same(one, tuple(g[0] for g in got))


def _pieces(rng, lead, n, w, kind):
    """Piece strings [*lead, n, w] int32 (uint32 bit patterns) and bits
    [*lead, n] int32: every
    piece full (dense), every piece empty, or random lengths with every
    ninth piece empty; words past each length zero."""
    shape = (*lead, n)
    bits = {"dense": np.full(shape, 32 * w), "empty": np.zeros(shape, np.int64),
            "random": rng.integers(0, 32 * w + 1, shape)}[kind]
    if kind == "random":
        bits[..., ::9] = 0
    keep = np.clip(bits[..., None] - np.arange(w) * 32, 0, 32).astype(np.uint64)
    vals = rng.integers(0, 2**32, (*shape, w), dtype=np.uint64)
    words = np.where(keep > 0, vals >> (32 - keep) << (32 - keep), 0)
    return words.astype(np.uint32).view(np.int32), bits.astype(np.int32)


@pytest.mark.parametrize("lead,n,w,k,kind", [
    ((), 65536, 24, 1024, "dense"), ((), 65536, 24, 1024, "empty"),
    ((), 65536, 24, 1024, "random"), ((), 256, 8, 32, "random"),
    ((3,), 4096, 16, 1024, "random"), ((2,), 64, 4, 2, "dense")])
def test_chunk_merge_kernel(cuda, plain_and_kernel, rng, lead, n, w, k, kind):
    """Half-chunk strings at the exact worst-case width: a 1080p frame's
    65536 pieces of 24 words make strings of 12289 words, 25 blocks
    each."""
    from video_encoder_tpu_torch.codec import pack

    words, bits = _pieces(rng, lead, n, w, kind)
    args = (torch.from_numpy(words).to(cuda), _t(bits, cuda), k)
    assert pack.pick_chunk_k(n, w) == k or n < 1024
    got, want = plain_and_kernel(dispatch.chunk_merge, *args)
    assert _same(got, want)
    assert got[0].shape == (*lead, 2 * n // k, (k // 2) * w + 1)
    total = bits.reshape(*lead, -1, k // 2).sum(-1)
    assert np.array_equal(got[1].cpu().numpy(), total)
    assert build.LAUNCHES["chunk_merge"] > 0


@pytest.mark.parametrize("g", [None, 3])
def test_hier_search_on_card_matches_cpu(cuda, rng, g):
    """The coarse search in plain ops on the card, each refine step's 25
    candidates in one sad_at_mv launch: the CPU's vectors."""
    lead = () if g is None else (g,)
    cur, ref = zip(*[_sea_pair(rng, "pan", 368, 640) for _ in range(g or 1)])
    cur, ref = np.stack(cur).reshape(*lead, 368, 640), np.stack(ref).reshape(*lead, 368, 640)
    name = "sad_at_mv" if g is None else "sad_at_mv_g"
    n = build.LAUNCHES[name]
    got = dispatch.hier_search(_t(cur, cuda), _t(ref, cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n + 2
    want = dispatch.hier_search(_t(cur, "cpu"), _t(ref, "cpu"))
    assert _same(tuple(a.cpu() for a in got), want)


@pytest.mark.parametrize("path", ["single", "batched", "tiled"])
def test_encode_with_sea_on_card_matches_cpu(cuda, rng, monkeypatch, path):
    """TVC_SEA=1 reaches the engine's search on each route (the single
    GOP, G GOPs in lockstep, S row shards) through the SEA entries only,
    with the CPU's packets."""
    t = 3
    frames = _pan_frames(rng, 2 * t)
    gops, firsts = [frames[:t], frames[t:]], [0, t]
    cfg = EncoderConfig(width=96, height=128, gop_n=t, base_qp=24)
    monkeypatch.setenv("TVC_SEA", "1")
    build.reset_launches()
    if path == "single":
        got = [GopEngine(cfg, device=cuda).encode_gop(gops[0], 0)]
        want = [GopEngine(cfg, device="cpu").encode_gop(gops[0], 0)]
        sea, plain = "full_search_sea", "full_search"
    elif path == "batched":
        eng, cpu = GopEngine(cfg, device=cuda), GopEngine(cfg, device="cpu")
        got = eng.finish(eng.start(gops, firsts))
        want = cpu.finish(cpu.start(gops, firsts))
        sea, plain = "full_search_sea_g", "full_search_g"
    else:
        senc = ShardedGopEncoder(cfg, make_codec_mesh(1, 4, cuda))
        cpu = GopEngine(cfg, device="cpu")
        got = senc.finish(senc.start(gops[:1], firsts[:1]))
        want = cpu.finish(cpu.start(gops[:1], firsts[:1]))
        sea, plain = "full_search_sea_haloed", "full_search_haloed"
    n = build.LAUNCHES
    assert n[sea] >= t - 1 and n[plain] == 0, n
    assert not any(n[k] for k in ("full_search", "full_search_g", "full_search_haloed"))
    for (gp, _), (wp, _) in zip(got, want):
        assert [p.to_bytes() for p in gp] == [p.to_bytes() for p in wp]


# ---- the one-launch MC predictor and the register-tiled full search -------

def _mc_case(rng, dev, lead, h, w, fmt):
    """Reference stacks (one plane, or the four parity planes at format 4),
    vectors on the range's edges (pels, or half-pels at format 4) and
    modes with an intra MB row."""
    r = 16 if fmt < 4 else 32
    nby, nbx = h // 16, w // 16
    planes = [_t(rng.integers(0, 256, (*lead, ph, pw)), dev)
              for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    dy, dx = (rng.integers(-r, r + 1, (*lead, nby, nbx)) for _ in range(2))
    dy[..., 0, :], dx[..., :, 0], dy[..., -1, :], dx[..., :, -1] = -r, -r, r, r
    dy[..., 0, -1], dx[..., -1, 0] = r - 1, 1 - r
    inter = torch.from_numpy(rng.random((*lead, nby, nbx)) < 0.8).to(dev)
    inter[..., 1, :] = False
    refs = tuple(motion.hpel_stack(p) if fmt >= 4 else p.unsqueeze(-3)
                 for p in planes)
    return refs, _t(dy, dev), _t(dx, dev), inter


@pytest.mark.parametrize("fmt", [1, 4])
@pytest.mark.parametrize("lead,h,w", [((), 1088, 1920), ((), 368, 640),
                                      ((4,), 1088, 1920), ((3,), 48, 80)])
def test_mc_predict_kernel(cuda, plain_and_kernel, rng, lead, h, w, fmt):
    """The three predictors of a P step in one launch, equal to the plain
    composition; with a G axis also to G single launches. Each plane's
    view of the one output buffer is contiguous."""
    refs, dy, dx, inter = _mc_case(rng, cuda, lead, h, w, fmt)
    got, want = plain_and_kernel(dispatch.mc_predict, refs, dy, dx, inter)
    assert build.LAUNCHES["mc_predict_g" if lead else "mc_predict"] > 0
    assert _same(got, want) and all(p.is_contiguous() for p in got)
    if lead:
        for i in range(lead[0]):
            one = dispatch.mc_predict(tuple(r[i] for r in refs), dy[i], dx[i],
                                      inter[i])
            assert _same(one, tuple(p[i] for p in got))


def _windows(stack, r, sr, sc):
    """The tiles of a reference stack [P, H, W] as the pre-haloed encode
    has them, [Sr * Sc, P, h + 2r, w (+ 2r with Sc > 1)]: windows of
    pad_ref of the whole stack (format 4: parity first, then the pad)."""
    _, hh, ww = stack.shape
    h, w = hh // sr, ww // sc
    pad = motion.pad_ref(stack, r)
    cw, c0 = (w + 2 * r, 0) if sc > 1 else (w, r)
    return torch.stack([pad[:, i * h:i * h + h + 2 * r, c0 + j * w:c0 + j * w + cw]
                        for i in range(sr) for j in range(sc)]).contiguous()


@pytest.mark.parametrize("fmt", [1, 4])
@pytest.mark.parametrize("sr,sc,h,w", _HALOED_SHAPES)
def test_mc_predict_haloed_kernel(cuda, plain_and_kernel, rng, sr, sc, h, w, fmt):
    """The shards' predictors from their pre-haloed stacks: the plain
    version's and, put together, the unsharded kernel's on the whole
    frame; a single shard also without the batch axis."""
    refs, dy, dx, inter = _mc_case(rng, cuda, (), h, w, fmt)
    exts = tuple(_windows(s, r, sr, sc) for s, r in zip(refs, (16, 8, 8)))
    sh = tuple(_split(a, sr, sc) for a in (dy, dx, inter))
    got, want = plain_and_kernel(dispatch.mc_predict_pre_haloed, exts, *sh)
    assert _same(got, want)
    whole = dispatch.mc_predict(refs, dy, dx, inter)
    assert _same(tuple(_join(g, sr, sc) for g in got), whole)
    one = dispatch.mc_predict_pre_haloed(tuple(e[0] for e in exts),
                                         *(a[0] for a in sh))
    assert _same(one, tuple(g[0] for g in got))
    assert build.LAUNCHES["mc_predict_haloed"] > 0


_CORNERS = ((16, 16), (-16, -16), (16, -16), (-16, 16))


@pytest.mark.parametrize("kind", ["flat", "corners"])
@pytest.mark.parametrize("h,w", [(1088, 1920), (368, 640)])
def test_full_search_kernel_ties_and_corners(cuda, plain_and_kernel, rng, kind,
                                             h, w):
    """A flat plane, where all 1089 candidates of every MB tie and the
    first, (-16, -16), must win; and a frame whose four quadrants pan to
    the four corner vectors of the window."""
    cur = rng.integers(0, 256, (h, w))
    if kind == "flat":
        cur[:] = 77
        ref = cur.copy()
    else:
        ref = cur.copy()
        for q, (vy, vx) in enumerate(_CORNERS):
            ys = slice(0, h // 2) if q < 2 else slice(h // 2, h)
            xs = slice(0, w // 2) if q % 2 == 0 else slice(w // 2, w)
            ref[ys, xs] = np.roll(cur, (vy, vx), (0, 1))[ys, xs]
    got, want = plain_and_kernel(dispatch.full_search, _t(cur, cuda), _t(ref, cuda))
    assert _same(got, want)
    dy, dx, sad = (a.cpu().numpy() for a in got)
    if kind == "flat":
        assert (dy == -16).all() and (dx == -16).all() and (sad == 0).all()
        return
    nby, nbx = h // 16, w // 16
    for q, (vy, vx) in enumerate(_CORNERS):
        ys = slice(0, nby // 2) if q < 2 else slice(nby // 2, nby)
        xs = slice(0, nbx // 2) if q % 2 == 0 else slice(nbx // 2, nbx)
        hit = (dy[ys, xs] == vy) & (dx[ys, xs] == vx) & (sad[ys, xs] == 0)
        assert hit.mean() > 0.5, (q, hit.mean())


def test_full_search_g_kernel_four_corners(cuda, plain_and_kernel, rng):
    """G = 4 planes of 1088x1920, GOP g panned to corner vector g: one
    launch equal to its plain version and to four single launches, each
    GOP on its own corner."""
    h, w = 1088, 1920
    cur = rng.integers(0, 256, (4, h, w))
    ref = np.stack([np.roll(cur[i], v, (0, 1)) for i, v in enumerate(_CORNERS)])
    args = (_t(cur, cuda), _t(ref, cuda))
    got, want = plain_and_kernel(dispatch.full_search, *args)
    assert _same(got, want) and _same(got, _per_g(dispatch.full_search, 4, *args))
    for i, (vy, vx) in enumerate(_CORNERS):
        hit = (got[0][i] == vy) & (got[1][i] == vx)
        assert float(hit.float().mean()) > 0.9, i


# ---- the register-tiled maps and the per-block sad_at_mv:
# the corner and all-tied MBs of the even map, and the candidate sets of
# every caller of sad_at_mv, single and G = 4 -------------------------------

def _corner_tied(rng, lead, h, w):
    """Planes [*lead, h, w] whose interior MBs match best at the (+16, -16)
    corner of the window (ref is cur moved by (-16, +16), a smooth texture
    without noise) and where MB (0, 0) and its whole window are flat, so
    every candidate of that MB ties."""
    n = int(np.prod(lead)) if lead else 1
    out = []
    for _ in range(n):
        base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.int64)
        for _ in range(2):
            base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
        cur = base[32:32 + h, 32:32 + w].copy()
        ref = base[16:16 + h, 48:48 + w].copy()
        cur[:16, :16] = 100
        ref[:32, :32] = 100
        out.append((cur, ref))
    cur = np.stack([c for c, _ in out]).reshape(*lead, h, w)
    ref = np.stack([r for _, r in out]).reshape(*lead, h, w)
    return cur, ref


@pytest.mark.parametrize("g", [None, 4])
@pytest.mark.parametrize("h,w", [(368, 640), (48, 80)])
def test_sad_map_even_corner_and_ties_kernel(cuda, plain_and_kernel, rng, g, h, w):
    """The even map where its first minimum sits on the window's corner
    and where all 289 candidates tie: equal to the plain version, and for
    G = 4 to four single launches."""
    lead = () if g is None else (g,)
    cur, ref = _corner_tied(rng, lead, h, w)
    args = (_t(cur, cuda), _t(ref, cuda))
    got, want = plain_and_kernel(dispatch.sad_map_even, *args)
    assert torch.equal(got, want)
    best = got.argmin(-1)
    assert bool((best[..., 1:-1, 1:-1] == 16 * 17).all())     # (16, -16)
    assert bool((got[..., 0, 0, :] == got[..., 0, 0, :1]).all())
    if g:
        assert torch.equal(got, _per_g(dispatch.sad_map_even, g, *args))
        assert build.LAUNCHES["sad_map_even_g"] > 0


@pytest.mark.parametrize("g", [None, 4])
def test_sad_map_corner_and_ties_kernel(cuda, plain_and_kernel, rng, g):
    lead = () if g is None else (g,)
    cur, ref = _corner_tied(rng, lead, 48, 80)
    args = (_t(cur, cuda), _t(ref, cuda))
    got, want = plain_and_kernel(dispatch.sad_map, *args)
    assert torch.equal(got, want)
    assert bool((got.argmin(-1)[..., 1:-1, 1:-1] == 32 * 33).all())
    if g:
        assert torch.equal(got, _per_g(dispatch.sad_map, g, *args))


def _sad_at_case(rng, case, lead, h, w):
    """(cur, ref or planes, dy, dx, plane_of) of one caller's candidate set
    on planes [*lead, h, w]: diamond (the four +-1 around even vectors),
    hpel (the half-pel refine's nine on four parity planes), hier (25 on a
    5x5 square), planes16 (16 candidates on 16 planes), window (the four
    corners of the window and random ones: the box is the whole window),
    one (K = 1, no candidate axis), many (K = 40: two rounds of 32)."""
    nby, nbx = h // 16, w // 16
    cur = rng.integers(0, 256, (*lead, h, w))
    n_planes = {"hpel": 4, "planes16": 16}.get(case)
    ref = rng.integers(0, 256, (*lead, *([n_planes] if n_planes else []), h, w))
    centre = rng.integers(-16, 17, (2, *lead, 1, nby, nbx))
    centre[:, ..., 0, 0] = -16
    centre[:, ..., -1, -1] = 16
    plane_of = None
    if case == "diamond":
        centre = centre // 2 * 2
        offs = [(-1, 0), (0, -1), (0, 1), (1, 0)]
    elif case == "hpel":
        offs = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
        plane_of = [abs(u) * 2 + abs(v) for u, v in offs]
        centre = 2 * centre
    elif case == "hier":
        offs = [(u, v) for u in range(-2, 3) for v in range(-2, 3)]
    elif case == "planes16":
        offs = [(0, 0)] * 16
        plane_of = list(rng.permutation(16))
        centre = rng.integers(-16, 17, (2, *lead, 16, nby, nbx))
    elif case == "window":
        offs = [(0, 0)] * 7
        centre = rng.integers(-16, 17, (2, *lead, 7, nby, nbx))
        for k, (sy, sx) in enumerate(((-1, -1), (-1, 1), (1, -1), (1, 1))):
            centre[0, ..., k, :, :], centre[1, ..., k, :, :] = 16 * sy, 16 * sx
    elif case == "one":
        offs = [(0, 0)]
    else:
        offs = [(0, 0)] * 40
        centre = rng.integers(-16, 17, (2, *lead, 40, nby, nbx))
    u = np.array([o[0] for o in offs]).reshape(-1, 1, 1)
    v = np.array([o[1] for o in offs]).reshape(-1, 1, 1)
    if case == "hpel":      # integer parts of the half-pel candidates
        dy, dx = (centre[0] + u) >> 1, (centre[1] + v) >> 1
    else:
        dy, dx = centre[0] + u, centre[1] + v
    dy, dx = np.clip(dy, -16, 16), np.clip(dx, -16, 16)
    if case == "one":
        dy, dx = dy[..., 0, :, :], dx[..., 0, :, :]
    return cur, ref, dy, dx, plane_of


@pytest.mark.parametrize("g", [None, 4])
@pytest.mark.parametrize("case", ["diamond", "hpel", "hier", "planes16",
                                  "window", "one", "many"])
def test_sad_at_mv_candidate_sets_kernel(cuda, plain_and_kernel, rng, case, g):
    lead = () if g is None else (g,)
    h, w = (368, 640) if case != "planes16" or g is None else (96, 160)
    cur, ref, dy, dx, plane_of = _sad_at_case(rng, case, lead, h, w)
    args = (_t(cur, cuda), _t(ref, cuda), _t(dy, cuda), _t(dx, cuda), plane_of)
    got, want = plain_and_kernel(dispatch.sad_at_mv, *args)
    assert torch.equal(got, want) and got.shape == dy.shape
    assert build.LAUNCHES["sad_at_mv" if g is None else "sad_at_mv_g"] > 0
    if g:
        assert torch.equal(got, _per_g(dispatch.sad_at_mv, g, *args))


@pytest.mark.parametrize("case", ["diamond", "hpel", "hier", "window"])
@pytest.mark.parametrize("sr,sc", [(4, 1), (2, 2)])
def test_sad_at_mv_haloed_candidate_sets_kernel(cuda, plain_and_kernel, rng,
                                               case, sr, sc):
    """The same sets on pre-haloed shards (a row halo; both halos): equal
    to the plain version and, joined, to the unsharded kernel."""
    h, w = 256, 384
    cur, ref, dy, dx, plane_of = _sad_at_case(rng, case, (), h, w)
    cur, dy, dx = _t(cur, cuda), _t(dy, cuda), _t(dx, cuda)
    ref = _t(ref, cuda)
    planes = ref if plane_of else ref[None]
    ext = torch.stack([_ext(q, sr, sc, 16) for q in planes], 1)
    ext = ext.contiguous() if plane_of else ext[:, 0].contiguous()
    args = (_split(cur, sr, sc), ext, _split(dy, sr, sc), _split(dx, sr, sc),
            plane_of)
    got, want = plain_and_kernel(dispatch.sad_at_mv_pre_haloed, *args)
    assert torch.equal(got, want)
    assert torch.equal(_join(got, sr, sc),
                       dispatch.sad_at_mv(cur, ref, dy, dx, plane_of))


@pytest.mark.parametrize("g", [None, 4])
@pytest.mark.parametrize("case", ["diamond", "window", "many"])
def test_sad_at_mv_chroma_candidate_sets_kernel(cuda, plain_and_kernel, rng,
                                               case, g):
    """The chroma twin (8x8 blocks, radius 8) on the luma sets halved."""
    lead = () if g is None else (g,)
    cur, ref, dy, dx, _ = _sad_at_case(rng, case, lead, 368, 640)
    cur, ref = cur[..., :184, :320], ref[..., :184, :320]
    dy = np.repeat(np.repeat(dy[..., :, :], 2, -2), 2, -1)[..., :23, :40] // 2
    dx = np.repeat(np.repeat(dx[..., :, :], 2, -2), 2, -1)[..., :23, :40] // 2
    args = (_t(cur, cuda), _t(ref, cuda), _t(dy, cuda), _t(dx, cuda))
    got, want = plain_and_kernel(dispatch.sad_at_mv_chroma, *args)
    assert torch.equal(got, want)
    if g:
        assert torch.equal(got, _per_g(dispatch.sad_at_mv_chroma, g, *args))


# ---- the decoders: recon_plane, recon_plane_rows and the device engines ----

def _recon_case(rng, lead, h, w, extreme=False):
    """Zigzag levels int16 [.., h/8, w/8, 64] and steps [.., h/8, w/8]:
    sparse small levels at qp 1, 12, 28 and 63 mixed per block, or, with
    extreme, levels drawn from the int16 extremes at the largest step
    (the inverse's sums then leave int32 and wrap)."""
    shape = (*lead, h // 8, w // 8, 64)
    if extreme:
        lv = rng.choice([-32768, -32767, 32767, 0, 1], shape)
        qp = np.full(shape[:-1], 63)
    else:
        lv = np.where(rng.random(shape) < 0.8, 0, rng.integers(-60, 61, shape))
        qp = rng.choice([1, 12, 28, 63], shape[:-1])
    return lv.astype(np.int16), qp


def _recon_args(cuda, lv, qp):
    q_blk = tables.load(cuda).QSTEP[_t(qp, cuda).long()].contiguous()
    return torch.from_numpy(lv).to(cuda), q_blk


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (368, 640),
                                 (184, 320)])
def test_recon_plane_kernel(cuda, plain_and_kernel, rng, h, w, qmat, flat,
                            extreme):
    """The inter recon against its plain version, and its byte plane;
    flat is the I frame's 128 of formats 1-2."""
    lv, q_blk = _recon_args(cuda, *_recon_case(rng, (), h, w, extreme))
    pred = None if flat else _t(rng.integers(0, 256, (h, w)), cuda)
    got, want = plain_and_kernel(dispatch.recon_plane, lv, pred, q_blk, qmat)
    assert torch.equal(got, want)
    out8 = torch.empty((h, w), dtype=torch.uint8, device=cuda)
    rec = dispatch.recon_plane(lv, pred, q_blk, qmat, out8)
    assert torch.equal(rec, want) and torch.equal(out8.int(), want)
    assert int(want.min()) >= 0 and int(want.max()) <= 255


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("g", [None, 3])
@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("reset_rows", [0, 2, 17])
@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (368, 640),
                                 (184, 320)])
def test_recon_plane_rows_kernel(cuda, plain_and_kernel, rng, h, w,
                                 reset_rows, qmat, g, extreme):
    """The format-3/4 I-frame recon against the plain stripe loop: one
    launch for the plane (or B planes), with and without intra slices."""
    lead = () if g is None else (g,)
    lv, q_blk = _recon_args(cuda, *_recon_case(rng, lead, h, w, extreme))
    got, want = plain_and_kernel(dispatch.intra_rows_recon_plane, lv, q_blk,
                                 reset_rows, qmat)
    assert torch.equal(got, want)
    assert build.LAUNCHES["recon_plane_rows"] > 0
    out8 = torch.empty(want.shape, dtype=torch.uint8, device=cuda)
    dispatch.intra_rows_recon_plane(lv, q_blk, reset_rows, qmat, out8)
    assert torch.equal(out8.int(), want)


def test_recon_kernels_reject_what_they_do_not_take(cuda):
    lv = torch.zeros((4, 6, 64), dtype=torch.int16, device=cuda)
    q = torch.ones((4, 6), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int16"):
        dispatch.recon_plane(lv.int(), None, q)
    with pytest.raises(ValueError, match="aligned"):
        dispatch.recon_plane(
            torch.zeros(4 * 6 * 64 + 1, dtype=torch.int16,
                        device=cuda)[1:].view(4, 6, 64), None, q)
    with pytest.raises(ValueError, match="shape"):
        dispatch.recon_plane(lv, torch.zeros((32, 40), dtype=torch.int32,
                                             device=cuda), q)
    with pytest.raises(ValueError, match="reset_rows"):
        dispatch.intra_rows_recon_plane(lv, q, -1)


_DECODE_CFGS = [
    dict(),
    dict(format_version=2, chroma_qp_offset=3),
    dict(format_version=3, quant_matrix=True, intra_slice_mbrows=1),
    dict(format_version=4, quant_matrix=True, chroma_qp_offset=2),
]


@pytest.mark.parametrize("kw", _DECODE_CFGS)
def test_device_decoders_on_card_match_native(cuda, rng, kw):
    """The port's own stream (encoded on the CPU, two GOPs) decoded on the
    card by both device engines equals the C++ decode frame for frame;
    the launches are the decode path's: mc_predict once per P frame,
    recon_plane three times per P frame (and per I frame at formats 1-2),
    recon_plane_rows three times per I frame at formats 3-4, nothing
    else."""
    import io

    from video_encoder_tpu_torch.codec.bitstream import OrderedMux
    from video_encoder_tpu_torch.pipeline import decoder

    frames = _pan_frames(rng, 6, 64, 96)
    cfg = EncoderConfig(width=96, height=64, gop_n=3, base_qp=24, **kw)
    eng = GopEngine(cfg, device="cpu")
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, 6)
    for s in (0, 3):
        for p in eng.encode_gop(frames[s:s + 3], s)[0]:
            mux.push(p)
    mux.close()
    data = buf.getvalue()
    _, want = decoder.decode_clip_native(io.BytesIO(data))
    want = list(want)
    fmt = cfg.format_version
    expect = {"mc_predict": 4, "recon_plane": 12 + (6 if fmt < 3 else 0),
              "recon_plane_rows": 6 if fmt >= 3 else 0}
    for run in (lambda: decoder.decode_clip_gop(
                    io.BytesIO(data), decoder.GopDecodeEngine(device=cuda)),
                lambda: decoder.decode_clip(
                    io.BytesIO(data), decoder.DeviceDecodeEngine(device=cuda))):
        build.reset_launches()
        _, got = run()
        got = list(got)
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        assert launches == {k: v for k, v in expect.items() if v}
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("search,rc", [("full", "none"), ("diamond", "bitrate"),
                                       ("full", "adaptive"), ("diamond", "vbv")])
def test_device_engine_on_card_matches_cpu(cuda, rng, search, rc):
    """The per-frame engine (`encode --engine device`) on the card: the
    CPU's stream, the search (or the even map and the descent) and
    mc_predict once per P frame, code_plane three times per frame, and no
    block_pack, span merge or single-plane fetch."""
    import io

    from video_encoder_tpu_torch.pipeline.device_engine import DeviceEngine
    from video_encoder_tpu_torch.pipeline.encoder import encode_clip

    base = rng.integers(0, 256, (80, 112))
    clip = [(base[2 * t:2 * t + 64, 3 * t:3 * t + 96].astype(np.uint8),
             np.full((32, 48), 100 + t, np.uint8),
             np.full((32, 48), 150, np.uint8)) for t in range(5)]
    cfg = EncoderConfig(width=96, height=64, gop_n=3, base_qp=24,
                        search=search, rc=rc, target_kbps=300)
    got, want = io.BytesIO(), io.BytesIO()
    build.reset_launches()
    encode_clip(cfg, clip, got, 5, engine=DeviceEngine(cuda))
    launches = dict(build.LAUNCHES)
    encode_clip(cfg, clip, want, 5, engine=DeviceEngine("cpu"))
    assert got.getvalue() == want.getvalue()
    p_frames = 3
    search_kernels = (["full_search"] if search == "full"
                      else ["sad_map_even", "diamond_descent"])
    assert {k: v for k, v in launches.items() if v} == dict(
        {k: p_frames for k in search_kernels}, mc_predict=p_frames,
        code_plane=3 * 5), launches


_TRACE_SCRIPT = r"""
import json, pathlib, sys
import torch
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.utils.trace import trace
out = pathlib.Path(sys.argv[1])
cur = torch.randint(0, 256, (64, 96), dtype=torch.int32, device="cuda")
ref = torch.randint(0, 256, (64, 96), dtype=torch.int32, device="cuda")
q = torch.full((8, 12), 20, dtype=torch.int32, device="cuda")
for session in ("a", "b"):
    with trace(str(out / session)):
        dispatch.full_search(cur, ref)
        dispatch.code_plane(cur, ref, q)
    (path,) = (out / session).glob("*.pt.trace.json")
    print(json.dumps([e.get("name", "") for e in
                      json.loads(path.read_text())["traceEvents"]
                      if e.get("cat") == "kernel"]))
"""


def test_trace_on_card_names_the_kernels(cuda, tmp_path):
    """utils.trace.trace on the card records the kernels' own names, the
    first kernel of the block too, in a process's first profiler session
    and in a later one. It runs in a process of its own, as `encode
    --trace` does: in a process that has run for a minute or more,
    torch.profiler can lose some or all of a short session's kernels."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _TRACE_SCRIPT, str(tmp_path)],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    sessions = [json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith("[")]
    assert len(sessions) == 2
    for kernels in sessions:
        assert any("tiled_kernel" in n for n in kernels), kernels
        assert any("plane_kernel" in n for n in kernels), kernels


# ---- ranks on the card (parallel/, one process per rank) ----------------

def _rank_clip(tmp_path, n=9, h=64, w=96):
    """A small clip written for the ranks to read, and its frames."""
    from video_encoder_tpu_torch.parallel import multiprocess as mp

    y, cb, cr = mp.synth_gops(1, n, h, w, seed=4)
    path = tmp_path / "clip.yuv"
    with open(path, "wb") as f:
        for t in range(n):
            f.write(y[0, t].tobytes() + cb[0, t].tobytes() + cr[0, t].tobytes())
    return str(path), [Frame.from_planes(y[0, t], cb[0, t], cr[0, t])
                       for t in range(n)]


def _rank_jobs(path, cfg, world):
    """DP over the ranks, the tile program of one GOP in row shards over
    them (S = 1 at world 1), the transport check; row-shard ranks of the
    sharded clip encode too where there are two."""
    import dataclasses

    base = dict(cfg=dataclasses.asdict(cfg), clip=path, width=cfg.width,
                height=cfg.height)
    n_mbs = (cfg.height // 16) * (cfg.width // 16) // world
    jobs = [dict(base, kind="gops", mesh=[world, 1],
                 schedule=[[(k * world + g) * cfg.gop_n for g in range(world)]
                           for k in range(3 // world)]),
            dict(base, kind="tiles", first=cfg.gop_n, ref_mode="halo",
                 emit="chunks", block_words=entropy.BLOCK_WORDS_MAX,
                 cap_words=entropy.max_words(n_mbs)),
            dict(kind="transport", seed=2, shape=[32, 48], halos=[1, 16],
                 grid=[world, 1])]
    if world > 1:
        jobs.append(dict(base, kind="gops", mesh=[1, world],
                         schedule=[[0], [cfg.gop_n], [2 * cfg.gop_n]]))
    return jobs


@pytest.mark.parametrize("world", [1, 2])
def test_ranks_on_card_match_one_device(cuda, tmp_path, world):
    """DP and row-shard ranks on the card: world 1 over NCCL (every rank
    has a card), 2 ranks over gloo where they share one card (NCCL where
    the host has two). Every GOP, and the tile program's glued frames,
    equal the single-device engine's on the card; the transport bodies
    equal their tensor-axis bodies; the ranks launched the kernels."""
    from video_encoder_tpu_torch.codec.mux import bit_concat
    from video_encoder_tpu_torch.parallel import multiprocess as mp
    from video_encoder_tpu_torch.parallel.mesh import backend_for

    build.lib()              # once here, before the ranks load it
    cfg = EncoderConfig(width=96, height=64, gop_n=3, base_qp=26)
    path, frames = _rank_clip(tmp_path)
    jobs = _rank_jobs(path, cfg, world)
    results, rows = mp.run_jobs(jobs, world, device="cuda", timeout_s=600)
    eng = GopEngine(cfg, device="cuda")
    want = {f: eng.encode_gop(frames[f:f + 3], f)[0] for f in (0, 3, 6)}
    for j in [0] + ([3] if world > 1 else []):
        got = {pk[0].index: [p.to_bytes() for p in pk]
               for per in results[j].values() for items in per.values()
               for pk, _ in items}
        assert got and got == {f: [p.to_bytes() for p in want[f]] for f in got}
    shards = [results[1][0][r] for r in range(world)]
    for t, pkt in enumerate(want[3]):
        payload, nbits = bit_concat([
            (sh["words"][t, 0, c], int(sh["cbits"][t, 0, c]))
            for sh in shards for c in range(sh["cbits"].shape[-1])
            if sh["cbits"][t, 0, c]])
        assert (payload, nbits) == (pkt.payload, pkt.payload_bits)
    assert all(err == 0 for r in results[2][0].values()
               for _, err in r.values())
    backend = backend_for(world, "cuda")
    assert backend == ("nccl" if world <= torch.cuda.device_count() else "gloo")
    for rank_rows in rows:
        assert all(r["backend"] == backend for r in rank_rows)
        assert rank_rows[0]["launches"].get("full_search", 0) > 0
        assert rank_rows[1]["launches"].get("full_search_haloed", 0) > 0
        assert rank_rows[1]["launches"].get("code_plane_g", 0) > 0


# ---- the diamond descent: the walk and the final ±1 step of every MB in
# one launch (csrc/diamond.cu), against the plain descent ------------------

def _descent(cur, ref):
    """(kernel route, plain route, launches of the kernel route) of
    dispatch.diamond_search on card planes."""
    dispatch.force("plain")
    try:
        want = dispatch.diamond_search(cur, ref)
    finally:
        dispatch.force(None)
    before = dict(build.LAUNCHES)
    got = dispatch.diamond_search(cur, ref)
    torch.cuda.synchronize()
    rise = {k: v - before[k] for k, v in build.LAUNCHES.items()
            if v != before[k]}
    return got, want, rise


def _descent_launches(g):
    s = "" if g is None else "_g"
    return {"sad_map_even" + s: 1, "diamond_descent" + s: 1}


@pytest.mark.parametrize("g", [None, 4])
def test_diamond_descent_kernel_on_content(cuda, g):
    """1088x1920 planes of the config-3 cells' content (portbench's recipe
    with the pan4 mix: the four-pass texture panning (2, 3) px a frame, a
    moving random patch, noise ±2), frame 1 against frame 0 of each GOP:
    the kernel's (dy, dx, sad) equal the plain descent's, from one
    even-map launch and one descent launch; at G = 4 also each GOP's
    single launch."""
    import json
    import pathlib

    from portbench import content

    root = pathlib.Path(__file__).resolve().parents[1]
    mix = json.loads((root / "portbench/traffic/pan4.g1.json").read_text())
    n = g or 1
    ys = [content.pad_to(content.make_gop(mix, 2_000_000_117, i, 2, 1080,
                                          1920, cuda)[0], 16).int()
          for i in range(n)]
    cur = torch.stack([y[1] for y in ys]) if g else ys[0][1]
    ref = torch.stack([y[0] for y in ys]) if g else ys[0][0]
    cur, ref = cur.contiguous(), ref.contiguous()
    got, want, rise = _descent(cur, ref)
    assert _same(got, want) and rise == _descent_launches(g)
    assert got[0].shape == cur.shape[:-2] + (68, 120)
    assert float((got[0] != 0).float().mean()) > 0.5      # the walks moved
    if g:
        assert _same(got, _per_g(dispatch.diamond_search, g, cur, ref))


@pytest.mark.parametrize("g", [None, 3])
@pytest.mark.parametrize("kind,h,w", [
    ("random", 368, 640), ("random", 48, 80), ("pan", 368, 640),
    ("corner", 128, 192), ("corner", 48, 80), ("flat", 64, 96)])
def test_diamond_descent_kernel(cuda, rng, kind, h, w, g):
    """Random planes; a panned texture; long-wave sinusoids moved by
    (16, -16), whose walks run all 16 steps to the window's corner (the
    final step there meets candidates outside ±16, and the MBs on the
    frame's edges read through the clamp); flat planes, where every
    candidate of every step ties. Equal to the plain descent, one launch
    of each kernel."""
    from diamond_cases import planes

    lead = () if g is None else (g,)
    cur, ref = (_t(p, cuda) for p in planes(rng, kind, lead, h, w))
    got, want, rise = _descent(cur, ref)
    assert _same(got, want) and rise == _descent_launches(g)
    if kind == "corner":
        assert int(((got[0].abs() >= 15) & (got[1].abs() >= 15)).sum()) >= 3
    if kind == "flat":
        assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("g", [None, 2])
def test_diamond_descent_kernel_crafted_maps(cuda, rng, g):
    """Maps that set each MB's walk (tests/diamond_cases.py): costs of
    exactly 511 and 512 at the start and after the first move, ties among
    the candidates and with the current vector, a walk that never freezes
    before step 16 and ends on the window's corner, flat and random rows.
    The kernel over the map equals the plain descent over it on the card
    (motion.diamond_descent), in one launch."""
    from diamond_cases import crafted_maps, near_planes

    from video_encoder_tpu_torch.ops import motion
    from video_encoder_tpu_torch.ops.kernels import sad as ksad

    lead = () if g is None else (g,)
    h, w = 128, 320
    cur, ref = (_t(p, cuda) for p in near_planes(rng, lead, h, w))
    maps, cases = crafted_maps(rng, lead, h // 16, w // 16)
    meven = torch.from_numpy(maps).to(cuda)
    want = motion.diamond_descent(cur, ref, meven)
    before = dict(build.LAUNCHES)
    got = ksad.diamond_descent(cur, ref, meven)
    torch.cuda.synchronize()
    name = "diamond_descent" if g is None else "diamond_descent_g"
    assert {k: v - before[k] for k, v in build.LAUNCHES.items()
            if v != before[k]} == {name: 1}
    assert _same(got, want)
    start = torch.from_numpy(cases == "start511").to(cuda)
    assert bool((got[0][start].abs() + got[1][start].abs() <= 1).all())


def test_diamond_descent_rejects(cuda):
    """The wrapper refuses what the kernel does not take: a map of the
    wrong shape or type, planes of another size, an int64 plane."""
    from video_encoder_tpu_torch.ops.kernels import sad as ksad

    cur = torch.zeros((64, 96), dtype=torch.int32, device=cuda)
    meven = torch.zeros((4, 6, 289), dtype=torch.int32, device=cuda)
    for args in ((cur, cur, meven[..., :288]), (cur, cur, meven.long()),
                 (cur, cur[:48], meven), (cur.long(), cur, meven),
                 (cur, cur, meven.cpu())):
        with pytest.raises(ValueError):
            ksad.diamond_descent(*args)


def test_config3_replay_launches_the_descent_per_p_frame(cuda):
    """A GOP-30 config-3 key (diamond search, rc mb) at 192x128: its graph
    launches the descent and the even map 29 times a replay and sad_at_mv
    never (GraphCache.stats()), a replay adds 29 to build.LAUNCHES, and
    the eager, captured and replayed streams equal the CPU's."""
    rng = np.random.default_rng(25)
    big = rng.integers(0, 256, (128 + 64, 192 + 96)).astype(np.int64)
    for _ in range(4):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, 2, 0) + np.roll(big, 2, 1)) // 5
    big = (big - big.min()) * 255 // max(int(big.max() - big.min()), 1)
    frames = [Frame.from_planes(
        big[2 * t:2 * t + 128, 3 * t:3 * t + 192].astype(np.uint8),
        np.full((64, 96), 100 + t, np.uint8), np.full((64, 96), 150, np.uint8))
        for t in range(30)]
    cfg = EncoderConfig(width=192, height=128, gop_n=30, base_qp=26,
                        search="diamond", rc="mb", target_kbps=900)
    eng = GopEngine(cfg, device=cuda)
    runs = []
    for _ in range(3):       # the eager first call, the capture, a replay
        before = dict(build.LAUNCHES)
        packets = eng.encode_gop(frames, 0)[0]
        runs.append(([p.to_bytes() for p in packets],
                     {k: v - before[k] for k, v in build.LAUNCHES.items()}))
    (stats,) = [s for s in eng.cache.stats().values() if s["captures"]]
    assert stats["replays"] == 2
    assert stats["launches"]["diamond_descent"] == 29
    assert stats["launches"]["sad_map_even"] == 29
    assert "sad_at_mv" not in stats["launches"]
    for _, rise in runs:
        assert rise["diamond_descent"] == 29 and rise["sad_at_mv"] == 0
    want = [p.to_bytes() for p in
            GopEngine(cfg, device="cpu").encode_gop(frames, 0)[0]]
    assert all(got == want for got, _ in runs)


# ---- the frame pack's tail: csrc/frame_pack.cu ------------------------------

def _rise(fn):
    """(fn(), the launch counters it raised)."""
    before = dict(build.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in build.LAUNCHES.items()
                 if v != before[k]}


def _plain(fn):
    dispatch.force("plain")
    try:
        out = fn()
    finally:
        dispatch.force(None)
    torch.cuda.synchronize()
    return out


def _tail_frame(rng, dev, lead, h, w, fmt, is_p, p=0.04, dense=False):
    """Levels of the three planes [lead, H/8, W/8, 64] (sparse, or dense
    at |level| 3925) and the MB arrays of a frame: qp deltas in -2..2
    with a few extremes, vectors within +-16 (+-32 half-pels at format 4),
    most MBs inter in a P frame, none in an I frame."""
    nby, nbx = h // 16, w // 16
    mbs = (*lead, nby, nbx)

    def lv(shape):
        if dense:
            return _t(np.where(rng.random(shape) < 0.5, 3925, -3925), dev)
        return _t(rng.integers(-30, 31, shape) * (rng.random(shape) < p), dev)

    levels = (lv((*lead, 2 * nby, 2 * nbx, 64)), lv((*mbs, 64)), lv((*mbs, 64)))
    qpd = rng.integers(-2, 3, mbs)
    qpd.reshape(-1)[:2] = (-26, 26)
    r = 32 if fmt >= 4 else 16
    inter = (rng.random(mbs) < 0.8) if is_p else np.zeros(mbs, bool)
    dy, dx = (np.where(inter, rng.integers(-r, r + 1, mbs), 0) for _ in range(2))
    return levels, (_t(qpd, dev), torch.from_numpy(inter).to(dev), _t(dy, dev),
                    _t(dx, dev))


def _tail_args(levels, hdr, is_p):
    qpd, inter, dy, dx = hdr
    return (*levels, qpd, is_p, inter, dy, dx)


@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("fmt", [1, 2, 4])
@pytest.mark.parametrize("g", [None, 4])
def test_frame_tail_kernels(cuda, rng, g, fmt, is_p):
    """At 1088x1920, G = 1 and 4, both syntaxes, I and P frames: the
    frame emit (pack_frame_planes: two launches after the three block
    packs), rc mb's lengths-only pass (frame_mb_bits: one launch) and the
    chunk emit's headers (pack_frame_chunks: one launch before its merges)
    equal their plain routes, and each pack call raises build.LAUNCHES by
    exactly its launches."""
    lead = () if g is None else (g,)
    levels, hdr = _tail_frame(rng, cuda, lead, 1088, 1920, fmt, is_p)
    args = _tail_args(levels, hdr, is_p)
    cap = entropy.capacity_words(8160)
    bp = "block_pack_v2" if fmt >= 2 else "block_pack"

    def planes():
        return entropy.pack_frame_planes(*args, 16, cap, fmt=fmt)
    got, rise = _rise(planes)
    assert rise == {bp: 3, "frame_headers": 1, "frame_place": 1}
    assert _same(got, _plain(planes)) and not bool(got[3])
    assert got[0].shape == (*lead, cap) and got[1].dtype == torch.int64
    assert int(got[1].min()) > 8160 * 7

    def est():
        return entropy.frame_mb_bits(*args, 16, fmt)
    mb, rise = _rise(est)
    assert rise == {bp: 3, "frame_mb_bits": 1}
    assert torch.equal(mb, _plain(est)) and torch.equal(mb, got[2])

    def chunks():
        return entropy.pack_frame_chunks(*args, 16, fmt=fmt)
    cgot, rise = _rise(chunks)
    assert rise == {bp: 3, "frame_headers": 1, "span_merge_mb": 1,
                    "span_merge": 1}
    assert _same(cgot, _plain(chunks)) and torch.equal(cgot[2], got[2])
    if g:
        single = [entropy.pack_frame_planes(*(a[i] if isinstance(a, torch.Tensor)
                                              else a for a in args), 16, cap,
                                            fmt=fmt) for i in range(g)]
        assert torch.equal(got[0], torch.stack([s[0] for s in single]))
        assert torch.equal(got[1], torch.stack([s[1] for s in single]))


@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("lead,h,w", [((), 1088, 1920), ((4,), 1088, 1920),
                                      ((4,), 544, 960), ((2,), 48, 640)])
def test_frame_tail_rows_kernel(cuda, rng, lead, h, w, is_p):
    """One string per MB row (pack_frame_rows: the tile path's and the
    2-D grid's strings) at 1080p, four 1080p frames, four 544x960 tiles
    and rows of 40 MBs: equal to the plain rows, two launches."""
    levels, hdr = _tail_frame(rng, cuda, lead, h, w, 1, is_p)
    args = _tail_args(levels, hdr, is_p)
    row_words = entropy.capacity_words(w // 16)

    def rows():
        return entropy.pack_frame_rows(*args, 16, row_words)
    got, rise = _rise(rows)
    assert rise == {"block_pack": 3, "frame_headers": 1, "frame_place": 1}
    assert _same(got, _plain(rows)) and not bool(got[3])
    assert got[0].shape == (*lead, h // 16, row_words)


@pytest.mark.parametrize("case", ["block", "block_xl", "cap", "cap_rows", "cap_g"])
def test_frame_tail_overflow_kernel(cuda, rng, case):
    """A block over its budget (dense levels at 2 words a block, and at 16
    words on a 1080p frame): the flag, the untruncated totals and MB
    totals equal the plain version's; a frame (or a row) over cap with
    every block inside its budget: the flag, the totals and the words up
    to cap equal it; one flag for a G = 4 batch of which one frame is
    over; a flag raised by one call does not stay raised in the next."""
    lead = (4,) if case in ("cap_g", "block") else ()
    h, w = (1088, 1920) if case in ("block_xl", "cap", "cap_g") else (48, 640)
    dense = case.startswith("block")
    bw = 2 if case == "block" else 16
    levels, hdr = _tail_frame(rng, cuda, lead, h, w, 1, True, p=0.3,
                              dense=dense)
    if case == "cap_g":       # frame 2's levels doubled: its string is the longest
        levels = tuple(torch.cat([lv[:2], 2 * lv[2:3], lv[3:]]) for lv in levels)
    args = _tail_args(levels, hdr, True)
    per_row = case == "cap_rows"
    pack = entropy.pack_frame_rows if per_row else entropy.pack_frame_planes
    full = _plain(lambda: pack(*args, bw, 1 << 20))
    n_words = 1 << 20 if dense else int(full[1].max()) // 32 - 5
    if case == "cap_g":       # only frame 2 of the four passes cap
        n_words = int(full[1][2]) // 32 - 5
        assert int(full[1].sort().values[-2]) < 32 * n_words < int(full[1][2])
    got = pack(*args, bw, n_words)
    want = _plain(lambda: pack(*args, bw, n_words))
    assert bool(got[3]) and bool(want[3])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if not dense:
        assert torch.equal(got[0], want[0])
    clean = _tail_frame(rng, cuda, lead, h, w, 1, True, p=0.01)
    ok = pack(*_tail_args(*clean, True), 16, entropy.capacity_words(
        (w // 16) * (1 if per_row else h // 16)))
    assert not bool(ok[3])


@pytest.mark.parametrize("search,rc,emit", [("full", "none", "frame"),
                                            ("diamond", "mb", "frame"),
                                            ("full", "none", "chunks")])
def test_gop_replay_launches_the_tail(cuda, search, rc, emit):
    """A GOP-10 key at 192x128 through its graph: each replay launches the
    tail once per frame (GraphCache.stats(): frame_headers and, under
    frame emit, frame_place 10 a replay; rc mb's first pass
    frame_mb_bits 10), a replay adds those counts to build.LAUNCHES, and
    the eager, captured and replayed streams equal the CPU's."""
    rng = np.random.default_rng(27)
    big = rng.integers(0, 256, (128 + 64, 192 + 96)).astype(np.int64)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    frames = [Frame.from_planes(
        big[2 * t:2 * t + 128, 3 * t:3 * t + 192].astype(np.uint8),
        np.full((64, 96), 100 + t, np.uint8), np.full((64, 96), 150, np.uint8))
        for t in range(10)]
    kw = dict(target_kbps=900) if rc == "mb" else {}
    cfg = EncoderConfig(width=192, height=128, gop_n=10, base_qp=26,
                        search=search, rc=rc, **kw)
    eng = GopEngine(cfg, device=cuda, emit=emit)
    runs = []
    for _ in range(3):       # the eager first call, the capture, a replay
        packets, rise = _rise(lambda: eng.encode_gop(frames, 0)[0])
        runs.append(([p.to_bytes() for p in packets], rise))
    (stats,) = [s for s in eng.cache.stats().values() if s["captures"]]
    want = {"frame_headers": 10, "frame_place": 10 if emit == "frame" else 0,
            "frame_mb_bits": 10 if rc == "mb" else 0}
    assert stats["replays"] == 2
    assert {k: stats["launches"].get(k, 0) for k in want} == want
    for _, rise in runs:
        assert {k: rise.get(k, 0) for k in want} == want
    cpu = [p.to_bytes() for p in
           GopEngine(cfg, device="cpu", emit=emit).encode_gop(frames, 0)[0]]
    assert all(got == cpu for got, _ in runs)


def test_frame_tail_rejects(cuda):
    """The wrappers refuse what the kernels do not take: int64 words or
    bits, MB arrays of another grid, a string past the int32 scan's
    MAX_STRING_MBS, block words past BLOCK_WORDS_MAX."""
    from video_encoder_tpu_torch.ops.kernels import assemble as kasm

    def frame(nby, nbx, w=2):
        z = torch.zeros
        blocks = ((z((2 * nby, 2 * nbx, w), dtype=torch.int32, device=cuda),
                   z((2 * nby, 2 * nbx), dtype=torch.int32, device=cuda)),
                  *((z((nby, nbx, w), dtype=torch.int32, device=cuda),
                     z((nby, nbx), dtype=torch.int32, device=cuda))
                    for _ in range(2)))
        hdr = (z((nby, nbx), dtype=torch.int32, device=cuda),
               z((nby, nbx), dtype=torch.bool, device=cuda),
               z((nby, nbx), dtype=torch.int32, device=cuda),
               z((nby, nbx), dtype=torch.int32, device=cuda))
        return blocks, hdr

    blocks, hdr = frame(4, 6)
    long_words = ((blocks[0][0].long(), blocks[0][1]), *blocks[1:])
    long_bits = ((blocks[0][0], blocks[0][1].long()), *blocks[1:])
    for b, h in ((long_words, hdr), (long_bits, hdr),
                 (blocks, (hdr[0][:3], *hdr[1:]))):
        with pytest.raises(ValueError):
            kasm.frame_assemble(b, h, True, 100)
    with pytest.raises(ValueError):
        kasm.frame_assemble(*frame(4, 6, entropy.BLOCK_WORDS_MAX + 1), True, 100)
    big = kasm.MAX_STRING_MBS + 1
    with pytest.raises(ValueError):
        kasm.frame_assemble(*frame(1, big, 1), True, 100)
    # rows of just under the bound, in one string each (empty blocks)
    half = big // 2
    ok = kasm.frame_assemble(*frame(2, half, 1), False,
                             entropy.capacity_words(half), per_row=True)
    torch.cuda.synchronize()
    assert not bool(ok[3]) and ok[1].tolist() == [half, half]   # se(0) each


_PLAIN_TAIL = ("_header_slots", "bitlen", "pack_dense", "shift_split",
               "frame_concat")


@pytest.fixture
def no_plain_tail_on_card(monkeypatch):
    """The plain tail's functions raise when they meet a CUDA tensor and
    the dispatch rule is not forced to the plain versions."""
    def guard(name, fn):
        def checked(*args, **kw):
            if dispatch._FORCE is None and any(
                    isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"entropy.{name} ran on a CUDA tensor")
            return fn(*args, **kw)
        return checked

    for name in _PLAIN_TAIL:
        monkeypatch.setattr(entropy, name, guard(name, getattr(entropy, name)))


@pytest.mark.parametrize("path", ["frame", "chunks", "mb", "fmt4", "batch",
                                  "tiles", "ring", "grid"])
def test_no_plain_tail_on_card_paths(cuda, rng, no_plain_tail_on_card, path):
    """On the GOP engine's (both emits, rc mb, format 4, a lockstep batch),
    the tile loop's (chunk emit), the ring's and the 2-D grid's (row
    strings) paths no _header_slots,
    bitlen, pack_dense, shift_split or frame_concat runs on a CUDA tensor,
    eagerly, under capture and under replay (three calls), and the tail's
    launches rose on each call; the streams equal the CPU's."""
    from video_encoder_tpu_torch.parallel.mesh import make_ring_mesh
    from video_encoder_tpu_torch.parallel.ring import RingEncoder

    t = 3
    frames = _pan_frames(rng, 4 * t)
    kw = dict(fmt4=dict(format_version=4, quant_matrix=True,
                        chroma_qp_offset=2),
              mb=dict(search="diamond", rc="mb", target_kbps=300)).get(path, {})
    cfg = EncoderConfig(**{**dict(width=96, height=128, gop_n=t, base_qp=26),
                           **kw})
    gops = [frames[i * t:(i + 1) * t] for i in range(2)]
    if path == "grid":
        y, cb, cr = (torch.from_numpy(np.stack([getattr(f, p) for f in frames[:t]]))
                     .to(cuda) for p in ("y", "cb", "cr"))
        mesh = make_tile_mesh_2d(2, 2, cuda)
        tiles._TILE2D_CACHES.clear()

        def encode():
            outs = tiles.encode_gop_tiled2d(
                y, cb, cr, 26, mesh=mesh, rc="none",
                block_words=entropy.BLOCK_WORDS_MAX,
                row_words=entropy.max_words(96 // 16 // 2),
                target_bits=cfg.target_bits_per_frame(), vbv_bits=0)
            w_, b_ = outs["words"].cpu().numpy(), outs["row_bits"].cpu().numpy()
            return [tiles.assemble_frame_2d(w_, b_, k) for k in range(t)]
        want = [(p.payload, p.payload_bits) for p in
                GopEngine(cfg, device="cpu").encode_gop(frames[:t], 0)[0]]
    elif path == "ring":
        ring = RingEncoder(cfg, make_ring_mesh(2, cuda))

        def encode():
            return [[p.to_bytes() for p in s]
                    for s in ring.encode_streams(gops, [0, t])]
        want = [[p.to_bytes() for p in s] for s in RingEncoder(
            cfg, make_ring_mesh(2, "cpu")).encode_streams(gops, [0, t])]
    else:
        if path == "tiles":
            enc = ShardedGopEncoder(cfg, make_codec_mesh(2, 2, cuda))
            cpu = GopEngine(cfg, device="cpu")
        else:
            emit = "chunks" if path == "chunks" else "frame"
            enc = GopEngine(cfg, device=cuda, emit=emit)
            cpu = GopEngine(cfg, device="cpu", emit=emit)
        batch = gops if path in ("batch", "tiles") else gops[:1]
        firsts = [0, t][:len(batch)]

        def encode():
            return [[p.to_bytes() for p in gp]
                    for gp, _ in enc.finish(enc.start(batch, firsts))]
        want = [[p.to_bytes() for p in gp]
                for gp, _ in cpu.finish(cpu.start(batch, firsts))]
    for _ in range(3):
        got, rise = _rise(encode)
        assert got == want
        assert rise.get("frame_headers", 0) > 0
        assert rise.get("frame_place", 0) == (
            0 if path in ("chunks", "tiles") else rise["frame_headers"])
        assert rise.get("frame_mb_bits", 0) == (rise["frame_headers"]
                                                if path == "mb" else 0)
