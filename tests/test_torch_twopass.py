"""The port's two-pass encode (pipeline/encoder.py) on the CPU against the
reference's encode_clip_twopass with the reference GopEngine: the same
file, byte for byte, and the same GOP-level qps. The allocation is host
float math copied letter for letter, so its qps are equal too."""

import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

from conftest import make_clip
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.ops import dispatch as jdispatch
from video_encoder_tpu.pipeline import encoder as jencoder
from video_encoder_tpu.pipeline import gop_engine as jgop
from video_encoder_tpu_torch.codec.bitstream import demux
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.pipeline import encoder
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(1)

W, H, N, GOP = 48, 32, 8, 3      # two full GOPs and a short one


def _clip():
    """An easy GOP, then noise: the allocation has something to move."""
    rng = np.random.default_rng(77)
    noisy = [(rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
             for _ in range(N - GOP)]
    return make_clip(rng, W, H, GOP) + noisy


_CASES = {
    "bitrate": dict(rc="bitrate", target_kbps=120),
    "vbv-v2-diamond": dict(rc="vbv", target_kbps=400, vbv_kbits=60,
                           format_version=2, chroma_qp_offset=2,
                           search="diamond"),
    "mb-v4-qmat": dict(rc="mb", target_kbps=250, format_version=4,
                       quant_matrix=True),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    rcfg = EncoderConfig(width=W, height=H, gop_n=GOP, base_qp=26,
                         **_CASES[case])
    want = io.BytesIO()
    jdispatch.force("jnp")
    try:
        jencoder.encode_clip_twopass(rcfg, lambda: iter(_clip()), want, N,
                                     engine=jgop.GopEngine(rcfg))
    finally:
        jdispatch.force(None)
    return rcfg, want.getvalue()


@pytest.mark.parametrize("emit", ["frame", "chunks"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_twopass_matches_reference(case, emit):
    rcfg, want = _reference(case)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    got = io.BytesIO()
    seen = []
    summary = encoder.encode_clip_twopass(
        cfg, lambda: iter(_clip()), got, N,
        engine=GopEngine(cfg, device="cpu", emit=emit), on_frame=seen.append)
    assert got.getvalue() == want
    assert summary.frames == N == len(seen)
    info, packets = demux(io.BytesIO(got.getvalue()))
    assert info.config_hash == cfg.config_hash()    # the original config's
    qps = [p.base_qp for p in packets]
    assert len(set(qps[:3])) == len(set(qps[3:6])) == len(set(qps[6:])) == 1
    assert len(set(qps)) > 1                        # constant inside a GOP only
    assert [s.base_qp for s in seen] == qps


def test_twopass_rebuilds_its_engine_on_the_same_device_and_emit():
    """Both passes run on a new engine under the constant-qp config, which
    keeps the given engine's device and emit; pass 2's qps are the
    allocation of pass 1's sizes."""
    made, calls = [], []

    class Spy(GopEngine):
        def __init__(self, cfg, device="cuda", emit=None):
            super().__init__(cfg, device=device, emit=emit)
            made.append(self)

        def encode_gop(self, frames, first_index, base_qp=None):
            out = super().encode_gop(frames, first_index, base_qp)
            calls.append((first_index, base_qp,
                          sum(p.payload_bits for p in out[0])))
            return out

    cfg = config_from_dict(dict(width=W, height=H, gop_n=GOP, base_qp=26,
                                rc="vbv", target_kbps=200, vbv_kbits=50))
    given = Spy(cfg, device="cpu", emit="chunks")
    encoder.encode_clip_twopass(cfg, lambda: iter(_clip()), io.BytesIO(), N,
                                engine=given)
    assert len(made) == 2 and made[1] is not given
    used = made[1]
    assert used.device == given.device and used.emit == "chunks"
    assert (used.cfg.rc, used.cfg.target_kbps, used.cfg.vbv_kbits) == ("none", 0, 0)
    assert [(f, q) for f, q, _ in calls[:3]] == [(0, 26), (3, 26), (6, 26)]
    want = encoder.allocate_gop_qps(26, [b for _, _, b in calls[:3]], [3, 3, 2],
                                    cfg.target_bits_per_frame())
    assert [q for _, q, _ in calls[3:]] == want


@pytest.mark.parametrize("kw", [dict(), dict(rc="adaptive"),
                                dict(rc="bitrate", target_kbps=0)])
def test_twopass_needs_a_target(kw):
    cfg = config_from_dict(dict(width=W, height=H, gop_n=GOP, **kw))
    out = io.BytesIO()
    with pytest.raises(ValueError, match="two-pass needs target_kbps > 0"):
        encoder.encode_clip_twopass(cfg, lambda: iter(_clip()), out, N,
                                    engine=GopEngine(cfg, device="cpu"))
    assert out.getvalue() == b""


@pytest.mark.parametrize("seed", range(6))
def test_allocate_gop_qps_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    bits = [int(b) for b in rng.integers(0, 10 ** int(rng.integers(2, 9)), n)]
    lens = [int(x) for x in rng.integers(1, 61, n)]
    if seed == 0:
        bits[0] = 0                                 # an empty GOP
    for base_qp in (1, 28, 63):
        for target in (1, 4000, 400_000, 40_000_000):
            for alpha in (0.6, 1.0, 0.0):
                assert encoder.allocate_gop_qps(
                    base_qp, bits, lens, target, alpha
                ) == jencoder.allocate_gop_qps(base_qp, bits, lens, target, alpha)
