"""The traffic generator: deterministic per seed, distinct GOPs, the
padding Frame.from_planes gives."""

import numpy as np
import pytest
import torch

from portbench.tests.helpers import ROOT
from portbench import content, run

MIXES = ("pan2.g1", "pan4.g1", "pan2.g4", "pan4.g4")


def _mix_enc(mix_name, w=96, h=56, t=3):
    mix = run.load_json(f"{ROOT}/portbench/traffic/{mix_name}.json")
    enc = dict(width=w, height=h, gop_n=t)
    return mix, enc


@pytest.mark.parametrize("mix_name", MIXES)
def test_pool_is_the_same_for_a_seed(mix_name):
    mix, enc = _mix_enc(mix_name)
    a = content.make_pool(mix, enc, 2**31 + 11, "cpu")
    b = content.make_pool(mix, enc, 2**31 + 11, "cpu")
    c = content.make_pool(mix, enc, 2**31 + 12, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("mix_name", MIXES)
def test_pool_gops_are_distinct_and_shaped(mix_name):
    mix, enc = _mix_enc(mix_name)
    pool = content.make_pool(mix, enc, 5, "cpu")
    g_n, n_b = mix["gop_batch"], mix["pool_batches"]
    lead = (n_b, 3, g_n) if g_n > 1 else (n_b, 3)
    assert pool[0].shape == (*lead, 64, 96)        # 56 rows pad to 64
    assert pool[1].shape == pool[2].shape == (*lead, 32, 48)
    gops = [content.pool_gop(pool, b, g)[0] for b in range(n_b)
            for g in range(g_n)]
    assert len(gops) == n_b * g_n
    for i, a in enumerate(gops):
        for b in gops[i + 1:]:
            assert not torch.equal(a, b)


def test_padding_replicates_the_last_row_and_column():
    mix, enc = _mix_enc("pan2.g1", w=90, h=50)
    y, cb, _ = content.make_pool(mix, enc, 3, "cpu")
    assert y.shape[-2:] == (64, 96) and cb.shape[-2:] == (32, 48)
    g = y[0, 0]
    assert torch.equal(g[50:], g[49:50].expand(14, -1))
    assert torch.equal(g[:, 90:], g[:, 89:90].expand(-1, 6))
    c = cb[0, 0]
    assert torch.equal(c[25:], c[24:25].expand(7, -1))


def test_recipe_matches_chip_smoke_statistics():
    """The two-pass texture pans (+2, +3) px a frame: frame k's luma away
    from the patch and the noise is the base texture shifted by (2k, 3k)."""
    mix, enc = _mix_enc("pan2.g1", w=160, h=128, t=3)
    mix = dict(mix, noise=0, patch=0)
    y = content.make_pool(mix, enc, 9, "cpu")[0][0].long()
    assert torch.equal(y[1, :-2, :-3], y[0, 2:, 3:])
    assert torch.equal(y[2, :-4, :-6], y[0, 4:, 6:])
    assert 60 < float(y.float().mean()) < 200
    cb = content.make_pool(mix, enc, 9, "cpu")[1][0]
    assert [int(cb[k, 0, 0]) for k in range(3)] == [108, 109, 110]


def test_gop_seed_takes_large_seeds():
    seeds = {content.gop_seed(s, i) for s in (0, 2**31 + 7, 2**33 + 1)
             for i in range(8)}
    assert len(seeds) == 24
    assert all(0 <= s < 2**63 for s in seeds)
    assert np.all(np.array(sorted(seeds)) >= 0)
