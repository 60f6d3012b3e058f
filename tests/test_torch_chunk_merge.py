"""The port's chunk_merge (codec/pack.py, the plain version of
csrc/span_merge.cu tvc_chunk_merge) vs the reference's Pallas chunk_merge
in TPU interpret mode and entropy.tree_concat, and pick_chunk_k. No encode
path calls it, here or in the reference. Tolerance 0: the strings are
compared word for word (every piece is zero past its bit count, so the
merged strings are too), and the bit counts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_encoder_tpu.codec import entropy as jent
from video_encoder_tpu.ops.pallas import pack as ppack
from video_encoder_tpu_torch.codec import pack
from video_encoder_tpu_torch.ops import dispatch

torch.set_num_threads(1)


def _strings(rng, n, w, bits):
    """Valid MSB-first strings [n, w] uint32 with the given bit counts
    (words past each count zero)."""
    words = np.zeros((n, w), np.uint32)
    for i, b in enumerate(bits):
        nw = (int(b) + 31) // 32
        vals = rng.integers(0, 2**32, nw, dtype=np.uint64).astype(np.uint32)
        if nw and b & 31:
            vals[-1] &= np.uint32(0xFFFFFFFF) << np.uint32(32 - (b & 31))
        words[i, :nw] = vals
    return words


def _t32(a):
    """uint32 words as the port carries them: int32 of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_chunk_merge_matches_pallas_kernel(rng):
    n, w, k = 256, 8, 32
    bits = rng.integers(0, 32 * w + 1, n).astype(np.int32)
    bits[::9] = 0
    bits[5] = 32 * w                                   # a full piece
    words = _strings(rng, n, w, bits)
    with pltpu.force_tpu_interpret_mode():
        want_w, want_b = ppack.chunk_merge(jnp.asarray(words), jnp.asarray(bits), k)
        # the vmap rule folds a batch axis into the chunk grid
        bw, bb = jax.vmap(lambda a, b: ppack.chunk_merge(a, b, k))(
            jnp.asarray(words.reshape(2, n // 2, w)),
            jnp.asarray(bits.reshape(2, n // 2)))
    for fn in (pack.chunk_merge, dispatch.chunk_merge):
        got_w, got_b = fn(_t32(words), torch.from_numpy(bits), k)
        assert got_w.dtype == torch.int32 and got_b.dtype == torch.int32
        assert got_w.shape == (2 * n // k, (k // 2) * w + 1)
        assert np.array_equal(got_w.numpy().view(np.uint32), np.asarray(want_w))
        assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    h = k // 2       # each half-chunk string is tree_concat of its pieces
    tw, tb = jax.jit(jax.vmap(
        lambda a, b: jent.tree_concat(a, b, got_w.shape[1])))(
        jnp.asarray(words.reshape(-1, h, w)), jnp.asarray(bits.reshape(-1, h)))
    assert np.array_equal(got_b.numpy(), np.asarray(tb))
    assert np.array_equal(got_w.numpy().view(np.uint32), np.asarray(tw))
    gw, gb = pack.chunk_merge(_t32(words.reshape(2, n // 2, w)),
                              torch.from_numpy(bits.reshape(2, n // 2)), k)
    assert gw.shape == (2, n // k, h * w + 1)
    assert np.array_equal(gw.numpy().view(np.uint32), np.asarray(bw))
    assert np.array_equal(gb.numpy(), np.asarray(bb))
    assert torch.equal(gw.reshape(-1, h * w + 1), got_w)


@pytest.mark.parametrize("n,w", [(65536, 24), (65536, 16), (4096, 78),
                                 (100, 8), (40, 4096), (3, 8), (1, 1)])
def test_pick_chunk_k_is_the_reference(n, w):
    assert pack.pick_chunk_k(n, w) == ppack.pick_chunk_k(n, w)
