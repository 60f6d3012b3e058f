"""The arithmetic of the Hopper designs of code_plane (csrc/code_plane.cu)
and block_pack (csrc/block_pack.cu), modelled in plain torch and numpy on
the CPU and held against the port's plain versions, which the other test
files tie to the JAX reference, and here also against the reference's
quotient and its Pallas block_pack in interpret mode. The kernels
themselves run only on the card (tests/test_torch_kernels.py).
Tolerance 0: the codec is integer-only.

The models follow the kernels step by step: the even/odd 8-point passes
with every partial sum checked against int32, the reciprocal-and-fix-up
quotient in f32, the arithmetic zigzag position and quant matrix, the row
scan's per-block-column chains, and block_pack's warp placement (two
ballot words, the previous set bit, a packed exclusive scan of the pair
lengths, symbols ORed into the block's words, truncation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_encoder_tpu.ops.pallas import codec as jcodec
from video_encoder_tpu.ops.pallas import entropy_pack as ep
from video_encoder_tpu_torch.codec import entropy, spec
from video_encoder_tpu_torch.ops import transform
from video_encoder_tpu_torch.ops.kernels import entropy_pack as kpack

torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
# the reachable |level| at q = 1 (SPEC.md §4) bounds |coef| in the tests
COEF_MAX = 3925


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# ---- code_plane -------------------------------------------------------------

class _Sums:
    """Adds terms one at a time in int64, checking every partial sum
    against int32, as the kernel's int32 sums would overflow."""

    def __init__(self):
        self.largest = 0

    def add(self, *terms):
        acc = torch.zeros_like(terms[0])
        for t in terms:
            acc = acc + t
            self.largest = max(self.largest, int(acc.abs().max()))
        assert self.largest <= INT32_MAX
        return acc


def _odd4(s, a, b, c, d):
    return (s.add(502 * a, 426 * b, 284 * c, 100 * d),
            s.add(426 * a, -100 * b, -502 * c, -284 * d),
            s.add(284 * a, -502 * b, 100 * c, 426 * d),
            s.add(100 * a, -284 * b, 426 * c, -502 * d))


def _fwd8(s, x):
    """y[k] = sum_j B[k][j] x[j] over the last axis, as fwd8 computes it."""
    x = [x[..., k] for k in range(8)]
    s0, s1, s2, s3 = (s.add(x[j], x[7 - j]) for j in range(4))
    d = [s.add(x[j], -x[7 - j]) for j in range(4)]
    ss0, ss1, sd0, sd1 = s.add(s0, s3), s.add(s1, s2), s.add(s0, -s3), s.add(s1, -s2)
    y = [None] * 8
    y[0] = 362 * s.add(ss0, ss1)
    y[4] = 362 * s.add(ss0, -ss1)
    y[2] = s.add(473 * sd0, 196 * sd1)
    y[6] = s.add(196 * sd0, -473 * sd1)
    y[1], y[3], y[5], y[7] = _odd4(s, *d)
    return torch.stack(y, -1)


def _inv8(s, x):
    """y[i] = sum_j B[j][i] x[j] over the last axis, as inv8 computes it."""
    x = [x[..., k] for k in range(8)]
    a, b = 362 * s.add(x[0], x[4]), 362 * s.add(x[0], -x[4])
    c, d = s.add(473 * x[2], 196 * x[6]), s.add(196 * x[2], -473 * x[6])
    e = [s.add(a, c), s.add(b, d), s.add(b, -d), s.add(a, -c)]
    o = _odd4(s, x[1], x[3], x[5], x[7])
    y = [None] * 8
    for i in range(4):
        y[i] = s.add(e[i], o[i])
        y[7 - i] = s.add(e[i], -o[i])
    return torch.stack(y, -1)


def _round(v):
    return transform.rshift_round(v, spec.TX_SHIFT)


def _cols(fn, s, blocks):
    """fn on every column of [..., 8, 8] blocks (a thread's column after
    a transpose), rounded, back in row-major layout."""
    return _round(fn(s, blocks.transpose(-1, -2))).transpose(-1, -2)


def _zz_pos(r, c):
    """The kernel's zz_pos: the zigzag scan position of raster (r, c)."""
    s = r + c
    lo = s < 8
    rr, cc, ss = (r, c, s) if lo else (7 - r, 7 - c, 14 - s)
    p = ss * (ss + 1) // 2 + (rr if ss & 1 else cc)
    return p if lo else 63 - p


def _qmat(r, c):
    """The kernel's quant matrix: 16 + 2 (r + c) sixteenths."""
    return 16 + 2 * (r + c)


def _quotient(n, d, ulps=0):
    """The kernel's quant_mag: m = trunc(fl(n * rd)) in f32, rd the f32
    reciprocal of d rounded to nearest (numpy's f32 division and product
    round to nearest, as __frcp_rn and __fmul_rn do) and moved by `ulps`
    units in the last place, then one fix-up step each way. Returns (m, m
    before the fix-up)."""
    rd = np.float32(1.0) / d.astype(np.float32)
    for _ in range(abs(ulps)):
        rd = np.nextafter(rd, np.float32(np.inf if ulps > 0 else 0))
    m0 = (n.astype(np.float32) * rd).astype(np.int32)   # truncation
    m = m0 + ((m0 + 1) * d <= n)
    m = m - (m * d > n)
    return m, m0


def _q_pos(q, qmat):
    """Per-position steps [..., 8, 8] from per-block steps, the kernel's
    way; q int64."""
    if not qmat:
        return q[..., None, None].expand(*q.shape, 8, 8)
    qm = torch.tensor([[_qmat(r, c) for c in range(8)] for r in range(8)])
    return ((q[..., None, None] * qm + 8) >> 4).clamp(min=1)


def _code_blocks(cur, pred, q, qbias, qmat, sums):
    """code_block of blocks [..., 8, 8] (int64) at steps q [...]: (levels
    [..., 64] zigzag order, clipped recon [..., 8, 8])."""
    t1r = _cols(_fwd8, sums, cur - pred)
    coef = _round(_fwd8(sums, t1r))
    qk = _q_pos(q, qmat)
    bias = torch.full((8, 8), qbias, dtype=torch.int64)
    bias[0, 0] = 8
    n = (16 * coef.abs() + bias * qk).numpy()
    mag, _ = _quotient(n, (16 * qk).numpy())
    level = torch.where(coef < 0, -torch.from_numpy(mag).long(),
                        torch.from_numpy(mag).long())
    zz = torch.tensor([_zz_pos(r, c) for r in range(8) for c in range(8)])
    lz = torch.empty(*level.shape[:-2], 64, dtype=torch.int64)
    lz[..., zz] = level.reshape(*level.shape[:-2], 64)
    u1r = _cols(_inv8, sums, level * qk)
    rec = (_round(_inv8(sums, u1r)) + pred).clamp(0, 255)
    return lz, rec


def _code_plane_model(cur, pred, q_blk, qbias, qmat, sums):
    lz, rec = _code_blocks(transform.blockify(cur.long(), 8),
                           transform.blockify(pred.long(), 8), q_blk.long(),
                           qbias, qmat, sums)
    return lz.int(), transform.unblockify(rec).int()


def test_zigzag_position_and_quant_matrix_are_the_tables():
    assert [_zz_pos(r, c) for r in range(8) for c in range(8)] == \
        spec.UNZIGZAG.tolist()
    assert np.array_equal([[_qmat(r, c) for c in range(8)] for r in range(8)],
                          spec.QMAT)


@pytest.mark.parametrize("qbias", range(1, 9))
def test_quotient_exhaustive(qbias):
    """floor((16|c| + bias q) / (16 q)) for every |c| in 0..3925, every
    step of QSTEP, flat and at every quant-matrix position (with bias 8 at
    DC and qbias at the ACs), against integer floor division and the
    reference's _exact_div."""
    q = spec.QSTEP.astype(np.int64)
    qm = np.maximum(1, (q[:, None] * spec.QMAT.reshape(-1)[None] + 8) >> 4)
    qs = np.unique(np.concatenate([q, qm.reshape(-1)]))
    assert qs.max() * 16 == 63712
    c = np.arange(COEF_MAX + 1, dtype=np.int64)
    n = 16 * c[None, :] + qbias * qs[:, None]
    d = np.broadcast_to(16 * qs[:, None], n.shape)
    for ulps in (-2, -1, 0, 1, 2):   # any reciprocal within 2 ulp of 1 / d
        m, m0 = _quotient(n.astype(np.int32), d.astype(np.int32), ulps)
        assert np.array_equal(m, n // d)
        assert np.abs(m0 - n // d).max() <= 1    # the fix-up is one step
        if qbias == 8 and ulps <= 0:             # the truncation alone is short
            assert (m0 < n // d).any()
    ref = np.asarray(jcodec._exact_div(jnp.asarray(n, jnp.int32),
                                       jnp.asarray(d, jnp.int32)))
    assert np.array_equal(m, ref)


@pytest.mark.parametrize("extreme", [False, True])
def test_even_odd_transform(rng, extreme):
    """fwd8/inv8 as the kernel passes them (columns, round, rows, round)
    against transform.forward_transform and inverse_transform; the ±255
    residuals and the largest dequantized values keep every partial sum
    within int32."""
    if extreme:
        x = rng.choice([-255, 255], (256, 8, 8))
        x[0], x[1] = 255, -255
        deq = rng.choice([-4031, 4031], (256, 8, 8))
    else:
        x = rng.integers(-255, 256, (256, 8, 8))
        deq = rng.integers(-4031, 4032, (256, 8, 8))
    sums = _Sums()
    x_t, deq_t = torch.from_numpy(x), torch.from_numpy(deq)
    fwd = _round(_fwd8(sums, _cols(_fwd8, sums, x_t)))
    assert torch.equal(fwd, transform.forward_transform(_t(x)).long())
    inv = _round(_inv8(sums, _cols(_inv8, sums, deq_t)))
    assert torch.equal(inv, transform.inverse_transform(_t(deq)).long())
    assert sums.largest < 2**26


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("qbias", [8, 5])
def test_code_plane_model(rng, qbias, qmat):
    """The whole block, as code_block computes it, against the plain
    code_plane: qp 1, 28 and 63 mixed per block; flat-128 blocks; the
    largest residuals."""
    h, w = 48, 64
    cur = rng.integers(0, 256, (h, w))
    pred = np.clip(cur + rng.integers(-60, 61, (h, w)), 0, 255)
    pred[:8, :8] = 128
    cur[8:16, :8], pred[8:16, :8] = 255, 0
    cur[8:16, 8:16], pred[8:16, 8:16] = 0, 255
    qp = rng.choice([1, 28, 63], (h // 8, w // 8))
    q_blk = _t(spec.QSTEP[qp])
    sums = _Sums()
    got = _code_plane_model(_t(cur), _t(pred), q_blk, qbias, qmat, sums)
    want = transform.code_plane(_t(cur), _t(pred), q_blk, qbias, qmat)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _rows_model(cur, q_blk, qbias, reset_rows, qmat):
    """The row scan as rows_kernel walks it: every (plane, block column)
    chain steps down its block rows, its pred row the recon's last pixel
    row of the block above (128 at a slice's first row)."""
    *lead, h, w = cur.shape
    blocks = transform.blockify(cur.long(), 8)         # [.., nby, nbx, 8, 8]
    q = q_blk.long()
    sums = _Sums()
    lzs, recs = [], []
    carry = torch.full((*lead, w // 8, 1, 8), 128, dtype=torch.int64)
    for j in range(h // 8):
        if j == 0 or (reset_rows and j % reset_rows == 0):
            carry = torch.full_like(carry, 128)
        lz, rec = _code_blocks(blocks[..., j, :, :, :], carry.expand_as(
            blocks[..., j, :, :, :]), q[..., j, :], qbias, qmat, sums)
        carry = rec[..., 7:, :]
        lzs.append(lz)
        recs.append(rec)
    return (torch.stack(lzs, -3).int(),
            transform.unblockify(torch.stack(recs, -4)).int())


@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("g", [None, 3])
@pytest.mark.parametrize("reset_rows", [0, 2, 17])
def test_row_scan_chains(rng, reset_rows, g, qmat):
    """Per-block-column chains against transform.intra_rows_code_plane on
    the odd 368x640 grid (46 block rows), one plane or a G axis."""
    lead = () if g is None else (g,)
    h, w = 368, 640
    base = rng.integers(0, 256, (*lead, h + 1, w))
    cur = (base[..., :h, :] + base[..., 1:, :]) // 2
    qp = rng.choice([1, 12, 28, 63], (*lead, h // 8, w // 8))
    q_blk = _t(spec.QSTEP[qp])
    got = _rows_model(_t(cur), q_blk, 6, reset_rows, qmat)
    want = transform.intra_rows_code_plane(_t(cur), q_blk, 6, reset_rows, qmat)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- block_pack ---------------------------------------------------------------

def _ue_len(v):
    """2 bitlength(v + 1) - 1, as ue_len takes it from __clz."""
    return 2 * (((v + 1)[..., None] >> torch.arange(32)) > 0).sum(-1) - 1


def _se_ue(v):
    return torch.where(v > 0, 2 * v - 1, -2 * v)


def _pack_model(levels, n_words, dc_pred, fmt):
    """block_pack_kernel's placement for blocks [n, 64]: (words [n,
    n_words] int64, bits [n] int32): each pair code ORed into a string
    that starts as the header."""
    v2 = fmt >= 2
    lv = levels.long()
    n = lv.shape[0]
    pos = torch.arange(64)
    # lane l holds positions l and l + 32; the two ballots are the mask
    nz = lv != 0
    if v2:
        nz[:, 0] = False
    nnz = nz.sum(1)
    dc = lv[:, 0]
    cbf = (nnz > 0) | (v2 & (dc != 0))
    # the header, one code left-aligned in 64 bits
    if v2:
        dv = _se_ue(dc - dc_pred.long())
        l1, l2 = _ue_len(dv), _ue_len(nnz)
        head = (cbf.long() << 63) | ((dv + 1) << (63 - l1)) | ((nnz + 1) << (63 - l1 - l2))
        hdr = 1 + l1 + l2
    else:
        l1 = _ue_len((nnz - 1).clamp(min=0))
        head = (cbf.long() << 63) | (nnz << (63 - l1))
        hdr = 1 + l1
    head, hdr = torch.where(cbf, head, cbf.long() << 63), torch.where(cbf, hdr, 1)
    # each nonzero position's pair code, ue(run) then se(level); the run
    # counts from the mask's previous set bit (-1, or 0 in format 2)
    first = 0 if v2 else -1
    seen = torch.where(nz, pos, first).cummax(1).values
    prev = torch.cat([torch.full((n, 1), first), seen[:, :-1]], 1)
    run, lu = pos - prev - 1, _se_ue(lv)
    ll = _ue_len(lu)
    length = torch.where(nz, _ue_len(run) + ll, 0)
    code = ((run + 1) << ll) | (lu + 1)
    # the warp's exclusive scan, both halves packed in one 32-bit word
    packed = length[:, :32] | (length[:, 32:] << 16)
    incl = packed.cumsum(1)
    excl = incl - packed
    tot = incl[:, 31:]
    off = torch.cat([hdr[:, None] + (excl & 0xffff),
                     hdr[:, None] + (tot & 0xffff) + (excl >> 16)], 1)
    bits = hdr + (tot[:, 0] & 0xffff) + (tot[:, 0] >> 16)
    assert int(length.max()) <= 38 and int(hdr.max()) <= 41
    # the shared string: the header, then each code into at most 3 words
    # (the codes hold disjoint bits, so adding is ORing)
    buf = torch.zeros(n, n_words + 3, dtype=torch.long)
    buf[:, 0] = (head >> 32) & 0xffffffff
    if n_words > 1:
        buf[:, 1] = head & 0xffffffff
    wi, sh = off >> 5, off & 31
    top = code << (64 - length).clamp(0, 63)      # left-aligned (int64 bits)
    pieces = [((top >> 32) & 0xffffffff) >> sh,                  # word wi
              ((top << (32 - sh)) >> 32) & 0xffffffff,          # word wi + 1
              (top << (32 - sh)) & 0xffffffff]                  # word wi + 2
    end = sh + length
    for k, piece in enumerate(pieces):
        keep = nz & (end > 32 * k) & (wi + k < n_words)
        buf.scatter_add_(1, torch.where(keep, wi + k, n_words + 2),
                         torch.where(keep, piece, 0))
    return buf[:, :n_words], bits.int()


def _pack_cases(rng):
    """[n, 64] levels and [n] DC predictors: sparse random blocks,
    all-zero blocks, 64 nonzeros at |level| = 3925, DC-only blocks, and
    dc - dc_pred = +-7850."""
    lv = np.zeros((48, 64), np.int64)
    mask = rng.random(lv.shape) < 0.15
    lv[mask] = rng.integers(-300, 301, mask.sum())
    lv[0:4] = 0
    lv[4:12] = rng.choice([-3925, 3925], (8, 64))
    lv[12:14, 1:] = 0
    lv[12, 0], lv[13, 0] = 3925, -3925
    lv[14, 63] = 1
    dcp = rng.integers(-40, 41, 48)
    dcp[12], dcp[13] = -3925, 3925           # dc - dc_pred = +7850, -7850
    return lv, dcp


@pytest.mark.parametrize("n_words", [1, 2, 16, entropy.BLOCK_WORDS_MAX])
@pytest.mark.parametrize("fmt", [1, 2])
def test_block_pack_placement_model(rng, fmt, n_words):
    """The warp placement against the plain pack (block symbols, then
    entropy.pack_dense) and the reference's Pallas block_pack in
    interpret mode: overflow at 1, 2 and 16 words, exact at
    BLOCK_WORDS_MAX."""
    lv, dcp = _pack_cases(rng)
    dc_pred = _t(dcp) if fmt >= 2 else None
    want = kpack.plain_block_pack(_t(lv), n_words, dc_pred, fmt)
    got = _pack_model(_t(lv), n_words, _t(dcp), fmt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    overflow = got[1] > 32 * n_words
    assert bool(overflow[4:12].all()) == (n_words < entropy.BLOCK_WORDS_MAX)
    assert not bool(overflow.any()) or n_words < entropy.BLOCK_WORDS_MAX
    if fmt >= 2:                      # se(+-7850): 1 + 27 + ue(0) bits
        assert got[1][12:14].tolist() == [29, 29]
    assert got[1][0:4].tolist() == [1, 1, 1, 1]
    pw, pb = ep._block_pack_impl(jnp.asarray(lv, jnp.int32),
                                 jnp.asarray(dcp if fmt >= 2 else 0 * dcp,
                                             jnp.int32)[:, None],
                                 fmt, n_words, interpret=True)
    assert np.array_equal(got[1].numpy(), np.asarray(pb))
    assert np.array_equal(got[0].numpy(), np.asarray(pw).astype(np.int64))
