"""The arithmetic of the Hopper designs of code_plane (csrc/code_plane.cu,
with the decoders' recon entries),
block_pack (csrc/block_pack.cu), the SAD maps and the SEA search
(csrc/full_search.cu), sad_at_mv (csrc/sad_at.cu) and the span and chunk
merges (csrc/span_merge.cu), modelled in plain torch and numpy on the CPU
and held against the port's plain versions, which the other test files tie
to the JAX reference, and here also against the reference's quotient and
its Pallas block_pack, sad_map, sad_map_even, sad_at_mv and SEA search in
interpret mode. The kernels themselves run only on the card
(tests/test_torch_kernels.py). Tolerance 0: the codec is integer-only.

The models follow the kernels step by step: the even/odd 8-point passes
with every partial sum checked against int32, the reciprocal-and-fix-up
quotient in f32, the arithmetic zigzag position and quant matrix, the row
scan's per-block-column chains, the decoders' recon in unsigned
arithmetic (deq read by columns from the zigzag stage, every sum mod
2^32, the rounding shift on the wrapped value), and block_pack's warp
placement (two
ballot words, the previous set bit, a packed exclusive scan of the pair
lengths, symbols ORed into the block's words, truncation); the maps'
thread-to-candidate mapping (groups of lanes, runs of candidates, window
strips, the even map's words of four pixels and their vabsdiff4, the
xor-shuffle sums, the shared row's stores); sad_at_mv's warp
per block for all K candidates (the lanes' pixels, the coordinate clamp in
the reference's own extents, the xor-shuffle sums, each plane's union of
footprints); the SEA search's batches (the sliding column sums, each
row's smallest bound from a lane pair, the first batch in the centre-out
order, the later rows compacted by their bound against its best, the
replayed row count, the runs of 11 candidates on words of four 8-bit
samples, byte-shifted and summed by vabsdiff4); the merges' placement (a
block per string, each task's words of a piece read before the scan and
only up to its used words, funnel shifts of neighbouring words, words
inside a piece stored and boundary words ored) and the zero-past-bits
property it relies on.
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


# ---- the decoders' recon: recon_kernel and recon_rows_kernel ----------------

def _u32(x):
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def _inv8_wrap(x):
    """inv8 on uint32 columns (the last axis), every product and sum mod
    2^32 as the kernel's unsigned arithmetic computes it."""
    x = [x[..., k] for k in range(8)]
    a, b = 362 * (x[0] + x[4]), 362 * (x[0] - x[4])
    c, d = 473 * x[2] + 196 * x[6], 196 * x[2] - 473 * x[6]
    e = [a + c, b + d, b - d, a - c]
    o = [502 * x[1] + 426 * x[3] + 284 * x[5] + 100 * x[7],
         426 * x[1] - 100 * x[3] - 502 * x[5] - 284 * x[7],
         284 * x[1] - 502 * x[3] + 100 * x[5] + 426 * x[7],
         100 * x[1] - 284 * x[3] + 426 * x[5] - 502 * x[7]]
    y = [None] * 8
    for i in range(4):
        y[i] = e[i] + o[i]
        y[7 - i] = e[i] - o[i]
    return np.stack(y, -1)


def _round_wrap(v):
    """rshift_round_wrap: |v| and |v| + 512 mod 2^32, the shift arithmetic
    on the value read as int32."""
    neg = v.view(np.int32) < 0
    mag = (np.where(neg, np.uint32(0) - v, v) + np.uint32(512)).view(
        np.int32) >> 10
    return np.where(neg, -mag, mag).astype(np.int32)


def _recon_blocks_model(lv, pred, q, qmat):
    """recon_block on blocks [..., 64] zigzag int16 levels, pred [..., 8,
    8], steps [...]: thread r's column r of deq read from the zigzag
    stage (deq[k][r] = z[zz_pos(k, r)] * q(k, r)), inv8, round, one
    transpose, inv8, round, + pred, clip."""
    zz = np.array([[_zz_pos(k, r) for r in range(8)] for k in range(8)])
    qk = np.asarray(q, np.int64)[..., None, None]
    if qmat:
        m = np.array([[_qmat(k, r) for r in range(8)] for k in range(8)])
        qk = np.maximum(1, (qk * m + 8) >> 4)
    deq = _u32(lv[..., zz]) * _u32(np.broadcast_to(qk, lv.shape[:-1] + (8, 8)))
    cols = deq.swapaxes(-1, -2)                  # thread r holds column r
    u1r = _round_wrap(_inv8_wrap(cols))          # u1[.][r], rounded
    rows = _u32(u1r.swapaxes(-1, -2))            # the transpose: row r
    u2 = _round_wrap(_inv8_wrap(rows))
    rec = (_u32(u2) + _u32(pred)).view(np.int32)
    return np.clip(rec, 0, 255)


def _recon_case(rng, h, w, extreme):
    shape = (h // 8, w // 8, 64)
    if extreme:
        lv = rng.choice([-32768, -32767, 32767, 0], shape)
        qp = np.full(shape[:-1], 63)
    else:
        lv = np.where(rng.random(shape) < 0.8, 0, rng.integers(-60, 61, shape))
        qp = rng.choice([1, 12, 28, 63], shape[:-1])
    return lv.astype(np.int16), spec.QSTEP[qp].astype(np.int32)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("qmat", [False, True])
def test_recon_block_model(rng, qmat, extreme):
    """The inter recon's unsigned arithmetic against transform.recon_plane
    (the reference's int32 wrap) on the odd 184x320 chroma grid, also at
    the int16 extremes and the largest step, where its sums leave int32."""
    h, w = 184, 320
    lv, q = _recon_case(rng, h, w, extreme)
    pred = rng.integers(0, 256, (h, w)).astype(np.int32)
    blocks = transform.blockify(_t(pred), 8).numpy()
    got = transform.unblockify(torch.from_numpy(
        _recon_blocks_model(lv, blocks, q, qmat))).numpy()
    want = transform.recon_plane(torch.from_numpy(lv), _t(pred), _t(q), qmat)
    assert np.array_equal(got, want.numpy())
    if extreme:                  # the wrap was exercised
        deq = lv.astype(np.int64) * q[..., None]
        assert np.abs(deq).max() * 2705 > INT32_MAX


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("qmat", [False, True])
@pytest.mark.parametrize("reset_rows", [0, 2, 17])
def test_recon_rows_chains(rng, reset_rows, qmat, extreme):
    """The I-frame recon as recon_rows_kernel walks it (per block column,
    each block's pred row the recon's last row above, 128 at a slice's
    first row) against transform.intra_rows_recon_plane on 368x640."""
    h, w = 368, 640
    lv, q = _recon_case(rng, h, w, extreme)
    carry = np.full((w // 8, 1, 8), 128, np.int32)
    rows = []
    for j in range(h // 8):
        if j == 0 or (reset_rows and j % reset_rows == 0):
            carry = np.full_like(carry, 128)
        rec = _recon_blocks_model(lv[j], np.broadcast_to(carry, (w // 8, 8, 8)),
                                  q[j], qmat)
        carry = rec[:, 7:, :]
        rows.append(rec)
    got = transform.unblockify(torch.from_numpy(np.stack(rows))).numpy()
    want = transform.intra_rows_recon_plane(torch.from_numpy(lv), _t(q),
                                            reset_rows, qmat)
    assert np.array_equal(got, want.numpy())


# ---- block_pack ---------------------------------------------------------------

def _ue_len(v):
    """2 bitlength(v + 1) - 1, as ue_len takes it from __clz."""
    return 2 * (((v + 1)[..., None] >> torch.arange(32)) > 0).sum(-1) - 1


def _se_ue(v):
    return torch.where(v > 0, 2 * v - 1, -2 * v)


def _pack_model(levels, n_words, dc_pred, fmt):
    """block_pack_kernel's placement for blocks [n, 64]: (words [n,
    n_words] int32, bits [n] int32): each pair code ORed into a string
    that starts as the header, built in int64 and stored as 32-bit
    words."""
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
    return buf[:, :n_words].to(torch.int32), bits.int()


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
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(pw))


# ---- the SAD maps: tiled_kernel and even_map_kernel in csrc/full_search.cu --

# (ROWS, RUN, NT) of the whole map (the search's tiling) and the even map
_MAP_TILING = {1: (4, 11, 128), 2: (2, 9, 288)}


def _pack4(x):
    """Words of four 8-bit samples along the last axis, the first in the
    low byte (as the kernel packs them)."""
    x = x.astype(np.int64).reshape(*x.shape[:-1], -1, 4)
    return x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16) | (x[..., 3] << 24)


def _vsad4(a, b):
    """vabsdiff4 without its add: the sum of the four bytes' |a - b|."""
    return sum(np.abs(((a >> (8 * e)) & 255) - ((b >> (8 * e)) & 255))
               for e in range(4))


def _map_model(cur, ref, stride):
    """tiled_kernel<true> (stride 1) or even_map_kernel (stride 2) on planes
    [h, w] of 8-bit samples (numpy): the map [nby, nbx, nds * nds], and how
    many runs computed each candidate. Lane by lane as the kernels assign
    them: warp w takes the groups (NT / TPG) i + (32 / TPG) w + lane / TPG,
    a group's TPG lanes hold ROWS block rows each, a lane loads one strip
    of the window per block row (stride 2: eight words of four pixels, and
    the words shifted by two pixels for the odd candidates, four vabsdiff4
    per candidate row), the group's partial sums meet in xor shuffles, and
    lane q of a group stores the candidates j with j % TPG == q."""
    rows, run, nt = _MAP_TILING[stride]
    h, w = cur.shape
    nby, nbx = h // 16, w // 16
    nds = -(-33 // stride)
    tpg, runs = 16 // rows, -(-nds // run)
    groups, strip = nds * runs, 16 + stride * (run - 1)
    pad = np.pad(ref.astype(np.int64), 16, mode="edge")   # the clamped window
    win = np.stack([np.stack([pad[16 * y:16 * y + 48, 16 * x:16 * x + 48]
                              for x in range(nbx)]) for y in range(nby)])
    blk = cur.astype(np.int64).reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3)
    if stride == 2:
        win, blk = _pack4(win), _pack4(blk)          # [.., 48, 12], [.., 16, 4]
    row = np.full((nby, nbx, nds * nds), -1, np.int64)
    covered = np.zeros(nds * nds, np.int64)
    for warp in range(nt // 32):
        for g0 in range((32 // tpg) * warp, groups, nt // tpg):
            part = np.zeros((32, run, nby, nbx), np.int64)
            meta = []
            for lane in range(32):
                valid = g0 + lane // tpg < groups
                grp = g0 + lane // tpg if valid else groups - 1
                ky = grp // runs
                kx0 = min((grp - ky * runs) * run, nds - run)
                r0 = rows * (lane % tpg)
                assert 0 <= stride * kx0 and stride * kx0 + strip <= 48
                for r in range(rows):
                    assert stride * ky + r0 + r < 48
                    if stride == 1:
                        s = win[:, :, ky + r0 + r, kx0:kx0 + strip]
                        for j in range(run):
                            part[lane, j] += np.abs(
                                blk[:, :, r0 + r] - s[..., j:j + 16]).sum(-1)
                        continue
                    assert kx0 % 2 == 0          # the strip starts on a word
                    a = win[:, :, 2 * ky + r0 + r, kx0 // 2:kx0 // 2 + 8]
                    sh = (a[..., :7] >> 16) | ((a[..., 1:] & 0xffff) << 16)
                    for j in range(run):
                        words = sh if j % 2 else a
                        for m in range(4):
                            part[lane, j] += _vsad4(blk[:, :, r0 + r, m],
                                                    words[..., j // 2 + m])
                meta.append((valid, ky, kx0))
                if valid and lane % tpg == 0:
                    covered[ky * nds + kx0:ky * nds + kx0 + run] += 1
            off = 1
            while off < tpg:                      # __shfl_xor_sync, all lanes
                part = part + part[np.arange(32) ^ off]
                off *= 2
            for lane, (valid, ky, kx0) in enumerate(meta):
                for j in range(run):
                    if valid and lane % tpg == j % tpg:
                        k = ky * nds + kx0 + j
                        assert (row[..., k] < 0).all() or (row[..., k] == part[lane, j]).all()
                        row[..., k] = part[lane, j]
    assert (row >= 0).all()
    return row, covered


def _map_pairs(rng, h, w):
    """Two plane pairs [2, h, w]: MB (0, 0) and its window flat (all
    candidates tie), the rest a smooth texture matched exactly at (+16,
    -16); and a pan with noise."""
    base = rng.integers(0, 256, (h + 64, w + 64))
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    cur0, ref0 = base[32:32 + h, 32:32 + w].copy(), base[16:16 + h, 48:48 + w].copy()
    cur0[:16, :16] = 100
    ref0[:32, :32] = 100
    cur1 = base[20:20 + h, 20:20 + w]
    ref1 = np.clip(base[17:17 + h, 24:24 + w] + rng.integers(-2, 3, (h, w)), 0, 255)
    return np.stack([cur0, cur1]).astype(np.int32), np.stack([ref0, ref1]).astype(np.int32)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w", [(48, 80), (80, 48)])
def test_map_tiling_model(rng, stride, h, w):
    """Every candidate computed by one run (at stride 2 candidate 8 of a
    dy row by both runs, with one value), every strip inside the window
    row; the model's map equals the plain map and the reference's Pallas
    map in interpret mode, with the all-tied MB and the corner MBs."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from video_encoder_tpu.ops.pallas import sad as psad
    from video_encoder_tpu_torch.ops import motion

    cur, ref = _map_pairs(rng, h, w)
    nds = -(-33 // stride)
    plain = (motion.sad_map if stride == 1 else motion.sad_map_even)(_t(cur), _t(ref))
    with pltpu.force_tpu_interpret_mode():
        pallas = jax.vmap(psad.sad_map if stride == 1 else psad.sad_map_even)(
            jnp.asarray(cur), jnp.asarray(ref))
    for g in range(2):
        got, covered = _map_model(cur[g], ref[g], stride)
        assert np.array_equal(got, plain[g].numpy())
        assert np.array_equal(got, np.asarray(pallas[g]))
        twice = np.zeros((nds, nds), np.int64)
        if stride == 2:
            twice[:, 8] = 1
        assert np.array_equal(covered, 1 + twice.reshape(-1))
    assert (plain[0, 0, 0] == plain[0, 0, 0, 0]).all()            # all tied
    corner = 16 * 17 if stride == 2 else 32 * 33                  # (16, -16)
    assert (plain[0].argmin(-1)[1:-1, 1:-1] == corner).all()


# ---- sad_at_mv: sad_at_kernel in csrc/sad_at.cu -----------------------------

def _sad_at_model(cur, ref, dy, dx, bs, plane_of=None, stats=None):
    """sad_at_kernel<BS> on cur [h, w] against reference planes [P, rh, rw]
    (cur's origin at ((rh - h) / 2, (rw - w) / 2)) at vectors [K, nby, nbx]
    (numpy): one warp per block for all K candidates. Lane l holds the
    bs * bs / 32 pixels of cur in column l % bs, rows l / bs + (32 / bs) i;
    the candidates go 32 at a time, lane j holding candidate j's vector
    and plane (candidates past the 16th read plane 0); each candidate's
    pixels are read through the reference's coordinate clamp, each lane's
    abs-diffs summed, then the lanes' sums by xor shuffles, and lane j
    keeps candidate j's SAD. stats["largest"]: the largest union of one
    plane's candidate footprints in one block, the reference pixels the
    warp reads there from L1 and L2."""
    px, rstep = bs * bs // 32, 32 // bs
    n_planes, rh, rw = ref.shape
    h, w = cur.shape
    oy, ox = (rh - h) // 2, (rw - w) // 2
    k, nby, nbx = dy.shape
    out = np.zeros(dy.shape, np.int64)
    lanes = np.arange(32)
    row, col = lanes // bs, lanes % bs       # pixels (row + rstep i, col)
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * bs, bx * bs
            c = np.stack([cur[y0 + row + rstep * i, x0 + col] for i in range(px)], 1)
            for c0 in range(0, k, 32):
                n = min(32, k - c0)
                vy, vx = dy[c0:c0 + n, by, bx], dx[c0:c0 + n, by, bx]
                plane = np.array([plane_of[c0 + j] if plane_of and c0 + j < 16
                                  else 0 for j in range(n)])
                for j in range(n):
                    x = np.clip(x0 + col + vx[j] + ox, 0, rw - 1)
                    part = sum(np.abs(c[:, i] - ref[plane[j], np.clip(
                        y0 + row + rstep * i + vy[j] + oy, 0, rh - 1), x])
                        for i in range(px))
                    off = 1
                    while off < 32:
                        part = part + part[lanes ^ off]
                        off *= 2
                    assert (part == part[0]).all()
                    out[c0 + j, by, bx] = part[j]
                if stats is not None:
                    for p in set(plane.tolist()):
                        on = plane == p
                        box = ((vy[on].max() - vy[on].min() + bs)
                               * (vx[on].max() - vx[on].min() + bs))
                        stats["largest"] = max(stats["largest"], int(box))
    return out


def _sad_at_sets(rng, case, h, w, bs=16):
    """(dy, dx [K, nby, nbx], plane_of, n_planes) of a caller's candidates
    at block size bs (radius bs): the diamond's four +-1 around even
    vectors, the half-pel refine's nine on four parity planes, the hier
    refine's 25, 16 candidates on 16 planes, one, random over the whole
    window with its corners, and 40 (two rounds of 32)."""
    r = bs
    nby, nbx = h // bs, w // bs
    c = rng.integers(-r, r + 1, (2, 1, nby, nbx))
    c[:, :, 0, 0], c[:, :, -1, -1] = -r, r
    plane_of, n_planes = None, 1
    if case == "diamond":
        c = c // 2 * 2
        offs = [(-1, 0), (0, -1), (0, 1), (1, 0)]
    elif case == "hpel":
        offs = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
        plane_of, n_planes = [abs(u) * 2 + abs(v) for u, v in offs], 4
    elif case == "hier":
        offs = [(u, v) for u in range(-2, 3) for v in range(-2, 3)]
    elif case == "one":
        offs = [(0, 0)]
    else:
        kk = {"planes16": 16, "window": 8, "many": 40}[case]
        offs = [(0, 0)] * kk
        c = rng.integers(-r, r + 1, (2, kk, nby, nbx))
        if case == "planes16":
            plane_of, n_planes = [int(q) for q in rng.permutation(16)], 16
        if case == "window":
            for k, (sy, sx) in enumerate(((-1, -1), (-1, 1), (1, -1), (1, 1))):
                c[0, k], c[1, k] = r * sy, r * sx
    u = np.array([o[0] for o in offs])[:, None, None]
    v = np.array([o[1] for o in offs])[:, None, None]
    if case == "hpel":        # the integer parts of 2d + u
        dy, dx = (2 * c[0] + u) >> 1, (2 * c[1] + v) >> 1
    else:
        dy, dx = c[0] + u, c[1] + v
    return np.clip(dy, -r, r), np.clip(dx, -r, r), plane_of, n_planes


def _pallas_sad_at(cur, planes, dy, dx, plane_of, bs):
    """The reference's Pallas sad_at_mv (sad_at_mv_chroma at bs 8) in
    interpret mode, one vmapped call per plane's candidates."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from video_encoder_tpu.ops.pallas import sad as psad

    fn = jax.vmap(psad.sad_at_mv if bs == 16 else psad.sad_at_mv_chroma,
                  in_axes=(None, None, 0, 0))
    of = plane_of or [0] * dy.shape[0]
    out = np.zeros(dy.shape, np.int64)
    with pltpu.force_tpu_interpret_mode():
        for p in sorted(set(of)):
            ks = [k for k, q in enumerate(of) if q == p]
            out[ks] = np.asarray(fn(jnp.asarray(cur), jnp.asarray(planes[p]),
                                    jnp.asarray(dy[ks], jnp.int32),
                                    jnp.asarray(dx[ks], jnp.int32)))
    return out


@pytest.mark.parametrize("case", ["diamond", "hpel", "hier", "planes16", "one",
                                  "window", "many"])
def test_sad_at_warp_model(rng, case):
    """The warp-per-block model equals the plain sad_at and the reference's
    Pallas sad_at_mv at 48x80, for each caller's candidate set. The union
    of one plane's footprints in a block, what the warp reads from L1 and
    L2 for it: 18x18 for the diamond's four, at most 17x17 per parity plane
    for the half-pel refine's nine, 20x20 for the hier refine's 25, the
    whole window for the spread set."""
    from video_encoder_tpu_torch.ops import motion

    h, w = 48, 80
    dy, dx, plane_of, n_planes = _sad_at_sets(rng, case, h, w)
    cur = rng.integers(0, 256, (h, w))
    ref = rng.integers(0, 256, (n_planes, h, w))
    stats = dict(largest=0)
    got = _sad_at_model(cur, ref, dy, dx, 16, plane_of, stats)
    plain = motion.sad_at(_t(cur), _t(ref if plane_of else ref[0]), _t(dy),
                          _t(dx), plane_of=plane_of)
    assert np.array_equal(got, plain.numpy())
    if case in ("diamond", "hpel", "hier", "window"):
        assert np.array_equal(got, _pallas_sad_at(cur, ref, dy, dx, plane_of, 16))
    largest = {"diamond": 18 * 18, "hpel": 17 * 17, "hier": 20 * 20,
               "window": 48 * 48, "one": 16 * 16, "planes16": 16 * 16}
    if case in largest:
        assert stats["largest"] == largest[case]
    if case == "one":         # no candidate axis
        one = motion.sad_at(_t(cur), _t(ref[0]), _t(dy[0]), _t(dx[0]))
        assert np.array_equal(got[0], one.numpy())


@pytest.mark.parametrize("sr,sc", [(1, 1), (3, 1), (2, 2)])
def test_sad_at_warp_model_pre_haloed(rng, sr, sc):
    """The same model on pre-haloed shards, the row-haloed ([h + 32, w])
    and the 2 x 2 haloed ([h + 32, w + 32]) extents with cur's origin
    derived per axis: equal to sad_at_pre_haloed and, for a row halo, to
    the reference's jnp _sad_at_haloed; joined, to the whole frame's."""
    from video_encoder_tpu.ops import transform as jtx
    from video_encoder_tpu.parallel import tiles as jtiles
    from video_encoder_tpu_torch.ops import motion

    h, w = 48 * sr, 64 * sc
    dy, dx, plane_of, _ = _sad_at_sets(rng, "hpel", h, w)
    cur = rng.integers(0, 256, (h, w))
    planes = rng.integers(0, 256, (4, h, w))
    pad = np.pad(planes, ((0, 0), (16, 16), (16, 16)), mode="edge")
    whole = motion.sad_at(_t(cur), _t(planes), _t(dy), _t(dx), plane_of=plane_of)
    hs, ws = h // sr, w // sc
    for i in range(sr):
        for j in range(sc):
            cs = cur[i * hs:(i + 1) * hs, j * ws:(j + 1) * ws]
            rows = pad[:, i * hs:(i + 1) * hs + 32]
            ext = rows[:, :, 16:-16] if sc == 1 else rows[:, :, j * ws:(j + 1) * ws + 32]
            sl = np.s_[:, i * hs // 16:(i + 1) * hs // 16, j * ws // 16:(j + 1) * ws // 16]
            got = _sad_at_model(cs, ext, dy[sl], dx[sl], 16, plane_of)
            plain = motion.sad_at_pre_haloed(_t(cs), _t(ext), _t(dy[sl]),
                                             _t(dx[sl]), plane_of)
            assert np.array_equal(got, plain.numpy())
            assert np.array_equal(got, whole[sl].numpy())
            if sc == 1:
                cb = jtx.blockify(jnp.asarray(cs), 16)
                want = [jtiles._sad_at_haloed(cb, jnp.asarray(ext[p]),
                                              jnp.asarray(dy[sl][k]),
                                              jnp.asarray(dx[sl][k]), 16)
                        for k, p in enumerate(plane_of)]
                assert np.array_equal(got, np.stack([np.asarray(a) for a in want]))


@pytest.mark.parametrize("case", ["diamond", "window", "many"])
def test_sad_at_warp_model_chroma(rng, case):
    """BS = 8 (the chroma twin: two pixels per lane, rows four apart): the
    model equals the plain sad_at at block 8 and the reference's Pallas
    sad_at_mv_chroma."""
    from video_encoder_tpu_torch.ops import motion

    h, w = 24, 40
    dy, dx, _, _ = _sad_at_sets(rng, case, h, w, bs=8)
    cur = rng.integers(0, 256, (h, w))
    ref = rng.integers(0, 256, (1, h, w))
    got = _sad_at_model(cur, ref, dy, dx, 8)
    assert np.array_equal(got, motion.sad_at(_t(cur), _t(ref[0]), _t(dy), _t(dx), 8).numpy())
    if case != "many":
        assert np.array_equal(got, _pallas_sad_at(cur, ref, dy, dx, None, 8))


# ---- the diamond descent: descent_kernel in csrc/diamond.cu -----------------

def _descent_model(cur, ref, meven, walks=None):
    """descent_kernel on planes [(G,) h, w] and their even map [(G,) nby,
    nbx, 289] (numpy): one warp per MB of the flattened G x MB grid. The
    walk, the same on every lane, reads the MB's row of the map: a
    candidate's entry at its clamped vector, BIG outside ±16, a move only
    to a strictly smaller cost in the order up, left, right, down, and it
    stops at the first frozen step (no move, or a cost under 512). Then
    the final ±1 step of every MB: each valid candidate's SAD summed per
    lane over the lane's pixels of cur (column l % 16 of rows l / 16 +
    2 i) against the reference at clamped coordinates, then over the
    lanes by xor shuffles; an invalid candidate is not read and costs
    BIG; the same rule. walks collects each MB's (steps taken, the walk's
    last vector). Returns (dy, dx, sad) int64 [(G,) nby, nbx]."""
    from video_encoder_tpu_torch.ops import motion

    r, big = motion.R, motion.BIG
    lead, (h, w) = cur.shape[:-2], cur.shape[-2:]
    nby, nbx = h // 16, w // 16
    cur2, ref2 = cur.reshape(-1, h, w), ref.reshape(-1, h, w)
    rows = meven.reshape(-1, 289)
    out = np.zeros((3, rows.shape[0]), np.int64)
    lanes = np.arange(32)
    col, row = lanes % 16, lanes // 16
    units = ((-1, 0), (0, -1), (0, 1), (1, 0))

    def entry(mrow, dy, dx):
        cy, cx = min(max(dy, -r), r), min(max(dx, -r), r)
        return int(mrow[((cy + r) >> 1) * motion.NE + ((cx + r) >> 1)])

    def valid(dy, dx):
        return abs(dy) <= r and abs(dx) <= r

    def pick(dy, dx, cost, costs, scale):
        best, by, bx = cost, dy, dx
        for (uy, ux), c in zip(units, costs):
            if c < best:
                best, by, bx = c, dy + scale * uy, dx + scale * ux
        return by, bx, best

    for m, mrow in enumerate(rows):
        g, b = divmod(m, nby * nbx)
        y0, x0 = (b // nbx) * 16, (b % nbx) * 16
        c = np.stack([cur2[g, y0 + row + 2 * i, x0 + col] for i in range(8)], 1)
        dy = dx = steps = 0
        cost = entry(mrow, 0, 0)
        frozen = cost < spec.DIAMOND_EARLY_SAD
        while steps < spec.DIAMOND_MAX_STEPS and not frozen:
            steps += 1
            costs = [entry(mrow, dy + 2 * uy, dx + 2 * ux)
                     if valid(dy + 2 * uy, dx + 2 * ux) else big
                     for uy, ux in units]
            ny, nx, best = pick(dy, dx, cost, costs, 2)
            if (ny, nx) == (dy, dx):
                frozen = True
            else:
                dy, dx, cost = ny, nx, best
                frozen = cost < spec.DIAMOND_EARLY_SAD
        if walks is not None:
            walks.append((steps, dy, dx))
        costs = []
        for uy, ux in units:
            ny, nx = dy + uy, dx + ux
            if not valid(ny, nx):
                costs.append(big)
                continue
            x = np.clip(x0 + col + nx, 0, w - 1)
            part = sum(np.abs(c[:, i] - ref2[g, np.clip(
                y0 + row + 2 * i + ny, 0, h - 1), x]) for i in range(8))
            off = 1
            while off < 32:
                part = part + part[lanes ^ off]
                off *= 2
            assert (part == part[0]).all()
            costs.append(int(part[0]))
        out[:, m] = pick(dy, dx, cost, costs, 1)
    return tuple(o.reshape(*lead, nby, nbx) for o in out)


@pytest.mark.parametrize("g", [None, 3])
@pytest.mark.parametrize("kind", ["random", "pan", "corner", "flat"])
def test_descent_model(rng, kind, g):
    """The warp-per-MB model equals the plain route of the diamond search
    (dispatch.diamond_search on the CPU: the even map, then the masked
    loop motion.diamond_search_with) on random, panned, corner-bound and
    flat planes, one plane and G = 3, the reference's diamond_search (the
    JAX package, plane by plane) and, for one plane, the golden model's
    sad_diamond_search. The corner-bound walks reach the window's edge,
    where the final step meets candidates outside ±16."""
    from video_encoder_tpu.ops import motion as jmotion
    from video_encoder_tpu_torch.codec import golden
    from video_encoder_tpu_torch.ops import dispatch, motion

    from diamond_cases import planes

    lead = () if g is None else (g,)
    h, w = 64, 96
    cur, ref = planes(rng, kind, lead, h, w)
    meven = motion.sad_map_even(_t(cur), _t(ref))
    walks = []
    got = _descent_model(cur, ref, meven.numpy(), walks)
    plain = dispatch.diamond_search(_t(cur), _t(ref))
    for a, b in zip(got, plain):
        assert np.array_equal(a, b.numpy())
    ref_runs = [jmotion.diamond_search(jnp.asarray(c, jnp.int32),
                                       jnp.asarray(r, jnp.int32))
                for c, r in zip(cur.reshape(-1, h, w), ref.reshape(-1, h, w))]
    for a, b in zip(got, zip(*ref_runs)):
        assert np.array_equal(a, np.stack([np.asarray(x) for x in b])
                              .reshape(a.shape))
    if g is None:
        gold = golden.sad_diamond_search(cur.astype(np.int32), ref.astype(np.int32))
        for a, b in zip(got, gold):
            assert np.array_equal(a, b)
    steps = np.array([s for s, _, _ in walks])
    if kind == "corner":
        assert sum((s, abs(y), abs(x)) == (16, 16, 16) for s, y, x in walks) >= 3
    if kind == "flat":
        assert not steps.any() and not got[0].any() and not got[1].any()
    if kind in ("pan", "corner"):
        assert steps.max() >= 2


@pytest.mark.parametrize("g", [None, 2])
def test_descent_model_crafted_maps(rng, g):
    """On maps that set each MB's walk (tests/diamond_cases.py: costs of
    511 and 512 at the start and after the first move, ties among the
    candidates and with the current vector, a walk that moves in all 16
    steps along the window's edge, flat and random rows), the model
    equals the plain descent motion.diamond_descent over the same map,
    and each walk takes the steps its case sets."""
    from diamond_cases import crafted_maps, near_planes

    from video_encoder_tpu_torch.ops import motion

    lead = () if g is None else (g,)
    h, w = 64, 160
    cur, ref = near_planes(rng, lead, h, w)
    maps, cases = crafted_maps(rng, lead, h // 16, w // 16)
    walks = []
    got = _descent_model(cur, ref, maps, walks)
    plain = motion.diamond_descent(_t(cur), _t(ref), torch.from_numpy(maps))
    for a, b in zip(got, plain):
        assert np.array_equal(a, b.numpy())
    want = {"start511": (0, 0, 0), "start512": (1, 2, 0), "mid511": (1, 0, 2),
            "mid512": (2, 0, 4), "tie4": (2, -2, 0), "tie_current": (1, 0, 0),
            "tie_right_down": (2, 0, 2), "flat": (1, 0, 0)}
    for case, walk in zip(cases.reshape(-1), walks):
        if case in want:
            assert walk == want[case], case
        if case == "no_freeze":
            assert walk[0] == 16 and abs(walk[1]) == abs(walk[2]) == 16
    # the final step moves off the walk's end somewhere, also at the corner
    final = [(y, x) != (wy, wx) for (_, wy, wx), y, x in
             zip(walks, got[0].reshape(-1), got[1].reshape(-1))]
    assert any(final)
    assert any(f for f, c in zip(final, cases.reshape(-1)) if c == "no_freeze")


def test_descent_constants_are_the_spec():
    """The kernel's radius, step budget, early-exit SAD and BIG are the
    spec's, as the plain loop reads them."""
    import os
    import re

    from video_encoder_tpu_torch.ops import motion
    from video_encoder_tpu_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, "diamond.cu")) as f:
        src = f.read()
    assert _kernel_constant("diamond.cu", "R") == motion.R
    assert _kernel_constant("diamond.cu", "MAX_STEPS") == spec.DIAMOND_MAX_STEPS
    assert _kernel_constant("diamond.cu", "EARLY_SAD") == spec.DIAMOND_EARLY_SAD
    assert 1 << int(re.search(r"constexpr int BIG = 1 << (\d+);", src)
                    .group(1)) == motion.BIG


# ---- the SEA search: sea_kernel in csrc/full_search.cu ----------------------

def _kernel_constant(source, name):
    """A constexpr int of csrc/<source>, so a model follows its kernel."""
    import os
    import re

    from video_encoder_tpu_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


SEA_FIRST = _kernel_constant("full_search.cu", "SEA_FIRST")  # first batch's rows


def _sea_row(s):
    """Row index ky = dy + 16 of step s of the centre-out order."""
    return 16 + ((s + 1) >> 1) * (1 - 2 * (s & 1))


def _sliding_col_sums(win):
    """The window's 16-row column sums [.., 33, 48] as the kernel's 96
    threads make them: one thread per column and half of the row offsets
    (0..16, 17..32), 16 adds at the half's first offset, then an add and a
    subtract per step."""
    out = np.zeros((*win.shape[:-2], 33, 48), np.int64)
    for k0, k1 in ((0, 17), (17, 33)):
        s = np.zeros(win.shape[:-2] + (48,), np.int64)
        for r in range(16):
            s = s + win[..., k0 + r, :]
        out[..., k0, :] = s
        for ky in range(k0 + 1, k1):
            s = s + win[..., ky + 15, :] - win[..., ky - 1, :]
            out[..., ky, :] = s
    return out


def _windows(cur, ref):
    """Each MB's clamped 48x48 window [nby, nbx, 48, 48] of ref [rh, rw]
    (cur's origin at ((rh - h) / 2, (rw - w) / 2), as the kernel reads it)
    and its block [nby, nbx, 16, 16]."""
    h, w = cur.shape
    rh, rw = ref.shape
    nby, nbx = h // 16, w // 16
    ys = np.clip(16 * np.arange(nby)[:, None] - 16 + np.arange(48) + (rh - h) // 2, 0, rh - 1)
    xs = np.clip(16 * np.arange(nbx)[:, None] - 16 + np.arange(48) + (rw - w) // 2, 0, rw - 1)
    win = ref.astype(np.int64)[ys[:, None, :, None], xs[None, :, None, :]]
    blk = cur.astype(np.int64).reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3)
    return win, blk


def _byte_shift(a, b, s):
    """__byte_perm(a, b, 0x3210 + 0x1111 s): the word s bytes into b:a."""
    return (((b << 32) | a) >> (8 * s)) & MASK32


def _packed_run_sads(wp, bp, ky, kx0):
    """run_sads_packed for every MB: the SADs [11, nby, nbx] of candidates
    (ky, kx0 .. kx0 + 10) from the window's packed rows wp [.., 48, 13]
    (the pad word zero) and the block's bp [.., 16, 4]: per lane (four
    block rows each) and row, the 8 words from kx0 // 4, shifted to start
    at sample kx0, then by 1, 2 and 3 more samples, four vabsdiff4 per
    candidate, the four lanes' sums added."""
    acc = np.zeros((11, *bp.shape[:2]), np.int64)
    for r0 in range(0, 16, 4):
        for r in range(r0, r0 + 4):
            a = wp[..., ky + r, kx0 // 4:kx0 // 4 + 8]
            assert a.shape[-1] == 8
            t = _byte_shift(a[..., :7], a[..., 1:], kx0 % 4)
            sh = [t[..., :6]] + [_byte_shift(t[..., :6], t[..., 1:], s) for s in (1, 2, 3)]
            for j in range(11):
                for m in range(4):
                    acc[j] += _vsad4(bp[..., r, m], sh[j % 4][..., j // 4 + m])
    return acc


def _sea_model(cur, ref):
    """sea_kernel on cur [h, w] against ref [rh, rw] (numpy, every MB at
    once): the sliding column sums, each row's smallest bound from two
    lanes of 17 candidates over a strip of 32 sums, the first batch of
    SEA_FIRST rows in the centre-out order, the later rows whose bound is
    <= that batch's best compacted in order (warp 0's ballot), each
    evaluated row's smallest key from its three runs of 11 candidates, the
    result the smallest key over the evaluated rows and the row count
    replayed; the exact rows on words of four 8-bit samples
    (_packed_run_sads). Returns (dy, dx, sad, rows, evaluated [33, nby, nbx],
    n_later [nby, nbx])."""
    win, blk = _windows(cur, ref)
    nby, nbx = blk.shape[:2]
    winc = _sliding_col_sums(win)
    curc = blk.sum(-2)
    rowmin = np.zeros((33, nby, nbx), np.int64)
    for ky in range(33):
        half = []
        for kx0 in (0, 16):
            strip = winc[..., ky, kx0:kx0 + 32]
            half.append(np.min([np.abs(curc - strip[..., j:j + 16]).sum(-1)
                                for j in range(17)], 0))
        rowmin[ky] = np.minimum(*half)
    rowkey = np.full((33, nby, nbx), INT32_MAX, np.int64)
    evaluated = np.zeros((33, nby, nbx), bool)

    wp, bp = _pack4(np.pad(win, ((0, 0), (0, 0), (0, 0), (0, 4)))), _pack4(blk)

    def evaluate(ky, on):
        keys = [sad * 2048 + ky * 33 + kx0 + j for kx0 in range(0, 33, 11)
                for j, sad in enumerate(_packed_run_sads(wp, bp, ky, kx0))]
        rowkey[ky] = np.where(on, np.minimum(rowkey[ky], np.min(keys, 0)), rowkey[ky])
        evaluated[ky] |= on

    for q in range(SEA_FIRST):
        evaluate(_sea_row(q), np.ones((nby, nbx), bool))
    best = rowkey[[_sea_row(q) for q in range(SEA_FIRST)]].min(0)
    later = [_sea_row(s) for s in range(SEA_FIRST, 33)]
    keep = rowmin[later] <= (best >> 11)                     # the ballot's lanes
    # the compacted list of an MB holds its kept rows in order; each of
    # its n_later rows takes RUNS = 3 of the second batch's groups
    n_later = keep.sum(0)
    assert n_later.max() <= 33 - SEA_FIRST
    for ky, on in zip(later, keep):
        evaluate(ky, on)
    key = rowkey.min(0)
    run_best, rows = np.full((nby, nbx), INT32_MAX, np.int64), np.zeros((nby, nbx), np.int64)
    for s in range(33):                                      # the replay
        ky = _sea_row(s)
        need = rowmin[ky] <= (run_best >> 11)
        assert evaluated[ky][need].all()                     # a superset
        rows += need
        run_best = np.where(need, np.minimum(run_best, rowkey[ky]), run_best)
    assert np.array_equal(run_best, key)
    k = key & 2047
    return k // 33 - 16, k % 33 - 16, key >> 11, rows, evaluated, n_later


def _sea_planes(rng, kind, h, w):
    """cur, ref [h, w]: a smooth pan, a textured one, the pan against a
    qp-28 recon of its reference (the engine's case), noise, two flat
    planes (every candidate ties and every bound equals its SAD), a best
    at the (+16, -16) corner, and a bound equal to the best: MB (1, 1)
    matches +1 everywhere at (0, 0) and at (-16, -16), where its bound is
    exact, so a `<` would prune the earlier candidate."""
    from video_encoder_tpu_torch.codec import tables
    from video_encoder_tpu_torch.ops import dispatch

    base = rng.integers(0, 256, (h + 64, w + 64))
    if kind == "flat":
        return np.full((h, w), 77), np.full((h, w), 100)
    if kind == "noise":
        return rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h, w))
    for _ in range(1 if kind == "textured" else 2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    cur, ref = base[32:32 + h, 32:32 + w].copy(), base[30:30 + h, 35:35 + w].copy()
    if kind == "recon":
        q28 = int(tables.load("cpu").QSTEP[28])
        ref = dispatch.code_plane(_t(ref), torch.full((h, w), 128, dtype=torch.int32),
                                  torch.full((h // 8, w // 8), q28, dtype=torch.int32),
                                  8)[1].numpy()
    elif kind == "corner":
        ref = base[16:16 + h, 48:48 + w].copy()
    elif kind == "equal":
        ref = rng.integers(0, 200, (h, w))
        cur[16:32, 16:32] = np.minimum(cur[16:32, 16:32], 254)
        ref[16:32, 16:32] = cur[16:32, 16:32] + 1
        ref[0:16, 0:16] = cur[16:32, 16:32] + 1
    return cur, ref


def _pallas_sea(cur, ref):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from video_encoder_tpu.ops.pallas import sad as psad

    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(a) for a in psad.full_search_sea_stats(
            jnp.asarray(cur, jnp.int32), jnp.asarray(ref, jnp.int32))]


@pytest.mark.parametrize("kind", ["smooth", "textured", "recon", "noise", "flat",
                                  "corner", "equal"])
def test_sea_batch_model(rng, kind):
    """The batched schedule equals full_search's (dy, dx, sad) and the
    plain SEA's rows per MB (the sequential count, replayed), evaluates a
    superset of the sequential rows, and on a 64x128 plane (the
    reference's SEA tile) the reference's Pallas SEA in interpret mode,
    whose per-tile count is the OR of the plain masks."""
    from video_encoder_tpu.ops.pallas import sad as psad
    from video_encoder_tpu_torch.ops import motion

    h, w = 64, 128
    cur, ref = _sea_planes(rng, kind, h, w)
    dy, dx, sad, rows, evaluated, n_later = _sea_model(cur, ref)
    want = motion.full_search(_t(cur), _t(ref))
    for a, b in zip((dy, dx, sad), want):
        assert np.array_equal(a, b.numpy())
    *plain, mask = motion.full_search_sea(_t(cur), _t(ref), with_mask=True)
    assert np.array_equal(rows, plain[3].numpy())
    assert (evaluated >= mask.numpy()).all()
    if kind in ("noise", "flat"):
        assert (rows == 33).all() and (n_later == 33 - SEA_FIRST).all()
    if kind == "flat":                           # ties: the first candidate
        assert (dy == -16).all() and (dx == -16).all()
    if kind == "corner":
        assert (dy[1:-1, 1:-1] == 16).all() and (dx[1:-1, 1:-1] == -16).all()
    if kind == "equal":                          # bound == best at (-16, -16)
        assert (dy[1, 1], dx[1, 1], sad[1, 1]) == (-16, -16, 256)
    if kind in ("smooth", "recon", "noise", "equal"):
        pallas = _pallas_sea(cur, ref)
        for a, b in zip((dy, dx, sad), pallas):
            assert np.array_equal(a, b)
        tm, tn = psad._fs_tile_shape(h // 16, w // 16)
        per_tile = mask.reshape(33, h // 16 // tm, tm, w // 16 // tn, tn).any(4).any(2)
        assert np.array_equal(per_tile.sum(0).numpy(), pallas[3])


@pytest.mark.parametrize("cols_halo", [False, True])
def test_sea_batch_model_pre_haloed(rng, cols_halo):
    """The same schedule on a shard against its pre-haloed reference (a
    row shard, columns edge-replicated; a 2-D tile, column halo too):
    equal to the plain pre-haloed search and SEA."""
    from video_encoder_tpu_torch.ops import motion

    h, w = 48, 64
    cur, big = _sea_planes(rng, "recon", h + 32, w + 32)
    cur = cur[16:16 + h, 16:16 + w]
    ref_ext = big if cols_halo else big[:, 16:16 + w]
    dy, dx, sad, rows, _, _ = _sea_model(cur, ref_ext)
    want = motion.full_search_sea_pre_haloed(_t(cur), _t(ref_ext))
    for a, b in zip((dy, dx, sad, rows), want):
        assert np.array_equal(a, b.numpy())
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(
        (dy, dx, sad), motion.full_search_pre_haloed(_t(cur), _t(ref_ext))))


@pytest.mark.parametrize("kind", ["random", "extremes"])
def test_sea_sliding_column_sums(rng, kind):
    """The sliding sums equal the direct 16-row sums at every row offset;
    a column sum is at most 4080 and a bound at most 65280 (both fit 16
    bits)."""
    win = rng.integers(0, 256, (5, 48, 48))
    if kind == "extremes":
        win[0], win[1] = 0, 255
        win[2, ::2] = 255
        win[3, :, ::3] = 0
    got = _sliding_col_sums(win)
    direct = np.stack([win[:, ky:ky + 16].sum(1) for ky in range(33)], 1)
    assert np.array_equal(got, direct)
    assert got.max() <= 16 * 255 < 2**16 and 16 * int(got.max()) <= 65280


# ---- the span and chunk merges: merge_kernel in csrc/span_merge.cu --------

MASK32 = (1 << 32) - 1


MERGE_CHUNK = _kernel_constant("span_merge.cu", "CHUNK")   # positions per task


def _block_scan(bits, nt):
    """The block's exclusive scan of a string's m piece bit counts as the
    kernel takes it with nt threads: thread i sums the run [i per, (i + 1)
    per) of pieces (per <= 4), the warps scan their threads' sums, warp 0
    the warp totals. Returns the offsets [m] and the total."""
    m = len(bits)
    per = -(-m // nt)
    assert per <= 4
    local = np.array([bits[min(i * per, m):min(i * per + per, m)].sum()
                      for i in range(nt)], np.int64).reshape(nt // 32, 32)
    warp_tot = np.cumsum(local.sum(1))
    run = (np.cumsum(local, 1) - local + np.r_[0, warp_tot[:-1]][:, None]).reshape(-1)
    offs = np.zeros(m, np.int64)
    for i in range(nt):
        for j in range(min(i * per, m), min(i * per + per, m)):
            offs[j] = run[i]
            run[i] += bits[j]
    return offs, warp_tot[-1]


def _merge_model(piece_words, caps, bits, m, cw, n_out):
    """merge_kernel over pieces [n, W] (uint64, caps [n]) with bit counts
    [n] (pieces past n empty): one block per output string of m pieces, cw
    words. Task (i, c) holds positions [c CHUNK, (c + 1) CHUNK) of piece i
    and, before the scan, its words c CHUNK - 1 .. c CHUNK + CHUNK - 1,
    read only up to the piece's used words min(ceil(bits / 32), width).
    After the scan position q of a piece at o = 32 T + r makes word T + q,
    its word q >> r ored with its word q - 1 << (32 - r): a word wholly
    inside the piece's bits is stored (no other task writes it), one that
    holds a boundary is ored. Returns (words [n_out, cw] int32, the
    kernel's 32-bit stores, bits [n_out], ovf)."""
    n = len(bits)
    width = piece_words.shape[1]
    chunks = (max(caps.max(), 1) + MERGE_CHUNK) // MERGE_CHUNK
    nt = 256 if m * chunks <= 2 * 256 else 1024
    assert m * chunks <= (2 if nt == 256 else 3) * nt
    out = np.zeros((n_out, cw), np.uint64)
    totals = np.zeros(n_out, np.int64)
    pad = (0, n_out * m - n)
    words = np.pad(piece_words, (pad, (0, 0)))[:n_out * m].reshape(n_out, m, width)
    caps_s = np.pad(caps, pad).reshape(n_out, m)
    bits_s = np.pad(bits, pad).reshape(n_out, m)
    for s in range(n_out):
        used = np.minimum((bits_s[s] + 31) >> 5, caps_s[s])
        offs, totals[s] = _block_scan(bits_s[s], nt)
        stored = np.zeros(cw, np.int64)
        ored = np.zeros(cw, bool)
        for i in range(m):
            nb, u, o = int(bits_s[s, i]), int(used[i]), int(offs[i])
            if nb == 0:
                continue
            r = o & 31
            for c in range(chunks):
                wd = [int(words[s, i, j]) if 0 <= j < u else 0
                      for j in range(c * MERGE_CHUNK - 1, (c + 1) * MERGE_CHUNK)]
                for e in range(MERGE_CHUNK):
                    q = c * MERGE_CHUNK + e
                    t = (o >> 5) + q
                    if q > u or (q == u and r == 0) or t >= cw:
                        break
                    word = wd[e + 1] if r == 0 else (
                        ((wd[e] << (32 - r)) | (wd[e + 1] >> r)) & MASK32)
                    if 32 * t >= o and 32 * t + 32 <= o + nb:
                        stored[t] += 1
                        out[s, t] = word
                    elif word:
                        ored[t] = True
                        out[s, t] |= np.uint64(word)
        assert stored.max(initial=0) <= 1 and not (ored & (stored > 0)).any()
    return (out.astype(np.uint32).view(np.int32), totals,
            bool((totals > 32 * cw).any()))


def _valid(rng, n, cap, bits):
    """Strings [n, cap] uint64 with the given bit counts, zeros past them."""
    col = np.arange(cap) * 32
    keep = np.clip(np.asarray(bits)[:, None] - col, 0, 32).astype(np.uint64)
    vals = rng.integers(0, 2**32, (n, cap), dtype=np.uint64)
    return np.where(keep > 0, vals >> (np.uint64(32) - keep) << (np.uint64(32) - keep),
                    0).astype(np.uint64)


def _garbage_past_used(rng, words, bits):
    """words with random values in every word past a string's used words
    min(ceil(bits / 32), width)."""
    used = (np.minimum(np.asarray(bits), 32 * words.shape[1]) + 31) // 32
    past = np.arange(words.shape[1])[None, :] >= used[:, None]
    return np.where(past, rng.integers(0, 2**32, words.shape, dtype=np.uint64), words)


def _mb_piece_sources(rng, n_mbs, w, hww, dense):
    """Per-MB sources hw [n_mbs, hww], yw [n_mbs, 4, w], cbw, crw [n_mbs, w]
    (clean, words past the counts zero), piece bits [n_mbs * 8], and the
    same pieces as rows [n_mbs * 8, max(w, hww)] with garbage past their
    used words, and their widths."""
    if dense:
        bits = np.full((n_mbs, 8), 32 * w)
    else:
        bits = rng.integers(0, 32 * w + 40, (n_mbs, 8))   # some over the width
        bits[rng.random(bits.shape) < 0.2] = 0
        mult = rng.random(bits.shape) < 0.2
        bits[mult] = 32 * rng.integers(1, w + 1, mult.sum())
    bits[:, 0] = rng.integers(0, 32 * hww + 1, n_mbs)
    bits[:, 7] = 0
    wmax = max(w, hww)
    caps = np.tile([hww, w, w, w, w, w, w, 0], n_mbs)
    flat = bits.reshape(-1)
    clean = _valid(rng, n_mbs * 8, wmax, np.minimum(flat, 32 * caps))
    clean[np.arange(wmax)[None, :] >= caps[:, None]] = 0
    dirty = _garbage_past_used(rng, clean, np.minimum(flat, 32 * caps))
    c = clean.astype(np.uint32).view(np.int32).reshape(n_mbs, 8, wmax)
    srcs = (c[:, 0, :hww], c[:, 1:5, :w], c[:, 5, :w], c[:, 6, :w])
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in srcs],
            _t(flat), dirty, caps, flat)


@pytest.mark.parametrize("n_mbs,w,hww,dense,cut,flag", [
    (30, 16, 2, False, False, False),  # single stage: 240 pieces, strings of 16
    (100, 78, 2, False, False, False),  # BLOCK_WORDS_MAX, two stages
    (700, 16, 2, False, False, True),  # two stages at w = 16 (m1 = 128), over
    (24, 16, 3, False, False, False),  # a header of three words
    (64, 8, 2, True, True, True)])     # every string cut at half its width
def test_merge_placement_model(rng, n_mbs, w, hww, dense, cut, flag):
    """The placement equals the plain span_merge_mb and, for a
    two-stage plan, span_merge on its stage-1 strings: pieces of 0 bits,
    of multiples of 32 bits and longer than their width, a header of hww
    words, strings longer than the budgeted width and strings cut at cw,
    with the flag (stage 2 then reads its inputs' whole width). The
    pieces' words past their
    used words are garbage here, so the model reads none of them."""
    from video_encoder_tpu_torch.codec import pack

    srcs, pb, dirty, caps, flat = _mb_piece_sources(rng, n_mbs, w, hww, dense)
    plan = pack.span_plan(n_mbs, w)
    m, cw, n1 = plan.m1, plan.cw1, plan.n1
    if cut:
        cw = (m * w) // 2
    want = pack.span_merge_mb(*srcs, pb, m, cw, n1)
    got = _merge_model(dirty, caps, flat, m, cw, n1)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy()) and got[2] == bool(want[2])
    assert got[2] == flag and (not cut or int(want[1][-1]) > 32 * cw)
    if plan.two_stage:
        n2 = n1 // plan.g * plan.stop
        w2 = pack.span_merge(want[0], want[1], plan.g, plan.stop, plan.cwf)
        got2 = _merge_model(want[0].numpy().view(np.uint32).astype(np.uint64),
                            np.full(n1, cw),
                            want[1].numpy(), plan.g // plan.stop, plan.cwf, n2)
        assert np.array_equal(got2[0], w2[0].numpy())
        assert np.array_equal(got2[1], w2[1].numpy()) and got2[2] == bool(w2[2])


@pytest.mark.parametrize("lead,n,w,k", [((), 256, 8, 32), ((3,), 128, 4, 64),
                                        ((2,), 64, 24, 16)])
def test_chunk_merge_placement_model(rng, lead, n, w, k):
    """chunk_merge on the same placement (no flag: the width is
    the exact worst case), G folded into the rows."""
    from video_encoder_tpu_torch.codec import pack

    total = int(np.prod(lead, dtype=np.int64)) * n
    bits = rng.integers(0, 32 * w + 1, total)
    bits[::7] = 0
    bits[1::5] = 32 * rng.integers(1, w + 1, len(bits[1::5]))
    clean = _valid(rng, total, w, bits)
    words = torch.from_numpy(
        clean.astype(np.uint32).view(np.int32).reshape(*lead, n, w))
    want = pack.chunk_merge(words, _t(bits.reshape(*lead, n)), k)
    m = k // 2
    got = _merge_model(_garbage_past_used(rng, clean, bits), np.full(total, w),
                       bits, m, m * w + 1, total // m)
    assert np.array_equal(got[0], want[0].reshape(-1, m * w + 1).numpy())
    assert np.array_equal(got[1], want[1].reshape(-1).numpy()) and not got[2]


def _zero_past(words, bits):
    """Whether every string holds zeros past its bit count: whole words
    past ceil(bits / 32) and the low bits of the last used word (int32
    words viewed as uint32)."""
    words = np.asarray(words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    words = words.astype(np.uint64)
    bits = np.asarray(bits).astype(np.int64)
    col = np.arange(words.shape[-1]) * 32
    keep = np.clip(bits[..., None] - col, 0, 32).astype(np.uint64)
    mask = ((np.uint64(1) << keep) - np.uint64(1)) << (np.uint64(32) - keep)
    return bool(((words & ~mask & np.uint64(MASK32)) == 0).all())


@pytest.mark.parametrize("producer", ["block_pack_f1", "block_pack_f2",
                                      "block_pack_f1_max", "block_pack_f2_max",
                                      "mb_sources_f1", "mb_sources_f4", "stage1"])
def test_producers_zero_past_bits(rng, producer):
    """The merges read a piece's words only up to min(ceil(bits / 32),
    width), which equals reading them all only if every producer leaves
    zeros past its bit count: block_pack in both syntaxes (and its
    kernel's model) at 16 words, where long blocks overflow, and at
    BLOCK_WORDS_MAX; every piece of entropy._mb_sources of a coded frame,
    its header words too; the stage-1 strings of span_merge_mb."""
    from video_encoder_tpu_torch.codec import pack, tables
    from video_encoder_tpu_torch.ops import dispatch

    if producer.startswith("block_pack"):
        fmt = 2 if "f2" in producer else 1
        n_words = entropy.BLOCK_WORDS_MAX if producer.endswith("max") else 16
        lv, dcp = _pack_cases(rng)
        words, bits = kpack.plain_block_pack(_t(lv), n_words, _t(dcp) if fmt == 2 else None, fmt)
        model = _pack_model(_t(lv), n_words, _t(dcp), fmt)
        assert _zero_past(words, bits) and _zero_past(*model)
        assert bool((bits > 32 * n_words).any()) == (n_words == 16)
        return
    h, w = 64, 96
    q28 = int(tables.load("cpu").QSTEP[28])
    levels = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        cur = _t(rng.integers(0, 256, (ph, pw)))
        q = torch.full((ph // 8, pw // 8), q28, dtype=torch.int32)
        levels.append(dispatch.code_plane(cur, torch.full_like(cur, 128), q, 8)[0])
    nby, nbx = h // 16, w // 16
    fmt = 4 if producer == "mb_sources_f4" else 1
    (hw, yw, cbw, crw), bits, _ = entropy._mb_sources(
        *levels, _t(rng.integers(-2, 3, (nby, nbx))), True,
        torch.from_numpy(rng.random((nby, nbx)) < 0.7), _t(rng.integers(-16, 17, (nby, nbx))),
        _t(rng.integers(-16, 17, (nby, nbx))), 16, fmt)
    bits = bits.reshape(-1, 7)
    if producer == "stage1":
        pb = torch.nn.functional.pad(bits, (0, 1)).reshape(-1).contiguous()
        plan = pack.span_plan(nby * nbx, 16)
        words, sbits, ovf = pack.span_merge_mb(hw, yw, cbw, crw, pb, plan.m1, plan.cw1, plan.n1)
        assert not bool(ovf) and _zero_past(words, sbits)
        return
    assert _zero_past(hw, bits[:, 0]) and _zero_past(yw, bits[:, 1:5])
    assert _zero_past(cbw, bits[:, 5]) and _zero_past(crw, bits[:, 6])
    assert int(bits[:, 0].max()) <= 32 * hw.shape[-1]


# ---- the frame pack's tail: csrc/frame_pack.cu ------------------------------

TAIL_TILE = _kernel_constant("frame_pack.cu", "TILE")            # MBs a tile
TAIL_WARPS = _kernel_constant("frame_pack.cu", "PLACE_WARPS")    # a block's


def _put64(acc, off, code, n):
    """put64: a code of n bits appended at bit off of a 64-bit string,
    bits past 64 dropped."""
    if off < 64:
        end = off + n
        acc |= code << (64 - end) if end <= 64 else code >> (end - 64)
    return acc, off + n


def _tail_ue_len(u):
    """ue_len of one Python int."""
    return 2 * (u + 1).bit_length() - 1


def _tail_se_ue(v):
    """se_ue of one Python int."""
    return 2 * v - 1 if v > 0 else -2 * v


def _tail_headers_model(block_bits, hdr, is_p, n_strings, m, nbx, w, fmt):
    """mb_header_kernel: tile b of string s = b // tps, one lane per MB
    (flat MB i = s m + j in raster order): the header's four symbols into a
    64-bit code, its six blocks' counts from the luma [2 nby, 2 nbx] and
    chroma grids, the MB's total; the tile's sum and verdict. Returns
    (hw [n, 2] uint32, mb_bits [n], piece bits [n, 8], tile_info [n_tiles,
    2])."""
    qpd, inter, dy, dx = (np.asarray(t).reshape(-1).astype(np.int64)
                          for t in hdr)
    yb, cbb, crb = (np.asarray(b).reshape(-1).astype(np.int64)
                    for b in block_bits)
    tps = -(-m // TAIL_TILE)
    n = n_strings * m
    hw = np.zeros((n, 2), np.uint32)
    mb = np.zeros(n, np.int64)
    pbits = np.zeros((n, 8), np.int64)
    tile_info = np.zeros((n_strings * tps, 2), np.int64)
    for b in range(n_strings * tps):
        s, t = divmod(b, tps)
        for lane in range(TAIL_TILE):
            j = t * TAIL_TILE + lane
            if j >= m:
                continue
            i = s * m + j
            row, c = divmod(i, nbx)
            h = hb = 0
            if is_p:
                h, hb = _put64(h, hb, 1 if inter[i] else 2, 1 if inter[i] else 3)
            if is_p and inter[i]:
                vy, vx = int(dy[i]), int(dx[i])
                if fmt >= 2 and c > 0 and inter[i - 1]:
                    vy, vx = vy - int(dy[i - 1]), vx - int(dx[i - 1])
                for v in (vx, vy):
                    u = _tail_se_ue(v)
                    h, hb = _put64(h, hb, u + 1, _tail_ue_len(u))
            u = _tail_se_ue(int(qpd[i]))
            h, hb = _put64(h, hb, u + 1, _tail_ue_len(u))
            y0 = 2 * row * 2 * nbx + 2 * c
            blk = [yb[y0], yb[y0 + 1], yb[y0 + 2 * nbx], yb[y0 + 2 * nbx + 1],
                   cbb[i], crb[i]]
            mb[i] = hb + sum(blk)
            assert mb[i] <= INT32_MAX
            hw[i] = (h >> 32, h & MASK32)
            pbits[i] = [hb, *blk, 0]
            tile_info[b, 0] += mb[i]
            tile_info[b, 1] |= hb > 64 or max(blk) > 32 * w
        assert tile_info[b, 0] <= INT32_MAX
    return hw, mb, pbits, tile_info


def _tail_scan_model(mb, tile_info, n_strings, m):
    """frame_place_kernel's offsets: block b's base is the sum of its
    string's earlier tile sums, and warp 0's exclusive scan of the tile's
    MB totals, from the base's bit within its first word, gives each MB's
    offset; every partial sum is an int32. Returns (base per tile, MB
    offsets from the tile's first word [n])."""
    tps = -(-m // TAIL_TILE)
    bases = np.zeros(n_strings * tps, np.int64)
    offs = np.zeros(n_strings * m, np.int64)
    for b in range(n_strings * tps):
        s, t = divmod(b, tps)
        earlier = tile_info[s * tps:b, 0]
        parts = [int(earlier[k::TAIL_WARPS * 32].sum())
                 for k in range(TAIL_WARPS * 32)]    # each thread's part
        assert max(parts) <= INT32_MAX
        bases[b] = sum(parts)
        assert bases[b] + tile_info[b, 0] <= INT32_MAX
        i0 = s * m + t * TAIL_TILE
        v = mb[i0:i0 + min(TAIL_TILE, m - t * TAIL_TILE)]
        incl = np.cumsum(v)
        assert incl.max() + 31 <= INT32_MAX
        offs[i0:i0 + len(v)] = (bases[b] & 31) + incl - v
    return bases, offs


def _tail_model(blocks, hdr, is_p, n_words, fmt, per_row, order):
    """The two launches: the headers (with the zero fill), then the
    placement of the tiles in the given order. A tile's words are built in
    a buffer of its worst case: a warp per MB, lane l taking positions l,
    l + 32, ... of each of the seven pieces, the word before a lane's
    from lane l - 1 (lane 0: lane 31 of the round before); position q of a
    piece at o = 32 T + r makes word T + q, its word q >> r ored with its
    word q - 1 << (32 - r), stored if the word lies inside the piece's bits
    and ored otherwise; words past the buffer dropped. The tile leaves as
    stores, but its first and last words ored where a neighbour shares
    them; words past cap dropped. Asserts that every word stored has one
    writer. Returns (words [n_strings, cap] int32, totals, mb_bits, ovf,
    the header model's outputs)."""
    (yw, yb), (cbw, cbb), (crw, crb) = blocks
    *lead, nby, nbx = np.asarray(hdr[0]).shape
    w = yw.shape[-1]
    n_lead = int(np.prod(lead))
    n_strings, m = (n_lead * nby, nbx) if per_row else (n_lead, nby * nbx)
    heads = _tail_headers_model((yb, cbb, crb), hdr, is_p, n_strings, m, nbx,
                                w, fmt)
    hw, mb, _, tile_info = heads
    bases, offs = _tail_scan_model(mb, tile_info, n_strings, m)
    tps = -(-m // TAIL_TILE)
    srcs = [np.asarray(a).reshape(-1, a.shape[-1]).view(np.uint32)
            for a in (yw, cbw, crw)]
    nbits = [np.asarray(a).reshape(-1).astype(np.int64) for a in (yb, cbb, crb)]
    buf_words = TAIL_TILE * (2 + 6 * w) + 2
    cap = n_words
    out = np.zeros((n_strings, cap), np.uint64)       # the zero fill
    writers = [[set() for _ in range(cap)] for _ in range(n_strings)]
    stored_by = -np.ones((n_strings, cap), np.int64)
    totals = np.zeros(n_strings, np.int64)
    ovf = False
    lanes = np.arange(32)
    for b in order:
        s, t = divmod(b, tps)
        base, tile_sum = int(bases[b]), int(tile_info[b, 0])
        r0 = base & 31
        span = r0 + tile_sum
        nw = (span + 31) >> 5
        clipped = nw > buf_words
        nw = min(nw, buf_words)
        buf = np.zeros(nw, np.uint64)
        stored = np.zeros(nw, np.int64)
        ored = np.zeros(nw, bool)
        i0 = s * m + t * TAIL_TILE
        for i in range(i0, i0 + min(TAIL_TILE, m - t * TAIL_TILE)):
            row, c = divmod(i, nbx)
            y0 = 2 * row * 2 * nbx + 2 * c
            yo = [y0, y0 + 1, y0 + 2 * nbx, y0 + 2 * nbx + 1]
            pieces = ([hw[i]] + [srcs[0][k] for k in yo] + [srcs[1][i], srcs[2][i]])
            pb = [nbits[0][k] for k in yo] + [nbits[1][i], nbits[2][i]]
            pb = [int(mb[i]) - sum(pb)] + [int(x) for x in pb]
            off = list(int(offs[i]) + np.cumsum([0] + pb[:-1]))
            used = [min((x + 31) >> 5, len(p)) for x, p in zip(pb, pieces)]
            carry = [0] * 7
            for q0 in range(0, max(used) + 1, 32):
                q = q0 + lanes
                for p in range(7):
                    cur = np.zeros(q0 + 32, np.uint64)   # a lane's load of word q
                    cur[:used[p]] = pieces[p][:used[p]]
                    cur = cur[q]
                    prev = np.r_[carry[p], cur[:-1]]
                    carry[p] = int(cur[31])
                    r = off[p] & 31
                    for lane in range(32):
                        ql = int(q[lane])
                        if pb[p] == 0 or ql > used[p] or (ql == used[p] and r == 0):
                            continue
                        word = int(cur[lane]) if r == 0 else (
                            ((int(prev[lane]) << (32 - r)) | (int(cur[lane]) >> r)) & MASK32)
                        tw = (off[p] >> 5) + ql
                        if tw >= nw:
                            continue
                        if 32 * tw >= off[p] and 32 * tw + 32 <= off[p] + pb[p]:
                            buf[tw] = word
                            stored[tw] += 1
                        elif word:
                            buf[tw] |= np.uint64(word)
                            ored[tw] = True
        assert stored.max(initial=0) <= 1 and not (ored & (stored > 0)).any()
        head = r0 != 0 or clipped
        tail = (span & 31) != 0 or clipped
        for k in range(nw):
            g = (base >> 5) + k
            if g >= cap:
                break
            writers[s][g].add(b)
            if (k == 0 and head) or (k == nw - 1 and tail) or clipped:
                out[s, g] |= buf[k]
            else:
                stored_by[s, g] = b
                out[s, g] = buf[k]
        ovf |= bool(tile_info[b, 1])
        if t == tps - 1:
            totals[s] = base + tile_sum
            ovf |= totals[s] > 32 * cap
    for s in range(n_strings):
        for g in np.nonzero(stored_by[s] >= 0)[0]:
            assert writers[s][g] == {stored_by[s, g]}
    shape = (*lead, nby) if per_row else tuple(lead)
    words = out.astype(np.uint32).view(np.int32).reshape(*shape, cap)
    return (words, totals.reshape(shape), mb.reshape(*lead, nby, nbx), ovf,
            heads)


def _tail_case(rng, lead, nby, nbx, fmt, is_p, dense=False):
    """Levels of the three planes (sparse, or dense at the largest level
    where `dense`) and the MB arrays of a frame: qp deltas in -2..2 and a
    few extremes, vectors within +-16 (+-32 half-pels in format 4) whose
    neighbours are often inter, all intra in an I frame."""
    def lv(shape):
        p = 0.9 if dense else rng.choice([0.01, 0.04, 0.1])
        v = rng.integers(-40, 41, shape) * (rng.random(shape) < p)
        if dense:
            v = np.where(rng.random(shape) < 0.5, 3925, -3925)
        return _t(v)

    mbs = (*lead, nby, nbx)
    levels = (lv((*lead, 2 * nby, 2 * nbx, 64)), lv((*mbs, 64)), lv((*mbs, 64)))
    qpd = rng.integers(-2, 3, mbs)
    qpd.reshape(-1)[:3] = (-26, 26, 0)
    r = 32 if fmt >= 4 else 16
    inter = (rng.random(mbs) < 0.8) if is_p else np.zeros(mbs, bool)
    dy, dx = (np.where(inter, rng.integers(-r, r + 1, mbs), 0) for _ in range(2))
    hdr = (_t(qpd), torch.from_numpy(inter), _t(dy), _t(dx))
    return levels, hdr


@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("fmt", [1, 2, 4])
def test_frame_tail_model(rng, fmt, lead, is_p):
    """The two launches' model equals the plain pack_frame_planes (words,
    total bits, MB totals, flag), the plain chunk headers (entropy.
    mb_headers: the header words and piece counts that _mb_sources gives
    the merges) and frame_mb_bits, on frames of 3 x 40 MBs (four tiles a
    string) in both syntaxes, G = 1 and 4, I and P frames; the tiles
    placed in a random order."""
    nby, nbx, bw = 3, 40, 16
    levels, hdr = _tail_case(rng, lead, nby, nbx, fmt, is_p)
    cap = entropy.capacity_words(nby * nbx)
    blocks = entropy._plane_blocks(*levels, bw, fmt)
    n_tiles = int(np.prod(lead)) * -(-nby * nbx // TAIL_TILE)
    words, totals, mb, ovf, (hw, _, pbits, _) = _tail_model(
        blocks, hdr, is_p, cap, fmt, False, rng.permutation(n_tiles))
    qpd, inter, dy, dx = hdr
    gw, gbits, gmb, govf = entropy.pack_frame_planes(
        *levels, qpd, is_p, inter, dy, dx, bw, cap, fmt=fmt)
    assert np.array_equal(words, gw.numpy()) and np.array_equal(totals, gbits.numpy())
    assert np.array_equal(mb, gmb.numpy()) and not ovf and not bool(govf)
    phw, ppb, pmb, povf = entropy.mb_headers(
        tuple(b for _, b in blocks), hdr, is_p, bw, fmt)
    assert np.array_equal(hw, phw.reshape(-1, 2).numpy().view(np.uint32))
    assert np.array_equal(pbits, ppb.reshape(-1, 8).numpy())
    (sw, *_), sbits, _ = entropy._mb_sources(*levels, qpd, is_p, inter, dy, dx,
                                             bw, fmt)
    assert np.array_equal(hw, sw.reshape(-1, 2).numpy().view(np.uint32))
    assert np.array_equal(pbits[:, :7], sbits.reshape(-1, 7).numpy())
    est = entropy.frame_mb_bits(*levels, qpd, is_p, inter, dy, dx, bw, fmt)
    assert np.array_equal(mb, est.numpy())
    assert (mb > 0).all() and (pbits[:, 0] > 0).all()


@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_frame_tail_model_rows(rng, lead, is_p):
    """One string per MB row (pack_frame_rows, the 2-D grid's strings):
    rows of 40 MBs, two tiles each, equal to the plain row strings, the
    rows' bits and the flag."""
    nby, nbx, bw = 3, 40, 16
    levels, hdr = _tail_case(rng, lead, nby, nbx, 1, is_p)
    row_words = entropy.capacity_words(nbx)
    blocks = entropy._plane_blocks(*levels, bw)
    n_tiles = int(np.prod(lead)) * nby * -(-nbx // TAIL_TILE)
    words, totals, mb, ovf, _ = _tail_model(
        blocks, hdr, is_p, row_words, 1, True, rng.permutation(n_tiles))
    qpd, inter, dy, dx = hdr
    gw, gbits, gmb, govf = entropy.pack_frame_rows(
        *levels, qpd, is_p, inter, dy, dx, bw, row_words)
    assert np.array_equal(words, gw.numpy()) and np.array_equal(totals, gbits.numpy())
    assert np.array_equal(mb, gmb.numpy()) and not ovf and not bool(govf)


@pytest.mark.parametrize("case", ["block", "cap", "cap_rows"])
def test_frame_tail_model_overflow(rng, case):
    """A block over its budget (dense levels at |level| 3925 and 2 words a
    block): the flag, the untruncated totals and MB totals equal the plain
    version's, and the model's placement stays inside each tile's buffer
    and the string; a frame (or a row) over cap with every block inside its
    budget: the flag, the totals, and the words up to cap (the plain
    version drops the rest too), at G = 4 (two rows of G = 2)."""
    nby, nbx = 3, 40
    per_row = case == "cap_rows"
    lead = (2,) if per_row else (4,)
    dense = case == "block"
    bw = 2 if dense else 16
    levels, hdr = _tail_case(rng, lead, nby, nbx, 2 if case == "cap" else 1,
                             True, dense)
    fmt = 2 if case == "cap" else 1
    blocks = entropy._plane_blocks(*levels, bw, fmt)
    plain = entropy.assemble(blocks, hdr, True, 10_000, fmt, per_row)
    n_words = 10_000 if dense else int(plain[1].max()) // 32 - 3
    want = entropy.assemble(blocks, hdr, True, n_words, fmt, per_row)
    strings = int(np.prod(lead)) * (nby if per_row else 1)
    n_tiles = strings * -(-(nbx if per_row else nby * nbx) // TAIL_TILE)
    words, totals, mb, ovf, _ = _tail_model(
        blocks, hdr, True, n_words, fmt, per_row, rng.permutation(n_tiles))
    assert ovf and bool(want[3])
    assert np.array_equal(totals, want[1].numpy()) and np.array_equal(mb, want[2].numpy())
    over_blocks = any(bool((b > 32 * bw).any()) for _, b in blocks)
    assert over_blocks == dense
    if not dense:
        assert np.array_equal(words, want[0].numpy())
        assert (totals > 32 * n_words).any() and not (totals > 32 * n_words).all()


def test_frame_tail_int32_scan_bound():
    """The scan is int32: a string's bits stay below 2^31. An MB takes at
    most a header of 46 bits (mode 3, two vector differences of 15 at
    format 4's +-64 half-pels, a qp delta of 13) and six blocks of at most
    1 + 13 + 64 * 38 bits (entropy.MAX_MB_BITS's blocks), under the
    wrappers' MB_BITS_BOUND; the plain header and block symbols at their
    extremes stay inside those. So a 1080p frame (8160 MBs) holds under
    1.2e8 bits, and the largest string the wrappers take (MAX_STRING_MBS)
    under 2^31: the scan model of the placement at that bound, one 1080p
    frame and four in lockstep, and the largest string, keeps every
    partial sum an int32."""
    from video_encoder_tpu_torch.ops.kernels import assemble as kasm

    header_max = 3 + 2 * 15 + 13
    block_max = 1 + 13 + 64 * (13 + 25)
    assert entropy.MAX_MB_BITS - (3 + 22 + 13) == 6 * block_max
    assert header_max + 6 * block_max <= kasm.MB_BITS_BOUND
    assert 8160 * kasm.MB_BITS_BOUND < 2**31 // 16
    assert kasm.MAX_STRING_MBS * kasm.MB_BITS_BOUND <= INT32_MAX
    # the plain symbols at their extremes: vectors +-32 half-pels against
    # a left neighbour at -+32, qp deltas +-63; dense blocks at 3925
    qpd = _t([[-63, 63, -63]])
    inter = torch.ones((1, 3), dtype=torch.bool)
    dv = _t([[32, -32, 32]])
    _, hl = entropy._header_slots(qpd, True, inter, dv, dv, 4)
    assert int(hl.sum(0).max()) <= header_max
    _, hl = entropy._header_slots(qpd, False, ~inter, dv, dv, 1)
    assert int(hl.sum(0).max()) <= header_max
    dense = _t(np.where(np.arange(64) % 2, 3925, -3925)[None].repeat(2, 0))
    for fmt in (1, 2):
        _, bits = kpack.plain_block_pack(dense, entropy.BLOCK_WORDS_MAX,
                                         _t([-3925, 3925]), fmt)
        assert int(bits.max()) <= block_max
    for n_strings, m in ((1, 8160), (4, 8160), (1, kasm.MAX_STRING_MBS)):
        mb = np.full(n_strings * m, kasm.MB_BITS_BOUND - 1, np.int64)
        tps = -(-m // TAIL_TILE)
        tile_info = np.zeros((n_strings * tps, 2), np.int64)
        for b in range(n_strings * tps):
            s, t = divmod(b, tps)
            tile_info[b, 0] = mb[s * m + t * TAIL_TILE:
                                 s * m + min((t + 1) * TAIL_TILE, m)].sum()
        bases, offs = _tail_scan_model(mb, tile_info, n_strings, m)
        assert bases.max() + tile_info[:, 0].max() <= INT32_MAX
        assert offs.max() < 2**31
