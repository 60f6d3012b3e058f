"""The arithmetic of the Hopper designs of code_plane (csrc/code_plane.cu),
block_pack (csrc/block_pack.cu), the SAD maps (csrc/full_search.cu) and
sad_at_mv (csrc/sad_at.cu), modelled in plain torch and numpy on the CPU
and held against the port's plain versions, which the other test files tie
to the JAX reference, and here also against the reference's quotient and
its Pallas block_pack, sad_map, sad_map_even and sad_at_mv in interpret
mode. The kernels themselves run only on the card
(tests/test_torch_kernels.py). Tolerance 0: the codec is integer-only.

The models follow the kernels step by step: the even/odd 8-point passes
with every partial sum checked against int32, the reciprocal-and-fix-up
quotient in f32, the arithmetic zigzag position and quant matrix, the row
scan's per-block-column chains, and block_pack's warp placement (two
ballot words, the previous set bit, a packed exclusive scan of the pair
lengths, symbols ORed into the block's words, truncation); the maps'
thread-to-candidate mapping (groups of lanes, runs of candidates, window
strips, the even map's words of four pixels and their vabsdiff4, the
xor-shuffle sums, the shared row's stores); sad_at_mv's warp
per block for all K candidates (the lanes' pixels, the coordinate clamp in
the reference's own extents, the xor-shuffle sums, each plane's union of
footprints).
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
