// Fused residual -> ITX8 -> quantize -> dequantize -> inverse ITX8 -> recon
// of whole planes, with the levels written in zigzag order; and the
// format-3/4 I-frame row scan of a whole plane in one launch. Two
// recon-only entries serve the decoders (see "The decoders" below).
//
// Replaces: video_encoder_tpu/ops/pallas/codec.py, _make_code_plane_kernel
// (launched by _code_plane_call, public code_plane), plus the zigzag that
// the reference's dispatch.code_plane applies after it; and
// _code_plane_call_g, the vmap rule of code_plane on cur, pred [G, H, W]
// and q_blk [G, H/8, W/8] of G GOPs in lockstep. The TPU needed the twin
// because vmap could not batch the kernel's broadcast constants; here the
// GOP is a leading plane index (the single-plane entry passes G = 1). The
// row scan (tvc_code_plane_rows) replaces the reference's lax.scan over
// [8, W] stripes in video_encoder_tpu/ops/transform.py
// intra_rows_code_plane, which has no Pallas kernel of its own.
//
// Bound on this card: device memory. Per pixel the function reads cur and
// pred and writes a level and a recon value (16 bytes); a 1088x1920 plane
// is 33.4 MB, 0.0100 ms at 3.35 TB/s, against about 60 integer operations
// per pixel (0.004 ms at the int32 rate).
//
// Design. Eight threads code one 8x8 block, thread r owning pixel row r,
// four blocks per warp (consecutive blocks of a block row). A thread loads
// its cur and pred rows as two 16-byte loads each and stores its recon row
// the same way. The four 8-point passes (B x, then . B^T forward; B^T .,
// then . B inverse) run in registers with the basis as immediates, in the
// even/odd form of fwd8/inv8 (8 + 4 + 16 multiplies in place of 64). Each
// pass works on a column or a row; between passes the block goes through
// a warp-private shared tile (pitch 9 words, so that writing rows and
// reading columns are both free of bank conflicts) under __syncwarp: no
// __syncthreads and no __constant__ table indexed by thread. The zigzag
// position and the quant matrix (16 + 2 (r + c), SPEC.md §13.2) are
// arithmetic. Levels are staged in zigzag order in a per-block 64-word
// shared buffer and leave as the block's contiguous 256 bytes, 16-byte
// stores.
//
// int32 bounds. Regrouping the sums (s_j = x_j + x_{7-j}, and so on) is
// exact in integers; every partial sum of fwd8/inv8 is a sub-sum of
// sum_j |B[k][j]| |x_j| <= 2705 max|x_j|, so each stays within the bound of
// the full sum. The largest inputs are the inverse's second pass: |deq| <=
// |coef| + q/2 <= 2040 + 1991, |u1r| <= 10650, |u2| <= 2.9e7 < 2^31.
//
// Quantization is the exact floor (16|c| + bias*q) / (16q), bias 8 at DC,
// q scaled to max(1, (q * QMAT + 8) >> 4) under the quant matrix; see
// quant_mag for the division without an integer divide.
//
// The row scan. Block row j of a format-3/4 I frame predicts every pixel
// from the recon's last pixel row of block row j - 1 in the same block
// column (128 at j = 0 and at every reset_rows-th row; SPEC.md §13.1,
// §13.3), so each (plane, block column, slice) is a chain of its own. One
// warp walks four adjacent chains down their slice with the same
// code_block as the whole-plane kernel; the pred row comes from lane 7 of
// each block's group by shuffles, and the next block's cur row is loaded
// while this one is coded. A 1088x1920 luma plane is 240 chains of 136
// steps: latency per step, not bandwidth, sets its time, so each warp is
// a thread block of its own and lands on an SM of its own.
//
// The decoders. tvc_recon_plane is the inter recon of a plane (dequantize,
// inverse ITX8, add the predictor or a flat 128, clip) and
// tvc_recon_plane_rows the format-3/4 I-frame recon, rows_kernel's chains
// without the forward half. Neither has a Pallas counterpart: they replace
// the reference decoders' jnp recon, recon_plane in _decode_gop_jit and
// DeviceDecodeEngine._recon (video_encoder_tpu/pipeline/decoder.py:180,
// :115-122), and transform.intra_rows_recon_plane (ops/transform.py:148),
// a lax.scan over [8, W] stripes. Bound: device memory; per pixel the
// inter recon reads 2 bytes of int16 levels and 4 of pred and writes 4 of
// recon and 1 of the output byte plane (11 bytes, a 1088x1920 plane 23 MB,
// 0.0069 ms at 3.35 TB/s) against about 40 integer operations. The levels
// arrive in zigzag order as the parser writes them; a thread stages its
// eight with one 16-byte load and reads its column of the raster block
// from the stage, so the inverse starts on columns and takes one
// transpose. The row recon's time is its 136 dependent steps' latency, as
// the row scan's is. Levels come from a stream, not from this codec's
// quantizer, so the encoder's int32 bounds above do not hold: see
// recon_block.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;                // warps per block, whole-plane kernel
constexpr int PITCH = 9;                // words per row of a transpose tile
constexpr int TILE = 8 * PITCH;         // one 8x8 block's transpose tile

__device__ __forceinline__ int rshift_round(int v) {
  const int mag = (abs(v) + 512) >> 10;  // TX_SHIFT = 10
  return v < 0 ? -mag : mag;
}

// The odd half of the basis, M[k][j] = B[2k + 1][j] for j < 4; M is
// symmetric, so the forward and the inverse odd parts are the same. T is
// int on the encoder's range, unsigned for the decoders (see recon_block).
template <typename T>
__device__ __forceinline__ void odd4(T a, T b, T c, T d, T& o0, T& o1, T& o2,
                                     T& o3) {
  o0 = 502 * a + 426 * b + 284 * c + 100 * d;
  o1 = 426 * a - 100 * b - 502 * c - 284 * d;
  o2 = 284 * a - 502 * b + 100 * c + 426 * d;
  o3 = 100 * a - 284 * b + 426 * c - 502 * d;
}

// y[k] = sum_j B[k][j] x[j]: B applied to a column (t1 = B x) or B^T to a
// row (coef = t1 B^T). Even rows of B are symmetric, odd rows antisymmetric.
__device__ __forceinline__ void fwd8(const int (&x)[8], int (&y)[8]) {
  const int s0 = x[0] + x[7], s1 = x[1] + x[6], s2 = x[2] + x[5],
            s3 = x[3] + x[4];
  const int ss0 = s0 + s3, ss1 = s1 + s2, sd0 = s0 - s3, sd1 = s1 - s2;
  y[0] = 362 * (ss0 + ss1);
  y[4] = 362 * (ss0 - ss1);
  y[2] = 473 * sd0 + 196 * sd1;
  y[6] = 196 * sd0 - 473 * sd1;
  odd4(x[0] - x[7], x[1] - x[6], x[2] - x[5], x[3] - x[4], y[1], y[3], y[5],
       y[7]);
}

// y[i] = sum_j B[j][i] x[j]: B^T applied to a column (u1 = B^T deq) or B to
// a row (u2 = u1 B).
template <typename T>
__device__ __forceinline__ void inv8(const T (&x)[8], T (&y)[8]) {
  const T a = 362 * (x[0] + x[4]), b = 362 * (x[0] - x[4]);
  const T c = 473 * x[2] + 196 * x[6], d = 196 * x[2] - 473 * x[6];
  const T e0 = a + c, e1 = b + d, e2 = b - d, e3 = a - c;
  T o0, o1, o2, o3;
  odd4(x[1], x[3], x[5], x[7], o0, o1, o2, o3);
  y[0] = e0 + o0;
  y[7] = e0 - o0;
  y[1] = e1 + o1;
  y[6] = e1 - o1;
  y[2] = e2 + o2;
  y[5] = e2 - o2;
  y[3] = e3 + o3;
  y[4] = e3 - o3;
}

// Zigzag scan position of raster (r, c) (codec/spec.py UNZIGZAG): the
// anti-diagonal s = r + c starts at s (s + 1) / 2 and runs down (r rising)
// when s is odd, up (c rising) when even; the second half mirrors the
// first, pos(r, c) = 63 - pos(7 - r, 7 - c).
__device__ __forceinline__ int zz_pos(int r, int c) {
  const int s = r + c;
  const bool lo = s < 8;
  const int rr = lo ? r : 7 - r, cc = lo ? c : 7 - c, ss = lo ? s : 14 - s;
  const int p = (ss * (ss + 1) >> 1) + ((ss & 1) ? rr : cc);
  return lo ? p : 63 - p;
}

// floor(n / d) for n = 16|c| + bias q and d = 16 q, with rd the f32
// reciprocal of d rounded to nearest (__frcp_rn). n <= 16 * 3925 + 8 * 3982
// < 2^17 and d <= 63712 are exact in f32. The rounded reciprocal and the
// rounded product are each within 2^-24 relative, so p = fl(n * rd) is
// within (n / d) 2^-22.9 < 2^17 * 2^-22.9 < 1/29 of n / d: its truncation
// m is floor(n / d) or one off either way, and one step of each fix-up
// makes it exact ((m + 1) d <= n + 2d < 2^18: no overflow). The CPU tests
// hold it exhaustively over every step and |c| <= 3925.
__device__ __forceinline__ int quant_mag(int n, int d, float rd) {
  int m = __float2int_rz(__fmul_rn(__int2float_rn(n), rd));
  m += (m + 1) * d <= n;
  m -= m * d > n;
  return m;
}

// t[r][k] = v[k], then v[k] = t[k][r]: thread r's row becomes column r.
__device__ __forceinline__ void transpose8(int* t, int r, int (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) t[r * PITCH + k] = v[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = t[k * PITCH + r];
  __syncwarp();
}

// One 8x8 block by its eight threads; thread r holds row r of cur and pred
// and gets row r of the clipped recon in rec. t: the block's transpose
// tile; z: its 64-word zigzag stage (16-byte aligned); lv: the block's 64
// levels in global memory, or null for a block past the plane's edge
// (whose threads still take part in every __syncwarp).
template <bool QMAT>
__device__ __forceinline__ void code_block(int* t, int* z, int r,
                                           const int (&cur)[8],
                                           const int (&pred)[8], int q,
                                           int qbias, int* lv,
                                           int (&rec)[8]) {
  int v[8], y[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = cur[k] - pred[k];
  transpose8(t, r, v);              // column r of the residual x
  fwd8(v, y);                       // t1[.][r] = B x[.][r]
#pragma unroll
  for (int k = 0; k < 8; ++k) y[k] = rshift_round(y[k]);
  transpose8(t, r, y);              // row r of t1r
  fwd8(y, v);                       // coef[r][.] = t1r[r][.] B^T

  const float rq = QMAT ? 0.f : __frcp_rn(__int2float_rn(16 * q));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = rshift_round(v[k]);
    const int qk = QMAT ? max(1, (q * (16 + 2 * (r + k)) + 8) >> 4) : q;
    const int bias = (k == 0 && r == 0) ? 8 : qbias;
    const int d = 16 * qk;
    const int mag = quant_mag(16 * abs(c) + bias * qk, d,
                              QMAT ? __frcp_rn(__int2float_rn(d)) : rq);
    const int level = c < 0 ? -mag : mag;
    z[zz_pos(r, k)] = level;
    v[k] = level * qk;              // dequantized, row r
  }
  __syncwarp();
  if (lv != nullptr) {              // zigzag positions 8r .. 8r + 7
    const int4* zs = reinterpret_cast<const int4*>(z + 8 * r);
    int4* out = reinterpret_cast<int4*>(lv + 8 * r);
    out[0] = zs[0];
    out[1] = zs[1];
  }
  transpose8(t, r, v);              // column r of deq
  inv8(v, y);                       // u1[.][r] = B^T deq[.][r]
#pragma unroll
  for (int k = 0; k < 8; ++k) y[k] = rshift_round(y[k]);
  transpose8(t, r, y);              // row r of u1r
  inv8(y, v);                       // u2[r][.] = u1r[r][.] B
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rec[k] = min(max(rshift_round(v[k]) + pred[k], 0), 255);
}

__device__ __forceinline__ void load_row(const int* p, int (&v)[8]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0];
  const int4 b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store_row(int* p, const int (&v)[8]) {
  reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// Whole planes: one warp per four blocks of a block row, warps numbered
// over (g, block row, group of four block columns).
template <bool QMAT>
__global__ void __launch_bounds__(32 * WARPS)
plane_kernel(const int* __restrict__ cur, const int* __restrict__ pred,
             const int* __restrict__ q_blk, int g, int h, int w, int qbias,
             int* __restrict__ levels, int* __restrict__ rec) {
  __shared__ __align__(16) int s_t[WARPS][4 * TILE];
  __shared__ __align__(16) int s_z[WARPS][4 * 64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane >> 3, r = lane & 7;
  const int nbx = w >> 3, nby = h >> 3, ngx = (nbx + 3) >> 2;
  const long long gid = (long long)blockIdx.x * WARPS + warp;
  if (gid >= (long long)g * nby * ngx) return;  // uniform over the warp
  const int gx = (int)(gid % ngx);
  const long long rest = gid / ngx;
  const int by = (int)(rest % nby);
  const long long gg = rest / nby;
  const int bx = gx * 4 + sub;
  const bool active = bx < nbx;   // a row's last group may be ragged
  const size_t o = ((size_t)gg * h + by * 8 + r) * w + (size_t)bx * 8;
  const size_t blk = ((size_t)gg * nby + by) * nbx + bx;

  int c[8] = {0, 0, 0, 0, 0, 0, 0, 0}, p[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int q = 1;
  if (active) {
    load_row(cur + o, c);
    load_row(pred + o, p);
    q = q_blk[blk];
  }
  int out[8];
  code_block<QMAT>(s_t[warp] + sub * TILE, s_z[warp] + sub * 64, r, c, p, q,
                   qbias, active ? levels + blk * 64 : nullptr, out);
  if (active) store_row(rec + o, out);
}

// The I-frame row scan: one warp (one thread block) per four adjacent
// chains of one plane and slice, walking the slice's block rows in order.
template <bool QMAT>
__global__ void __launch_bounds__(32)
rows_kernel(const int* __restrict__ cur, const int* __restrict__ q_blk,
            int h, int w, int qbias, int span, int n_slices,
            int* __restrict__ levels, int* __restrict__ rec) {
  __shared__ __align__(16) int s_t[4 * TILE];
  __shared__ __align__(16) int s_z[4 * 64];
  const int lane = threadIdx.x, sub = lane >> 3, r = lane & 7;
  const int nbx = w >> 3, nby = h >> 3, ngx = (nbx + 3) >> 2;
  const long long gid = blockIdx.x;
  const int gx = (int)(gid % ngx);
  const long long rest = gid / ngx;
  const int sl = (int)(rest % n_slices);
  const long long gg = rest / n_slices;
  const int bx = gx * 4 + sub;
  const bool active = bx < nbx;
  const int j0 = sl * span, j1 = min(j0 + span, nby);
  const size_t plane = (size_t)gg * h * w, qplane = (size_t)gg * nby * nbx;

  int pred[8] = {128, 128, 128, 128, 128, 128, 128, 128};
  int nxt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int nq = 1;
  if (active) {
    load_row(cur + plane + (size_t)(j0 * 8 + r) * w + bx * 8, nxt);
    nq = q_blk[qplane + (size_t)j0 * nbx + bx];
  }
  for (int j = j0; j < j1; ++j) {
    int c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = nxt[k];
    const int q = nq;
    const size_t o = plane + (size_t)(j * 8 + r) * w + bx * 8;
    const size_t blk = qplane + (size_t)j * nbx + bx;
    if (active && j + 1 < j1) {     // the next block's row, in flight
      load_row(cur + o + 8 * (size_t)w, nxt);
      nq = q_blk[blk + nbx];
    }
    int out[8];
    code_block<QMAT>(s_t + sub * TILE, s_z + sub * 64, r, c, pred, q, qbias,
                     active ? levels + blk * 64 : nullptr, out);
    if (active) store_row(rec + o, out);
#pragma unroll
    for (int k = 0; k < 8; ++k)     // row 7 of the recon predicts row j + 1
      pred[k] = __shfl_sync(FULL, out[k], (lane & ~7) | 7);
  }
}

// ---- The decoders: recon only ----

// rshift_round of a 32-bit value held mod 2^32, as int32 tensors compute
// it: |v| wraps at INT_MIN, |v| + 512 wraps past INT_MAX, and the shift
// is arithmetic. On the encoder's range it is rshift_round.
__device__ __forceinline__ int rshift_round_wrap(unsigned v) {
  const bool neg = (int)v < 0;
  const int mag = (int)((neg ? 0u - v : v) + 512u) >> 10;
  return neg ? -mag : mag;
}

// Row r of a block's 64 zigzag levels (int16, positions 8r .. 8r + 7),
// one 16-byte load; a block past the plane's edge has zeros.
__device__ __forceinline__ int4 load_levels(const short* lv, int r,
                                            bool active) {
  return active ? *reinterpret_cast<const int4*>(lv + 8 * r)
                : make_int4(0, 0, 0, 0);
}

// Those eight levels, sign-extended, into the block's 64-word zigzag
// stage z.
__device__ __forceinline__ void stage_levels(int4 a, int* z, int r) {
  const int w[4] = {a.x, a.y, a.z, a.w};
  int v[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {        // little-endian: low half first
    v[2 * k] = (int)(short)(w[k] & 0xffff);
    v[2 * k + 1] = w[k] >> 16;
  }
  int4* zs = reinterpret_cast<int4*>(z + 8 * r);
  zs[0] = make_int4(v[0], v[1], v[2], v[3]);
  zs[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// One 8x8 block's recon by its eight threads, after its levels are staged
// in z (and a __syncwarp): thread r gets row r of clip(inverse(deq) +
// pred), deq = level * q per position. Thread r reads column r of deq
// straight from the zigzag stage, so the inverse needs one transpose.
// Levels come from a parser, not from this codec's quantizer: |level| is
// up to 32768 and the sums leave int32. The reference wraps them (jnp
// int32), so the multiplies and sums run in unsigned arithmetic, whose
// wrap is defined and exact mod 2^32 under the even/odd regrouping, and
// only the rounding shifts read the value as signed.
template <bool QMAT>
__device__ __forceinline__ void recon_block(int* t, const int* z, int r,
                                            int q, const int (&pred)[8],
                                            int (&rec)[8]) {
  unsigned v[8], y[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {     // deq[k][r]
    const int qk = QMAT ? max(1, (q * (16 + 2 * (k + r)) + 8) >> 4) : q;
    v[k] = (unsigned)z[zz_pos(k, r)] * (unsigned)qk;
  }
  inv8(v, y);                       // u1[.][r] = B^T deq[.][r]
  int u[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = rshift_round_wrap(y[k]);
  transpose8(t, r, u);              // row r of u1r
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (unsigned)u[k];
  inv8(v, y);                       // u2[r][.] = u1r[r][.] B
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rec[k] = min(max((int)((unsigned)rshift_round_wrap(y[k]) +
                           (unsigned)pred[k]), 0), 255);
}

__device__ __forceinline__ void store_row8(unsigned char* p,
                                           const int (&v)[8]) {
  const unsigned lo = v[0] | v[1] << 8 | v[2] << 16 | (unsigned)v[3] << 24;
  const unsigned hi = v[4] | v[5] << 8 | v[6] << 16 | (unsigned)v[7] << 24;
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// The inter recon of a plane: one warp per four blocks of a block row, as
// plane_kernel; pred null is the flat 128 of an I frame at formats 1-2;
// out8 (may be null) gets the recon as bytes.
template <bool QMAT>
__global__ void __launch_bounds__(32 * WARPS)
recon_kernel(const short* __restrict__ levels, const int* __restrict__ pred,
             const int* __restrict__ q_blk, int h, int w,
             int* __restrict__ rec, unsigned char* __restrict__ out8) {
  __shared__ __align__(16) int s_t[WARPS][4 * TILE];
  __shared__ __align__(16) int s_z[WARPS][4 * 64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane >> 3, r = lane & 7;
  const int nbx = w >> 3, nby = h >> 3, ngx = (nbx + 3) >> 2;
  const long long gid = (long long)blockIdx.x * WARPS + warp;
  if (gid >= (long long)nby * ngx) return;  // uniform over the warp
  const int gx = (int)(gid % ngx), by = (int)(gid / ngx);
  const int bx = gx * 4 + sub;
  const bool active = bx < nbx;
  const size_t o = (size_t)(by * 8 + r) * w + (size_t)bx * 8;
  const size_t blk = (size_t)by * nbx + bx;
  int* z = s_z[warp] + sub * 64;

  int p[8] = {128, 128, 128, 128, 128, 128, 128, 128};
  int q = 1;
  stage_levels(load_levels(levels + blk * 64, r, active), z, r);
  if (active) {
    if (pred != nullptr) load_row(pred + o, p);
    q = q_blk[blk];
  }
  __syncwarp();
  int out[8];
  recon_block<QMAT>(s_t[warp] + sub * TILE, z, r, q, p, out);
  if (active) {
    store_row(rec + o, out);
    if (out8 != nullptr) store_row8(out8 + o, out);
  }
}

// The format-3/4 I-frame recon: rows_kernel's chains (one warp, one thread
// block, per four adjacent block columns of one plane and slice), each step
// recon_block against the recon's last row above, passed down by shuffles;
// the next block's levels and step are loaded while this one is rebuilt.
template <bool QMAT>
__global__ void __launch_bounds__(32)
recon_rows_kernel(const short* __restrict__ levels,
                  const int* __restrict__ q_blk, int h, int w, int span,
                  int n_slices, int* __restrict__ rec,
                  unsigned char* __restrict__ out8) {
  __shared__ __align__(16) int s_t[4 * TILE];
  __shared__ __align__(16) int s_z[4 * 64];
  const int lane = threadIdx.x, sub = lane >> 3, r = lane & 7;
  const int nbx = w >> 3, nby = h >> 3, ngx = (nbx + 3) >> 2;
  const long long gid = blockIdx.x;
  const int gx = (int)(gid % ngx);
  const long long rest = gid / ngx;
  const int sl = (int)(rest % n_slices);
  const long long gg = rest / n_slices;
  const int bx = gx * 4 + sub;
  const bool active = bx < nbx;
  const int j0 = sl * span, j1 = min(j0 + span, nby);
  const size_t plane = (size_t)gg * h * w, qplane = (size_t)gg * nby * nbx;
  int* z = s_z + sub * 64;

  int pred[8] = {128, 128, 128, 128, 128, 128, 128, 128};
  int4 nlv = load_levels(levels + (qplane + (size_t)j0 * nbx + bx) * 64, r,
                         active);
  int nq = active ? q_blk[qplane + (size_t)j0 * nbx + bx] : 1;
  for (int j = j0; j < j1; ++j) {
    const int4 lv = nlv;
    const int q = nq;
    const size_t o = plane + (size_t)(j * 8 + r) * w + bx * 8;
    const size_t blk = qplane + (size_t)j * nbx + bx;
    if (active && j + 1 < j1) {     // the next block's levels, in flight
      nlv = load_levels(levels + (blk + nbx) * 64, r, true);
      nq = q_blk[blk + nbx];
    }
    stage_levels(lv, z, r);
    __syncwarp();
    int out[8];
    recon_block<QMAT>(s_t + sub * TILE, z, r, q, pred, out);
    if (active) {
      store_row(rec + o, out);
      if (out8 != nullptr) store_row8(out8 + o, out);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)     // row 7 of the recon predicts row j + 1
      pred[k] = __shfl_sync(FULL, out[k], (lane & ~7) | 7);
  }
}

// span (block rows per slice) and slice count of a plane of nby block rows
// under reset_rows, as the row scans walk them
void slices_of(int nby, int reset_rows, int& span, int& n_slices) {
  span = reset_rows > 0 && reset_rows < nby ? reset_rows : nby;
  n_slices = (nby + span - 1) / span;
}

int launch_plane(const int* cur, const int* pred, const int* q_blk, int g,
                 int h, int w, int qbias, int qmat, int* levels, int* rec,
                 void* stream) {
  if (g < 1 || h < 8 || w < 8 || h % 8 || w % 8)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)g * (h / 8) * ((w / 8 + 3) / 4);
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (qmat) {
    plane_kernel<true><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        cur, pred, q_blk, g, h, w, qbias, levels, rec);
  } else {
    plane_kernel<false><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        cur, pred, q_blk, g, h, w, qbias, levels, rec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// cur, pred, rec: [h, w] int32 (h, w multiples of 8, 16-byte aligned);
// q_blk: [h/8, w/8] int32; levels: [h/8, w/8, 64] int32 in zigzag order;
// qmat != 0 applies the v3 quant matrix.
extern "C" int tvc_code_plane(const int* cur, const int* pred,
                              const int* q_blk, int h, int w, int qbias,
                              int qmat, int* levels, int* rec, void* stream) {
  return launch_plane(cur, pred, q_blk, 1, h, w, qbias, qmat, levels, rec,
                      stream);
}

// The G-batched form: cur, pred, rec [g, h, w]; q_blk [g, h/8, w/8];
// levels [g, h/8, w/8, 64]; plane g is coded at its own steps.
extern "C" int tvc_code_plane_g(const int* cur, const int* pred,
                                const int* q_blk, int g, int h, int w,
                                int qbias, int qmat, int* levels, int* rec,
                                void* stream) {
  return launch_plane(cur, pred, q_blk, g, h, w, qbias, qmat, levels, rec,
                      stream);
}

// The I-frame row scan of b planes: cur, rec [b, h, w]; q_blk [b, h/8,
// w/8]; levels [b, h/8, w/8, 64]. Block row j predicts from the recon's
// last pixel row above it, 128 at j = 0 and, with reset_rows > 0, at every
// reset_rows-th block row.
extern "C" int tvc_code_plane_rows(const int* cur, const int* q_blk, int b,
                                   int h, int w, int qbias, int qmat,
                                   int reset_rows, int* levels, int* rec,
                                   void* stream) {
  if (b < 1 || h < 8 || w < 8 || h % 8 || w % 8 || reset_rows < 0)
    return (int)cudaErrorInvalidValue;
  int span, n_slices;
  slices_of(h / 8, reset_rows, span, n_slices);
  const long long blocks = (long long)b * n_slices * ((w / 8 + 3) / 4);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (qmat) {
    rows_kernel<true><<<(unsigned)blocks, 32, 0, s>>>(
        cur, q_blk, h, w, qbias, span, n_slices, levels, rec);
  } else {
    rows_kernel<false><<<(unsigned)blocks, 32, 0, s>>>(
        cur, q_blk, h, w, qbias, span, n_slices, levels, rec);
  }
  return (int)cudaGetLastError();
}

// The decoders' inter recon of one plane: levels [h/8, w/8, 64] int16 in
// zigzag order; pred [h, w] int32, or null for a flat 128; q_blk [h/8, w/8]
// int32 steps, scaled per position by the v3 quant matrix when qmat; rec
// [h, w] int32 gets clip(inverse(deq) + pred, 0, 255), and out8 [h, w]
// uint8, unless null, the same values. Every pointer 16-byte aligned.
extern "C" int tvc_recon_plane(const short* levels, const int* pred,
                               const int* q_blk, int h, int w, int qmat,
                               int* rec, unsigned char* out8, void* stream) {
  if (h < 8 || w < 8 || h % 8 || w % 8) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)(h / 8) * ((w / 8 + 3) / 4);
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (qmat) {
    recon_kernel<true><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        levels, pred, q_blk, h, w, rec, out8);
  } else {
    recon_kernel<false><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(
        levels, pred, q_blk, h, w, rec, out8);
  }
  return (int)cudaGetLastError();
}

// The format-3/4 I-frame recon of b planes: levels [b, h/8, w/8, 64] int16
// in zigzag order, q_blk [b, h/8, w/8], rec [b, h, w] int32 and out8 [b,
// h, w] uint8 (or null). Block row j predicts from the recon's last pixel
// row above it, 128 at j = 0 and, with reset_rows > 0, at every
// reset_rows-th block row.
extern "C" int tvc_recon_plane_rows(const short* levels, const int* q_blk,
                                    int b, int h, int w, int qmat,
                                    int reset_rows, int* rec,
                                    unsigned char* out8, void* stream) {
  if (b < 1 || h < 8 || w < 8 || h % 8 || w % 8 || reset_rows < 0)
    return (int)cudaErrorInvalidValue;
  int span, n_slices;
  slices_of(h / 8, reset_rows, span, n_slices);
  const long long blocks = (long long)b * n_slices * ((w / 8 + 3) / 4);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (qmat) {
    recon_rows_kernel<true><<<(unsigned)blocks, 32, 0, s>>>(
        levels, q_blk, h, w, span, n_slices, rec, out8);
  } else {
    recon_rows_kernel<false><<<(unsigned)blocks, 32, 0, s>>>(
        levels, q_blk, h, w, span, n_slices, rec, out8);
  }
  return (int)cudaGetLastError();
}
