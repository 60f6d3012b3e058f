// Fused residual -> ITX8 -> quantize -> dequantize -> inverse ITX8 -> recon
// of one plane, with the levels written in zigzag order.
//
// Replaces: video_encoder_tpu/ops/pallas/codec.py, _make_code_plane_kernel
// (launched by _code_plane_call, public code_plane), plus the zigzag that
// the reference's dispatch.code_plane applies after it.
//
// Bound on this card: device memory, barely. Per pixel it reads cur and
// pred and writes a level and a recon value (16 bytes) against 32 integer
// multiply-adds for the two 8-point passes each way.
//
// Design: a thread block holds four 8x8 blocks of one block row, one
// thread per coefficient (64 x 4 threads). Each separable pass goes
// through shared memory, so no intermediate reaches device memory. The
// basis B and the zigzag permutation sit in __constant__ memory. All math
// is int32: |u2| <= ~73.3e6 is the largest intermediate (the bound proof
// is in the reference module's docstring). Quantization is the exact
// integer division (16|c| + bias*q) / (16q), bias 8 at DC; q is read from
// q_blk[by][bx] directly and, under the v3 quant matrix, scaled per
// position to max(1, (q * QMAT[r][c] + 8) >> 4) (16q <= 63712 then, still
// int32). The TPU kernel's f32-reciprocal division and
// one-hot f32 q expansion were TPU workarounds and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int SUB = 4;  // 8x8 blocks per thread block

__constant__ int kB[8][8] = {
    {362, 362, 362, 362, 362, 362, 362, 362},
    {502, 426, 284, 100, -100, -284, -426, -502},
    {473, 196, -196, -473, -473, -196, 196, 473},
    {426, -100, -502, -284, 284, 502, 100, -426},
    {362, -362, -362, 362, 362, -362, -362, 362},
    {284, -502, 100, 426, -426, -100, 502, -284},
    {196, -473, 473, -196, -196, 473, -473, 196},
    {100, -284, 426, -502, 502, -426, 284, -100},
};

// kUnzigzag[raster] = scan position (codec/spec.py UNZIGZAG)
__constant__ int kUnzigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
};

// v3 quant matrix in 16ths (codec/spec.py QMAT): 16 + 2 (r + c), 16 at DC
__constant__ int kQmat[8][8] = {
    {16, 18, 20, 22, 24, 26, 28, 30}, {18, 20, 22, 24, 26, 28, 30, 32},
    {20, 22, 24, 26, 28, 30, 32, 34}, {22, 24, 26, 28, 30, 32, 34, 36},
    {24, 26, 28, 30, 32, 34, 36, 38}, {26, 28, 30, 32, 34, 36, 38, 40},
    {28, 30, 32, 34, 36, 38, 40, 42}, {30, 32, 34, 36, 38, 40, 42, 44},
};

__device__ __forceinline__ int rshift_round(int v) {
  const int mag = (abs(v) + 512) >> 10;  // TX_SHIFT = 10
  return v < 0 ? -mag : mag;
}

__global__ void __launch_bounds__(64 * SUB)
code_plane_kernel(const int* __restrict__ cur, const int* __restrict__ pred,
                  const int* __restrict__ q_blk, int h, int w, int qbias,
                  int qmat, int* __restrict__ levels, int* __restrict__ rec) {
  __shared__ int sa[SUB][8][8];
  __shared__ int sb[SUB][8][8];
  const int sub = threadIdx.y;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int nbx = w >> 3;
  const int bx = blockIdx.x * SUB + sub, by = blockIdx.y;
  const bool active = bx < nbx;  // the row's last thread block may be ragged
  const int o = (by * 8 + r) * w + bx * 8 + c;

  int p = 0;
  if (active) {
    p = pred[o];
    sa[sub][r][c] = cur[o] - p;
  }
  __syncthreads();

  int acc = 0;  // t1 = B @ x
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += kB[r][j] * sa[sub][j][c];
  sb[sub][r][c] = rshift_round(acc);
  __syncthreads();

  acc = 0;  // coef = t1 @ B^T
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += sb[sub][r][j] * kB[c][j];
  const int coef = rshift_round(acc);

  int q = active ? q_blk[by * nbx + bx] : 1;
  if (qmat) q = max(1, (q * kQmat[r][c] + 8) >> 4);
  const int bias = (r == 0 && c == 0) ? 8 : qbias;
  const int mag = (16 * abs(coef) + bias * q) / (16 * q);
  const int lv = coef < 0 ? -mag : mag;
  if (active) levels[(by * nbx + bx) * 64 + kUnzigzag[r * 8 + c]] = lv;
  sa[sub][r][c] = lv * q;  // sa is no longer read: safe without a barrier
  __syncthreads();

  acc = 0;  // u1 = B^T @ deq
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += kB[j][r] * sa[sub][j][c];
  sb[sub][r][c] = rshift_round(acc);
  __syncthreads();

  acc = 0;  // u2 = u1 @ B
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += sb[sub][r][j] * kB[j][c];
  if (active) rec[o] = min(max(rshift_round(acc) + p, 0), 255);
}

}  // namespace

// cur, pred, rec: [h, w] int32 (h, w multiples of 8); q_blk: [h/8, w/8]
// int32; levels: [h/8, w/8, 64] int32 in zigzag order; qmat != 0 applies
// the v3 quant matrix.
extern "C" int tvc_code_plane(const int* cur, const int* pred,
                              const int* q_blk, int h, int w, int qbias,
                              int qmat, int* levels, int* rec, void* stream) {
  const dim3 block(64, SUB);
  const dim3 grid((w / 8 + SUB - 1) / SUB, h / 8);
  code_plane_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cur, pred, q_blk, h, w, qbias, qmat, levels, rec);
  return (int)cudaGetLastError();
}
