// Per-macroblock 16x16 SAD at given integer motion vectors, K candidates
// per launch.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, make_mc_kernels ->
// sad_kernel (launched through tile_call, public sad_at_mv, luma). The
// diamond search calls it once per frame, for the four ±1 candidates of
// its final small-diamond step.
//
// Bound on this card: memory latency. At 1088x1920 with K = 4 it reads
// 4 x 8160 x 256 reference pixels (33 MB of int32, mostly from L2, since
// the four candidates of an MB overlap) and writes 130 KB.
//
// Design: one warp per (candidate, MB) pair, eight pairs per 256-thread
// block. Lane t takes column t % 16 and rows t / 16, t / 16 + 2, ..., so
// each half-warp reads 16 consecutive pixels of one row of the current
// block and of the reference, and the warp's partial sums meet in a
// shuffle reduction. The reference is read with clamped coordinates,
// exactly as mc_fetch.cu reads it (the reference's edge-replicated pad for
// |mv| <= 16). The TPU's one-hot bf16 matmuls stood in for a gather the
// TPU lacks; a GPU gathers directly.

#include <cuda_runtime.h>

namespace {

constexpr int MB = 16;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
sad_at_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
              const int* __restrict__ dy, const int* __restrict__ dx, int h,
              int w, int n_pairs, int* __restrict__ sad) {
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int nbx = w / MB, n_mbs = (h / MB) * nbx;
  const int m = pair % n_mbs;
  const int y0 = (m / nbx) * MB, x0 = (m % nbx) * MB;
  const int vy = dy[pair], vx = dx[pair];
  const int c = lane & 15;
  const int sx = min(max(x0 + c + vx, 0), w - 1);
  unsigned int s = 0;
#pragma unroll
  for (int r = lane >> 4; r < MB; r += 2) {
    const int sy = min(max(y0 + r + vy, 0), h - 1);
    s = __sad(cur[(y0 + r) * w + x0 + c], ref[sy * w + sx], s);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) sad[pair] = (int)s;
}

}  // namespace

// cur, ref: [h, w] int32 (multiples of 16); dy, dx, sad: [k, h/16, w/16]
// int32, |mv| <= 16.
extern "C" int tvc_sad_at_mv(const int* cur, const int* ref, const int* dy,
                             const int* dx, int k, int h, int w, int* sad,
                             void* stream) {
  const int n_pairs = k * (h / MB) * (w / MB);
  if (n_pairs > 0) {
    sad_at_kernel<<<(n_pairs + WARPS - 1) / WARPS, WARPS * 32, 0,
                    (cudaStream_t)stream>>>(cur, ref, dy, dx, h, w, n_pairs,
                                            sad);
  }
  return (int)cudaGetLastError();
}
