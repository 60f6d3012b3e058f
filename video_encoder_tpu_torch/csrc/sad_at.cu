// Per-block SAD at given integer motion vectors, K candidates per launch:
// 16x16 luma macroblocks (radius 16) or 8x8 chroma blocks (radius 8), each
// candidate against one of up to 16 planes of the same size.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, make_mc_kernels ->
// sad_kernel (launched through tile_call; public sad_at_mv for luma and
// sad_at_mv_chroma, block 8 and radius 8, for chroma). The diamond search
// calls the luma kernel once per frame, for the four ±1 candidates of its
// final small-diamond step; the format-4 half-pel refine calls it once per
// frame for its nine candidates, each read from the parity plane (the
// reference plane or its H, V, D half-pel planes) of its vector.
//
// Bound on this card: memory latency. At 1088x1920 with K = 4 it reads
// 4 x 8160 x 256 reference pixels (33 MB of int32, mostly from L2, since
// the four candidates of an MB overlap) and writes 130 KB.
//
// Design: one warp per (candidate, block) pair, eight pairs per 256-thread
// thread block. Lane t takes column t % BS and rows t / BS, t / BS + 32 / BS,
// ..., so each group of BS lanes reads BS consecutive pixels of one row of
// the current block and of the reference, and the warp's partial sums meet
// in a shuffle reduction. The reference is read with clamped coordinates,
// exactly as mc_fetch.cu reads it (the reference's edge-replicated pad for
// |mv| <= BS); on a parity plane that clamps the plane itself, as the
// reference's pad of that plane does. The plane of candidate k is 4 bits
// of a 64-bit launch argument, so no table goes through device memory.
// The TPU's one-hot bf16 matmuls stood in for a gather the TPU lacks; a
// GPU gathers directly.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

template <int BS>
__global__ void __launch_bounds__(WARPS * 32)
sad_at_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
              const int* __restrict__ dy, const int* __restrict__ dx, int h,
              int w, int n_pairs, unsigned long long plane_code,
              int* __restrict__ sad) {
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int nbx = w / BS, n_blk = (h / BS) * nbx;
  const int m = pair % n_blk, cand = pair / n_blk;
  const int plane = cand < 16 ? (int)((plane_code >> (4 * cand)) & 15) : 0;
  const int* rp = ref + (size_t)plane * h * w;
  const int y0 = (m / nbx) * BS, x0 = (m % nbx) * BS;
  const int vy = dy[pair], vx = dx[pair];
  const int c = lane % BS;
  const int sx = min(max(x0 + c + vx, 0), w - 1);
  unsigned int s = 0;
#pragma unroll
  for (int r = lane / BS; r < BS; r += 32 / BS) {
    const int sy = min(max(y0 + r + vy, 0), h - 1);
    s = __sad(cur[(y0 + r) * w + x0 + c], rp[sy * w + sx], s);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) sad[pair] = (int)s;
}

template <int BS>
int launch(const int* cur, const int* ref, const int* dy, const int* dx,
           int k, int h, int w, unsigned long long plane_code, int* sad,
           void* stream) {
  const int n_pairs = k * (h / BS) * (w / BS);
  if (n_pairs > 0) {
    sad_at_kernel<BS><<<(n_pairs + WARPS - 1) / WARPS, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(cur, ref, dy, dx, h, w,
                                                n_pairs, plane_code, sad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// cur: [h, w] int32 (multiples of 16); ref: [P, h, w] int32; dy, dx, sad:
// [k, h/16, w/16] int32, |mv| <= 16. Candidate j < 16 reads plane
// (plane_code >> 4j) & 15, later ones plane 0.
extern "C" int tvc_sad_at_mv(const int* cur, const int* ref, const int* dy,
                             const int* dx, int k, int h, int w,
                             unsigned long long plane_code, int* sad,
                             void* stream) {
  return launch<16>(cur, ref, dy, dx, k, h, w, plane_code, sad, stream);
}

// The chroma twin: cur, ref [h, w] int32 (multiples of 8); dy, dx, sad:
// [k, h/8, w/8] int32, |mv| <= 8.
extern "C" int tvc_sad_at_mv_chroma(const int* cur, const int* ref,
                                    const int* dy, const int* dx, int k,
                                    int h, int w, int* sad, void* stream) {
  return launch<8>(cur, ref, dy, dx, k, h, w, 0ull, sad, stream);
}
