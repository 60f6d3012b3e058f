// Motion-compensated predictor fetch at per-block integer motion vectors.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, make_mc_kernels -> mc_kernel
// (public mc_fetch_plane with 16x16 blocks and radius 16, and
// mc_fetch_plane_chroma with 8x8 blocks and radius 8).
//
// Bound on this card: device memory. Each output pixel is one 4-byte read
// and one 4-byte write (16 MB for a 1088x1920 luma plane), with no
// arithmetic to speak of.
//
// Design: one thread per output pixel,
//   pred[y][x] = ref[clamp(y + dy_b, 0, h-1)][clamp(x + dx_b, 0, w-1)],
// where b is the pixel's block. Clamping reproduces the reference's
// edge-replicated pad because |mv| <= the pad radius. Neighbouring threads
// of a warp read neighbouring pixels of one block row, so loads and stores
// coalesce. The TPU kernel's one-hot bf16 matmuls stood in for a gather
// the TPU lacks; a GPU gathers directly.

#include <cuda_runtime.h>

namespace {

__global__ void mc_fetch_kernel(const int* __restrict__ ref,
                                const int* __restrict__ dy,
                                const int* __restrict__ dx, int h, int w,
                                int bs, int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int b = (y / bs) * (w / bs) + x / bs;
  const int sy = min(max(y + dy[b], 0), h - 1);
  const int sx = min(max(x + dx[b], 0), w - 1);
  out[y * w + x] = ref[sy * w + sx];
}

}  // namespace

// ref, out: [h, w] int32; dy, dx: [h/bs, w/bs] int32.
extern "C" int tvc_mc_fetch(const int* ref, const int* dy, const int* dx,
                            int h, int w, int bs, int* out, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  mc_fetch_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(ref, dy, dx, h, w,
                                                            bs, out);
  return (int)cudaGetLastError();
}
