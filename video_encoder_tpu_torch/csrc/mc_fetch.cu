// Motion-compensated predictor fetch at per-block integer motion vectors.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, make_mc_kernels -> mc_kernel
// (public mc_fetch_plane with 16x16 blocks and radius 16, and
// mc_fetch_plane_chroma with 8x8 blocks and radius 8), and mc_kernel_g
// launched through tile_call_g, the vmap rule of both on [G, H, W]
// reference planes with per-GOP vectors [G, nby, nbx]. The TPU needed the
// twin because vmap could not batch a pallas_call whose reference sits in
// ANY space; here the GOP is blockIdx.z and a plane stride (the
// single-plane entry launches with G = 1).
// Also replaces mc_fetch_pre_haloed (sad.py:1038; luma block 16 radius 16,
// chroma block 8 radius 8), the tile-sharded encode's fetch from a
// reference ref_ext [h + 2r, w] or [h + 2r, w + 2r] that already carries
// the neighbour shards' rows (and columns, on a 2-D tile grid) for an
// [h, w] output. The TPU wrapper padded ref_ext to tile multiples; here the
// reference has extents, an origin (oy, ox) and a plane stride of its own,
// and the clamp acts only on an axis without a halo, where it is pad_ref's
// edge replication. The other entries pass the output's extents, origin 0.
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
                                int rh, int rw, int oy, int ox, int bs,
                                int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  // 64-bit plane offsets: g * h * w passes int32 for a large batch
  const size_t g = blockIdx.z;
  const size_t b = g * (h / bs) * (w / bs) + (y / bs) * (w / bs) + x / bs;
  const int sy = min(max(y + dy[b] + oy, 0), rh - 1);
  const int sx = min(max(x + dx[b] + ox, 0), rw - 1);
  out[g * h * w + y * w + x] = ref[g * rh * rw + sy * rw + sx];
}

// ref is [g, rh, rw] with the output's origin at its row (rh - h) / 2,
// column (rw - w) / 2: each extent is the output's own or that plus 2 bs.
int launch(const int* ref, const int* dy, const int* dx, int g, int h, int w,
           int rh, int rw, int bs, int* out, void* stream) {
  if (g < 1 || g > 65535) return (int)cudaErrorInvalidValue;
  if ((rh != h && rh != h + 2 * bs) || (rw != w && rw != w + 2 * bs)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8, g);
  mc_fetch_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      ref, dy, dx, h, w, rh, rw, (rh - h) / 2, (rw - w) / 2, bs, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ref, out: [h, w] int32; dy, dx: [h/bs, w/bs] int32.
extern "C" int tvc_mc_fetch(const int* ref, const int* dy, const int* dx,
                            int h, int w, int bs, int* out, void* stream) {
  return launch(ref, dy, dx, 1, h, w, h, w, bs, out, stream);
}

// The G-batched fetch: ref, out [g, h, w] int32; dy, dx [g, h/bs, w/bs]
// int32; plane g is fetched from ref[g] at its own vectors.
extern "C" int tvc_mc_fetch_g(const int* ref, const int* dy, const int* dx,
                              int g, int h, int w, int bs, int* out,
                              void* stream) {
  return launch(ref, dy, dx, g, h, w, h, w, bs, out, stream);
}

// The pre-haloed fetch of g row shards (or 2-D tiles): ref_ext [g, rh, rw]
// int32 with rh = h + 2 bs and rw = w or w + 2 bs; dy, dx [g, h/bs, w/bs]
// int32 (|mv| <= bs); out [g, h, w].
extern "C" int tvc_mc_fetch_haloed(const int* ref_ext, const int* dy,
                                   const int* dx, int g, int h, int w, int rh,
                                   int rw, int bs, int* out, void* stream) {
  if (rh != h + 2 * bs) return (int)cudaErrorInvalidValue;
  return launch(ref_ext, dy, dx, g, h, w, rh, rw, bs, out, stream);
}
