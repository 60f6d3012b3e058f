// Exhaustive ±16 SAD motion search, one 16x16 macroblock per thread block,
// and its map-emitting twin for the diamond search's even lattice.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, _make_full_search_kernel,
// launched by _full_search_call (public full_search: stride 1, packed
// minimum) and by _sad_map_call with stride 2 (public sad_map_even: the
// 289 SADs of the even-even mvs). The TPU builds both from one kernel
// factory; here one template does, on stride and on min-versus-map.
//
// Bound on this card: integer ALU and shared-memory loads. A 1088x1920
// frame has 8160 MBs x 1089 candidates x 256 pixels, about 2.3e9
// absolute differences (a quarter of that for the 289-candidate map); the
// frame itself is only 8 MB of int32 reads.
//
// Design: each block stages its 48x48 reference window and the 16x16
// current block in shared memory once (global traffic about 10 KB per MB),
// then its threads stride over the candidates, one __sad per pixel. The
// window is read with clamped coordinates, which is exactly the
// reference's edge-replicated pad_ref because |dy|, |dx| <= 16, so no
// padded copy of the frame is made.
//   - min (full_search): the winner is the minimum of the packed key
//     sad << 11 | k (sad <= 65280, k < 1089: fits int32), which is the
//     row-major strict-< first minimum; it is reduced by warp shuffles and
//     then across the block's warps in shared memory.
//   - map (sad_map_even): thread k writes SAD k of the MB's [289] row, so
//     a warp's stores are contiguous.
// Packing four pixels per __vsadu4 is later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int MB = 16;
constexpr int R = 16;
constexpr int ND = 2 * R + 1;     // 33
constexpr int WIN = MB + 2 * R;   // 48
constexpr int THREADS = 256;

template <int STRIDE, bool EMIT_MAP>
__global__ void __launch_bounds__(THREADS)
search_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
              int h, int w, int* __restrict__ dy_out,
              int* __restrict__ dx_out, int* __restrict__ sad_out,
              int* __restrict__ map_out) {
  constexpr int NDS = (ND + STRIDE - 1) / STRIDE;  // 33 or 17 per axis
  constexpr int NCAND = NDS * NDS;                 // 1089 or 289
  __shared__ int win[WIN][WIN + 1];
  __shared__ int blk[MB][MB];
  __shared__ int warp_best[THREADS / 32];

  const int bx = blockIdx.x, by = blockIdx.y;
  const int y0 = by * MB, x0 = bx * MB;
  const int tid = threadIdx.x;
  const int o = by * gridDim.x + bx;

  for (int i = tid; i < WIN * WIN; i += THREADS) {
    const int r = i / WIN, c = i % WIN;
    const int y = min(max(y0 - R + r, 0), h - 1);
    const int x = min(max(x0 - R + c, 0), w - 1);
    win[r][c] = ref[y * w + x];
  }
  {
    const int r = tid / MB, c = tid % MB;
    blk[r][c] = cur[(y0 + r) * w + x0 + c];
  }
  __syncthreads();

  int best = INT_MAX;
  for (int k = tid; k < NCAND; k += THREADS) {
    const int ky = (k / NDS) * STRIDE, kx = (k % NDS) * STRIDE;
    unsigned int s = 0;
#pragma unroll 4
    for (int r = 0; r < MB; ++r) {
#pragma unroll
      for (int c = 0; c < MB; ++c) {
        s = __sad(blk[r][c], win[ky + r][kx + c], s);
      }
    }
    if constexpr (EMIT_MAP) {
      map_out[(size_t)o * NCAND + k] = (int)s;
    } else {
      best = min(best, (int)(s << 11) | k);
    }
  }
  if constexpr (!EMIT_MAP) {
    for (int off = 16; off > 0; off >>= 1) {
      best = min(best, __shfl_down_sync(0xffffffffu, best, off));
    }
    if ((tid & 31) == 0) warp_best[tid >> 5] = best;
    __syncthreads();
    if (tid == 0) {
      int b = warp_best[0];
      for (int i = 1; i < THREADS / 32; ++i) b = min(b, warp_best[i]);
      const int k = b & 2047;
      dy_out[o] = k / ND - R;
      dx_out[o] = k % ND - R;
      sad_out[o] = b >> 11;
    }
  }
}

}  // namespace

// cur, ref: [h, w] int32 (h, w multiples of 16); dy, dx, sad: [h/16, w/16].
extern "C" int tvc_full_search(const int* cur, const int* ref, int h, int w,
                               int* dy, int* dx, int* sad, void* stream) {
  const dim3 grid(w / MB, h / MB);
  search_kernel<1, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cur, ref, h, w, dy, dx, sad, nullptr);
  return (int)cudaGetLastError();
}

// cur, ref: [h, w] int32 (h, w multiples of 16); map: [h/16, w/16, 289]
// int32, candidate ((dy+16)/2)*17 + (dx+16)/2.
extern "C" int tvc_sad_map_even(const int* cur, const int* ref, int h, int w,
                                int* map, void* stream) {
  const dim3 grid(w / MB, h / MB);
  search_kernel<2, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cur, ref, h, w, nullptr, nullptr, nullptr, map);
  return (int)cudaGetLastError();
}
