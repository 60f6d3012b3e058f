// Per-block SAD at given integer motion vectors, K candidates per launch:
// 16x16 luma macroblocks (radius 16) or 8x8 chroma blocks (radius 8), each
// candidate against one of up to 16 planes of the same size.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, make_mc_kernels ->
// sad_kernel (sad.py:852, launched through tile_call; public sad_at_mv for
// luma and sad_at_mv_chroma, block 8 and radius 8, :1087-1089). The
// diamond search calls the luma kernel once per frame, for the four ±1
// candidates of its final small-diamond step; the format-4 half-pel
// refine calls it once per frame for its nine candidates, each read from
// the parity plane (the reference plane or its H, V, D half-pel planes) of
// its vector; the hierarchical search twice per frame, 25 candidates each.
// Also replaces sad_kernel_g (:861) launched through tile_call_g, the vmap
// rule of both on G GOPs in lockstep: cur [G, H, W], the reference planes
// [G, P, H, W], vectors and SADs [G, K, nby, nbx]. The TPU needed the twin
// because vmap could not batch a pallas_call with an ANY-space operand;
// here g is blockIdx.y (the single-GOP entries pass G = 1).
// The tile-sharded encode's half-pel refine (parallel/tiles.py
// _sad_at_haloed, plain jnp in the reference) reads row-haloed parity planes
// [G, P, h + 32, w] against cur [G, h, w]: the reference planes have extents
// and an origin of their own, as in mc_fetch.cu (entry tvc_sad_at_mv_haloed).
//
// Bound on this card: memory. At 1088x1920 the kernel must read cur (8.4
// MB of int32) and each reference plane the candidates use (8.4 MB each)
// once, and write K SADs per MB; K = 4 on one plane is 0.0051 ms at 3.35
// TB/s, K = 9 on four parity planes 0.0127 ms. The work is 256 abs-diffs
// per candidate, a fraction of that time at the int32 rate.
//
// Design: one warp per (g, block) for all K candidates, two warps per
// thread block, so the K candidates of a block, whose footprints overlap
// (the diamond's four ±1 candidates lie in an 18x18 box, the half-pel
// refine's nine in a 17x17 box on each parity plane), run on one SM and
// share its L1, and cur is read once. The first design gave each
// (g, candidate, block) its own warp: cur was read K times and the K
// candidates of a block were n_blk / 8 thread blocks apart, sharing only
// L2. Lane l holds the BS * BS / 32 pixels of cur in column l % BS, rows
// l / BS + (32 / BS) i, so every load of the warp is 32 / BS row segments
// of BS consecutive words. The candidates go 32 at a time, lane j holding
// candidate j's vector and plane (its 4-bit plane_code; candidates past
// the 16th read plane 0); each candidate's pixels are read through the
// coordinate clamp in the reference's own extents and origin (oy, ox),
// the edge-replicated pad of the reference (of each parity plane, for the
// refine), and its SAD is a five-step shuffle sum kept by lane j. Four
// candidates are in flight at a time. Staging each plane's union box in
// shared memory first (the union read once, then every candidate from the
// box) was timed beside this and lost at every shape: the box's rows wait
// for their loads before the candidates can start, and its 9 KB buffer
// per warp holds 24 warps on an SM in place of 51 (PERF.md, the kernel
// table).

#include <cuda_runtime.h>

namespace {

constexpr int WPB = 2;   // warps, one per block of pixels, per thread block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned warp_sum(unsigned s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

template <int BS>
__global__ void __launch_bounds__(WPB * 32)
sad_at_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
              const int* __restrict__ dy, const int* __restrict__ dx, int k,
              int n_planes, int h, int w, int rh, int rw, int oy, int ox,
              unsigned long long plane_code, int* __restrict__ sad) {
  constexpr int PX = BS * BS / 32;        // pixels of cur a lane holds
  constexpr int RSTEP = 32 / BS;          // rows between a lane's pixels

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbx = w / BS, n_blk = (h / BS) * nbx;
  const int m = blockIdx.x * WPB + warp;
  if (m >= n_blk) return;  // whole warps leave together
  const size_t g = blockIdx.y;
  const int y0 = (m / nbx) * BS, x0 = (m % nbx) * BS;
  // lane l: column l % BS of rows l / BS + RSTEP i, so that every load of
  // the warp is RSTEP row segments of BS consecutive words
  const int col = lane % BS, row = lane / BS;

  // 64-bit offsets: g * h * w and the planes of a large batch pass int32
  int c[PX];
  const int* cp = cur + g * h * w + (size_t)(y0 + row) * w + x0 + col;
#pragma unroll
  for (int i = 0; i < PX; ++i) c[i] = cp[(size_t)RSTEP * i * w];
  const int* refg = ref + g * n_planes * rh * rw;

  for (int c0 = 0; c0 < k; c0 += 32) {
    const int n = min(32, k - c0), cand = c0 + lane;
    const size_t idx = ((size_t)g * k + cand) * n_blk + m;
    int vy = 0, vx = 0, plane = 0;
    if (lane < n) {
      vy = dy[idx];
      vx = dx[idx];
      plane = cand < 16 ? (int)((plane_code >> (4 * cand)) & 15) : 0;
    }
    int mine = 0;            // candidate lane's SAD
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int ty = __shfl_sync(FULL, vy, j), tx = __shfl_sync(FULL, vx, j);
      const int* rp = refg + (size_t)__shfl_sync(FULL, plane, j) * rh * rw +
                      min(max(x0 + col + tx + ox, 0), rw - 1);
      unsigned s = 0;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int y = min(max(y0 + row + RSTEP * i + ty + oy, 0), rh - 1);
        s = __sad(c[i], __ldg(rp + (size_t)y * rw), s);
      }
      s = warp_sum(s);
      if (lane == j) mine = (int)s;
    }
    if (lane < n) sad[idx] = mine;
  }
}

// The reference planes are [g, n_planes, rh, rw] with cur's origin at row
// (rh - h) / 2, column (rw - w) / 2: each extent is cur's own or cur's plus
// 2 BS.
template <int BS>
int launch(const int* cur, const int* ref, const int* dy, const int* dx,
           int g, int k, int n_planes, int h, int w, int rh, int rw,
           unsigned long long plane_code, int* sad, void* stream) {
  if ((rh != h && rh != h + 2 * BS) || (rw != w && rw != w + 2 * BS) ||
      g < 1 || g > 65535 || k < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_blk = (h / BS) * (w / BS);
  if (n_blk > 0 && k > 0) {
    const dim3 grid((n_blk + WPB - 1) / WPB, g);
    sad_at_kernel<BS><<<grid, WPB * 32, 0, (cudaStream_t)stream>>>(
        cur, ref, dy, dx, k, n_planes, h, w, rh, rw, (rh - h) / 2,
        (rw - w) / 2, plane_code, sad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// cur: [h, w] int32 (multiples of 16, 16-byte aligned); ref: [n_planes, h,
// w] int32; dy, dx, sad: [k, h/16, w/16] int32, |mv| <= 16. Candidate
// j < 16 reads plane (plane_code >> 4j) & 15, later ones plane 0.
extern "C" int tvc_sad_at_mv(const int* cur, const int* ref, const int* dy,
                             const int* dx, int k, int n_planes, int h, int w,
                             unsigned long long plane_code, int* sad,
                             void* stream) {
  return launch<16>(cur, ref, dy, dx, 1, k, n_planes, h, w, h, w, plane_code,
                    sad, stream);
}

// The chroma twin: cur, ref [h, w] int32 (multiples of 8; cur 8-byte
// aligned); dy, dx, sad: [k, h/8, w/8] int32, |mv| <= 8.
extern "C" int tvc_sad_at_mv_chroma(const int* cur, const int* ref,
                                    const int* dy, const int* dx, int k,
                                    int h, int w, int* sad, void* stream) {
  return launch<8>(cur, ref, dy, dx, 1, k, 1, h, w, h, w, 0ull, sad, stream);
}

// The G-batched form: cur [g, h, w] int32; ref [g, n_planes, h, w] int32;
// dy, dx, sad [g, k, h/16, w/16] int32. Candidate j of every GOP reads that
// GOP's plane (plane_code >> 4j) & 15.
extern "C" int tvc_sad_at_mv_g(const int* cur, const int* ref, const int* dy,
                               const int* dx, int g, int k, int n_planes,
                               int h, int w, unsigned long long plane_code,
                               int* sad, void* stream) {
  return launch<16>(cur, ref, dy, dx, g, k, n_planes, h, w, h, w, plane_code,
                    sad, stream);
}

// Its chroma twin: cur, ref [g, h, w] int32; dy, dx, sad [g, k, h/8, w/8].
extern "C" int tvc_sad_at_mv_chroma_g(const int* cur, const int* ref,
                                      const int* dy, const int* dx, int g,
                                      int k, int h, int w, int* sad,
                                      void* stream) {
  return launch<8>(cur, ref, dy, dx, g, k, 1, h, w, h, w, 0ull, sad, stream);
}

// The pre-haloed form: cur [g, h, w] int32; ref_ext [g, n_planes, rh, rw]
// int32 with rh = h + 32 and rw = w or w + 32; dy, dx, sad
// [g, k, h/16, w/16] int32, |mv| <= 16.
extern "C" int tvc_sad_at_mv_haloed(const int* cur, const int* ref_ext,
                                    const int* dy, const int* dx, int g, int k,
                                    int n_planes, int h, int w, int rh, int rw,
                                    unsigned long long plane_code, int* sad,
                                    void* stream) {
  if (rh != h + 32) return (int)cudaErrorInvalidValue;
  return launch<16>(cur, ref_ext, dy, dx, g, k, n_planes, h, w, rh, rw,
                    plane_code, sad, stream);
}
