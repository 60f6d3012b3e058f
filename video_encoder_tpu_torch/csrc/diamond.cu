// The diamond descent (SPEC.md §9) of every MB of a P step in one launch:
// the large-diamond walk over the MB's row of the even SAD map, then the
// final ±1 step with its four SADs computed from the planes.
//
// Replaces no TPU kernel: the reference runs the descent as a jnp loop of
// vectorised gathers over the even map (video_encoder_tpu/ops/dispatch.py,
// diamond_search, :100-141, left to XLA's fusion) and its final ±1 step as
// one sad_at_mv pass (ops/pallas/sad.py:1087). The same loop in plain
// PyTorch (motion.diamond_descent, the CPU route and the kernel's plain
// version) is about 710 device ops a P step on the card: 16 steps of
// gathers, wheres, casts and cats over [(G,) 4 or 5, nby, nbx] tensors,
// each a launch and its ramp for a few microseconds of work. Every MB
// descends on its own (it starts at (0, 0), reads only its own row of the
// map and has no neighbour predictor), so the whole search is one
// kernel's work.
//
// Bound on this card: memory. At 1088x1920 the final step must read cur
// and the reference (8.4 MB of int32 each) once, and the walk reads at
// most 65 of each MB's 289 map entries (2.1 MB over 8160 MBs; the walks
// of a panned frame read 76,307 entries, 0.3 MB): 0.0051-0.0056 ms at
// 3.35 TB/s, G times that for G GOPs in lockstep. The walk itself is a
// chain of at most 16 dependent steps of four compares per MB. On an H100
// the kernel takes 0.0113 ms at G = 1 and 0.0465 ms at G = 4 on panned
// frames, 2.2x and 2.3x their bound (chip_smoke.py's kernels phase; row
// 8d of PERF.md's kernel table).
//
// Design: one warp per MB (flat index over G x the MB grid, so g needs no
// grid axis of its own), four warps per thread block. The warp copies the
// MB's map row of 289 words (written just before by even_map_kernel, so
// mostly still in L2) into its slice of shared memory with coalesced
// loads, and loads its 16x16 block of cur into registers in the same
// round trip: lane l holds column l % 16 of rows l / 16 + 2 i, as
// sad_at_kernel<16> does. Every lane then runs the same walk from shared
// memory (a read of one address by the whole warp is a broadcast), so the
// control flow never diverges, and stops at the first frozen step: a
// frozen MB's later steps are the identity. A candidate outside ±16 costs
// BIG; its map index is taken at the clamped vector, as the plain gather
// takes it, so no read leaves the row. The current vector is candidate 0
// and a candidate wins only with a strictly smaller cost, which is the
// first minimum of the key cost * 8 + index. The final step computes the
// SADs of its valid candidates (an invalid one costs BIG whatever its
// SAD) with every load issued before the first xor-shuffle sum, through
// the coordinate clamp that is the reference's edge-replicated pad by 16
// (|mv| <= 16), and applies the same rule to every MB, frozen or not.

#include <cuda_runtime.h>

namespace {

constexpr int WPB = 4;            // warps, one per MB, per thread block
constexpr int R = 16;             // search radius (tables.SEARCH_R)
constexpr int NE = R + 1;         // even offsets per axis
constexpr int NMAP = NE * NE;     // even-map entries per MB
constexpr int MAP_LOADS = (NMAP + 31) / 32;   // map words a lane copies
constexpr int MAX_STEPS = 16;     // spec.DIAMOND_MAX_STEPS
constexpr int EARLY_SAD = 512;    // spec.DIAMOND_EARLY_SAD
constexpr int BIG = 1 << 30;      // cost of a candidate outside ±R
constexpr int PX = 8;             // pixels of cur a lane holds
constexpr unsigned FULL = 0xffffffffu;

// the unit step of candidate k + 1 of a step: up, left, right, down (times
// 2 on the even lattice), as motion.diamond_search_with orders them
__device__ __forceinline__ int step_y(int k) { return (k == 3) - (k == 0); }
__device__ __forceinline__ int step_x(int k) { return (k == 2) - (k == 1); }

__device__ __forceinline__ int map_index(int dy, int dx) {
  const int cy = min(max(dy, -R), R), cx = min(max(dx, -R), R);
  return ((cy + R) >> 1) * NE + ((cx + R) >> 1);
}

__device__ __forceinline__ bool in_window(int dy, int dx) {
  return abs(dy) <= R && abs(dx) <= R;
}

__global__ void __launch_bounds__(WPB * 32)
descent_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
               const int* __restrict__ map, int n_total, int h, int w,
               int* __restrict__ out_dy, int* __restrict__ out_dx,
               int* __restrict__ out_sad) {
  __shared__ int rows[WPB][NMAP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * WPB + warp;
  if (m >= n_total) return;  // whole warps leave together
  const int nbx = w / 16, n_mb = (h / 16) * nbx;
  const size_t g = m / n_mb;
  const int b = m % n_mb;
  const int y0 = (b / nbx) * 16, x0 = (b % nbx) * 16;
  const int col = lane & 15, row = lane >> 4;

  // the map row and the block of cur, all loads in flight together
  int* mrow = rows[warp];
  const int* mp = map + (size_t)m * NMAP;
  int v[MAP_LOADS];
#pragma unroll
  for (int j = 0; j < MAP_LOADS; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < NMAP ? __ldg(mp + i) : 0;
  }
  int c[PX];
  const int* cp = cur + g * h * w + (size_t)(y0 + row) * w + x0 + col;
#pragma unroll
  for (int i = 0; i < PX; ++i) c[i] = __ldg(cp + (size_t)2 * i * w);
#pragma unroll
  for (int j = 0; j < MAP_LOADS; ++j) {
    if (lane + 32 * j < NMAP) mrow[lane + 32 * j] = v[j];
  }
  __syncwarp();

  // the large-diamond walk, the same on every lane
  int dy = 0, dx = 0, cost = mrow[map_index(0, 0)];
  bool frozen = cost < EARLY_SAD;
  for (int step = 0; step < MAX_STEPS && !frozen; ++step) {
    int best = cost, by = dy, bx = dx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ny = dy + 2 * step_y(k), nx = dx + 2 * step_x(k);
      const int e = mrow[map_index(ny, nx)];
      const int cst = in_window(ny, nx) ? e : BIG;
      if (cst < best) {
        best = cst;
        by = ny;
        bx = nx;
      }
    }
    if (by == dy && bx == dx) {
      frozen = true;                 // no move
    } else {
      dy = by;
      dx = bx;
      cost = best;
      frozen = cost < EARLY_SAD;
    }
  }

  // the final ±1 step of every MB: the SADs of its valid candidates
  const int* refg = ref + g * h * w;
  unsigned s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ny = dy + step_y(k), nx = dx + step_x(k);
    s[k] = 0;
    if (in_window(ny, nx)) {
      const int* rp = refg + min(max(x0 + col + nx, 0), w - 1);
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int y = min(max(y0 + row + 2 * i + ny, 0), h - 1);
        s[k] = __sad(c[i], __ldg(rp + (size_t)y * w), s[k]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += __shfl_xor_sync(FULL, s[k], off);
  }
  int best = cost, by = dy, bx = dx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ny = dy + step_y(k), nx = dx + step_x(k);
    const int cst = in_window(ny, nx) ? (int)s[k] : BIG;
    if (cst < best) {
      best = cst;
      by = ny;
      bx = nx;
    }
  }
  if (lane == 0) {
    out_dy[m] = by;
    out_dx[m] = bx;
    out_sad[m] = best;
  }
}

}  // namespace

// cur, ref: [g, h, w] int32 (h, w multiples of 16; g = 1 for one plane);
// map: [g, h/16, w/16, 289] int32, the even SAD map of cur against ref
// (candidate ((dy+16)/2)*17 + (dx+16)/2); dy, dx, sad: [g, h/16, w/16]
// int32, the descent's vector and cost of each MB.
extern "C" int tvc_diamond_descent(const int* cur, const int* ref,
                                   const int* map, int g, int h, int w,
                                   int* dy, int* dx, int* sad, void* stream) {
  if (g < 1 || h < 0 || w < 0 || h % 16 || w % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_total = (long long)g * (h / 16) * (w / 16);
  if (n_total > (1ll << 30)) return (int)cudaErrorInvalidValue;
  if (n_total > 0) {
    const int blocks = (int)((n_total + WPB - 1) / WPB);
    descent_kernel<<<blocks, WPB * 32, 0, (cudaStream_t)stream>>>(
        cur, ref, map, (int)n_total, h, w, dy, dx, sad);
  }
  return (int)cudaGetLastError();
}
