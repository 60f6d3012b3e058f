// Exhaustive ±16 SAD motion search, one 16x16 macroblock per thread block,
// and its map-emitting twin for the diamond search's even lattice.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, _make_full_search_kernel,
// launched by _full_search_call (public full_search: stride 1, packed
// minimum) and by _sad_map_call (sad.py:594) with stride 1 (public
// sad_map, :709: all 1089 SADs of an MB) or 2 (public sad_map_even, :716:
// the 289 SADs of the even-even mvs). The TPU builds all three from one
// kernel factory; here the search and the whole map share tiled_kernel (a
// template on map-or-minimum) and the even map, on byte-packed rows, has a
// kernel of its own.
// Also replaces its G-batched twins _full_search_call_batch and
// _sad_map_call_batch (:632; the vmap rules of full_search and the maps on
// [G, H, W] planes of G GOPs in lockstep): the TPU needed separate calls
// because vmap could not batch a pallas_call with an ANY-space operand;
// here the GOP is blockIdx.z and a plane stride, in the same kernel (the
// single-plane entries launch it with G = 1).
// Also replaces full_search_pre_haloed (sad.py:536), the tile-sharded
// encode's search of a row shard cur [h, w] against a reference
// ref_ext [h + 32, w] or [h + 32, w + 32] that already carries the
// neighbour shards' rows (and, on a 2-D tile grid, columns). The TPU wrapper
// padded ref_ext once more to tile multiples and copied windows out of it;
// here the reference has extents, an origin and a plane stride of its own:
// window pixel (y, x) reads ref[clamp(y + oy)][clamp(x + ox)] with (oy, ox)
// the offset of cur's origin inside ref_ext, so where a halo is present the
// clamp never acts and where it is absent the clamp is pad_ref's edge
// replication. The other entries pass cur's extents and origin (0, 0).
//
// Bound on this card: integer ALU. A 1088x1920 frame has 8160 MBs x 1089
// candidates x 256 pixels, about 2.3e9 absolute differences (a quarter of
// that for the 289-candidate map); the frame itself is only 8 MB of int32
// reads. The even map's vabsdiff4 makes four abs-diffs per instruction,
// so its bound in int32 operations is a quarter of the plain count.
//
// Staging (every kernel here): one block per MB stages the MB's 48x48
// reference window and its 16x16 block in shared memory once (global
// traffic about 10 KB per MB). The window is read with clamped
// coordinates, which is exactly the reference's edge-replicated pad_ref
// because |dy|, |dx| <= 16, so no padded copy of the frame is made. Each
// thread issues all its loads before its first store, so a block waits
// for one round trip to memory, not one per element.
//
// The exhaustive search and the whole map (tiled_kernel; the entries
// tvc_full_search, _g, _haloed and tvc_sad_map(_g)): 128 threads per MB.
// A thread holds four rows of the block in registers and takes a group of
// RUN = 11 horizontally adjacent candidates of one dy at a time: per block
// row it loads one strip of 16 + 10 window pixels and makes 16 x 11
// abs-diffs from registers, so a shared load serves 6.8 of them (the first
// design, one __sad with both operands read from shared memory, was bound
// by the SM's shared-load issue). The four threads of a group are
// neighbouring lanes, one per four block rows, and add their partial sums
// with two shuffles. The 99 groups of an MB go to the four warps eight at
// a time; a warp past the last group skips, so 13 warp-rounds do the MB's
// work where 12.4 would be perfect balance. The search's winner is the
// minimum of the packed key sad << 11 | k (sad <= 65280, k = (dy + 16) *
// 33 + dx + 16 < 1089: fits int32), the row-major strict-< first minimum,
// ties included. The map stages each group's SADs in the MB's row of 1089
// in shared memory, which leaves as one contiguous run of stores.
//
// The even map (even_map_kernel; tvc_sad_map_even(_g)), on planes of 8-bit
// samples (0-255, as every plane of the codec holds): the window and the
// block are staged as words of four pixels, so one vabsdiff4 makes four
// abs-diffs and their sum. The 17 candidates of a dy row are two runs of 9
// that start at kx0 = 0 and 8 and overlap in candidate 8 (17 is prime; the
// overlap costs 1/18 of the work and masks nothing), both at an even
// candidate, so a run's strip of 32 pixels is 8 aligned words: an even
// candidate reads them as they are, an odd one the words shifted by two
// pixels (a byte_perm of two neighbours). 288 threads of two block rows
// each, eight threads per group: the 34 groups take one round of 36 slots.
// A group's SADs go to the MB's row of 289 in shared memory, stored as one
// run. The same tiling with one __sad per pixel pair was slower than a
// loop of two shared loads per abs-diff, the even map's first design;
// packed, it is 2.8x faster than that loop (PERF.md, the kernel table).

// Also replaces the factory's sea=True variant (sad.py:224-325, opted into
// with TVC_SEA=1 by full_search, its batched twin and
// full_search_pre_haloed; full_search_sea_stats also returns the count of
// dy rows evaluated exactly): successive elimination, in sea_kernel. Its
// bound on this card is the same ALU work, less the rows it prunes, plus
// 1089 x 16 bound terms per MB. Design: one block per MB on the same staged
// window. Up front, all integer: the 16 column sums of the block, the
// 16-row column sums of the window at each of the 33 row offsets, the
// lower bound LB = sum_c |curc[c] - winc[ky][kx + c]| of all 1089
// candidates and its minimum per dy row (none of it depends on the running
// best). Then the dy rows in the reference's centre-out order (dy = 0, -1,
// +1, -2, ...): a row is evaluated exactly iff its smallest bound is <= the
// best SAD so far. The best key sits in shared memory and is read after the
// previous row's barrier, so the branch is uniform over the block. An
// evaluated row is 33 candidates x 256 pixels spread over all 256 threads:
// 8 threads per candidate, each holding two rows of the block in
// registers, then a shuffle reduction of the 8 partial sums. `<=` and not
// `<`: a pruned candidate has SAD >= LB > best >= the final SAD, so the
// packed-key first minimum, ties included, is the exhaustive search's. The
// reference counts rows per tile of MBs (a tile evaluates a row iff one of
// its MBs needs it); here each MB counts its own, and the reference's count
// of a tile is the OR of its MBs' row masks, because a row an MB would
// prune cannot lower that MB's best.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int MB = 16;
constexpr int R = 16;
constexpr int ND = 2 * R + 1;     // 33
constexpr int WIN = MB + 2 * R;   // 48
constexpr int THREADS = 256;

// Stages the MB's clamped 48x48 reference window and its 16x16 block with
// NT threads; the caller synchronises. cur and ref point at the block's
// plane. Every thread issues all its loads before its first store, so a
// block waits for one round trip to memory, not one per element.
template <int NT = THREADS>
__device__ __forceinline__ void stage(const int* __restrict__ cur,
                                      const int* __restrict__ ref, int w,
                                      int rh, int rw, int oy, int ox, int y0,
                                      int x0, int (*win)[WIN + 1],
                                      int (*blk)[MB]) {
  constexpr int NW = (WIN * WIN + NT - 1) / NT, NB = (MB * MB + NT - 1) / NT;
  const int tid = threadIdx.x;
  int v[NW], u[NB];
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const int i = min(tid + q * NT, WIN * WIN - 1);
    const int y = min(max(y0 - R + i / WIN + oy, 0), rh - 1);
    const int x = min(max(x0 - R + i % WIN + ox, 0), rw - 1);
    v[q] = ref[y * rw + x];
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int i = min(tid + q * NT, MB * MB - 1);
    u[q] = cur[(y0 + i / MB) * w + x0 + i % MB];
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const int i = tid + q * NT;
    if (i < WIN * WIN) win[i / WIN][i % WIN] = v[q];
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int i = tid + q * NT;
    if (i < MB * MB) blk[i / MB][i % MB] = u[q];
  }
}

// The minimum of v over the block, combined with *best; the result is in
// *best for every thread after the call (two barriers).
__device__ __forceinline__ void block_min(int v, int* best, int* warp_best) {
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = *best;
    for (int i = 0; i < THREADS / 32; ++i) b = min(b, warp_best[i]);
    *best = b;
  }
  __syncthreads();
}

constexpr int TILED_THREADS = 128;
constexpr int RUN = 11;                // adjacent dx candidates of a thread
constexpr int RUNS = ND / RUN;         // 3 runs per dy row
constexpr int GROUPS = ND * RUNS;      // 99 candidate groups per MB
constexpr int ROWS = 4;                // block rows of a thread
constexpr int STRIP = MB + RUN - 1;    // window pixels per block row: 26

// The register-tiled body of the exhaustive search and of the whole map.
// A group is a run of RUN adjacent candidates of one dy row; its four
// threads are neighbouring lanes, each holding four block rows in
// registers, and add their partial sums with two xor shuffles, so every
// lane of the group holds the run's SADs. MAP: the SADs go to the MB's
// row of the map, staged in shared memory and stored as one contiguous
// run; else the packed key sad << 11 | k is minimised over the block.
template <bool MAP>
__global__ void __launch_bounds__(TILED_THREADS)
tiled_kernel(const int* __restrict__ cur, const int* __restrict__ ref, int h,
             int w, int rh, int rw, int oy, int ox, int* __restrict__ dy_out,
             int* __restrict__ dx_out, int* __restrict__ sad_out,
             int* __restrict__ map_out) {
  constexpr int NCAND = ND * ND;
  __shared__ int win[WIN][WIN + 1];
  __shared__ int blk[MB][MB];
  __shared__ int row_s[MAP ? NCAND : 1];   // the MB's row of the map
  __shared__ int warp_best[TILED_THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 64-bit: g * h * w passes int32 for a large batch of large planes; the
  // reference's planes are rh * rw apart
  const size_t o =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  stage<TILED_THREADS>(cur + (size_t)blockIdx.z * h * w,
                       ref + (size_t)blockIdx.z * rh * rw, w, rh, rw, oy, ox,
                       blockIdx.y * MB, blockIdx.x * MB, win, blk);
  __syncthreads();

  // lane & 3 picks the four block rows this thread holds
  const int r0 = ROWS * (lane & 3);
  int b[ROWS][MB];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < MB; ++c) b[r][c] = blk[r0 + r][c];
  }

  int best = INT_MAX;
  // warp w takes the groups 32 i + 8 w + lane / 4; the loop bound is
  // uniform over the warp, so the shuffles see every lane
  for (int g0 = 8 * warp; g0 < GROUPS; g0 += TILED_THREADS / 4) {
    const bool valid = g0 + (lane >> 2) < GROUPS;
    const int grp = valid ? g0 + (lane >> 2) : GROUPS - 1;
    const int ky = grp / RUNS, kx0 = (grp - ky * RUNS) * RUN;
    unsigned int acc[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) acc[j] = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int* wr = &win[ky + r0 + r][kx0];
      int s[STRIP];
#pragma unroll
      for (int i = 0; i < STRIP; ++i) s[i] = wr[i];
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
#pragma unroll
        for (int c = 0; c < MB; ++c) acc[j] = __sad(b[r][c], s[c + j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      unsigned int v = acc[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if constexpr (MAP) {
        // the group's four lanes share its stores
        if (valid && (lane & 3) == (j & 3)) row_s[ky * ND + kx0 + j] = (int)v;
      } else if (valid) {
        best = min(best, (int)(v << 11) | (ky * ND + kx0 + j));
      }
    }
  }
  if constexpr (MAP) {
    __syncthreads();
    for (int i = tid; i < NCAND; i += TILED_THREADS) {
      map_out[o * NCAND + i] = row_s[i];
    }
    return;
  }
  for (int off = 16; off > 0; off >>= 1) {
    best = min(best, __shfl_down_sync(0xffffffffu, best, off));
  }
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < TILED_THREADS / 32; ++i) best = min(best, warp_best[i]);
    const int k = best & 2047;
    dy_out[o] = k / ND - R;
    dx_out[o] = k % ND - R;
    sad_out[o] = best >> 11;
  }
}

constexpr int EM_THREADS = 288;
constexpr int WPITCH = WIN / 4 + 1;   // packed words per window row, padded

// d = c + sum over the four bytes of |a - b| (one vabsdiff4 with add)
__device__ __forceinline__ unsigned vsad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The even map (see the note at the top of the file).
__global__ void __launch_bounds__(EM_THREADS)
even_map_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
                int h, int w, int* __restrict__ map_out) {
  constexpr int NDS = 17, NCAND = NDS * NDS, ROWS = 2, TPG = MB / ROWS;
  constexpr int RUN = 9, GROUPS = NDS * 2, NWW = WIN * WIN / 4;
  constexpr int NW = (NWW + EM_THREADS - 1) / EM_THREADS;   // 2
  __shared__ unsigned win[WIN][WPITCH];
  __shared__ unsigned blk[MB][MB / 4];
  __shared__ int row_s[NCAND];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t o =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int* cp = cur + (size_t)blockIdx.z * h * w;
  const int* rp = ref + (size_t)blockIdx.z * h * w;
  const int y0 = blockIdx.y * MB, x0 = blockIdx.x * MB;
  int v[NW][4], u[4];
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const int i = min(tid + q * EM_THREADS, NWW - 1);
    const int y = min(max(y0 - R + i / (WIN / 4), 0), h - 1);
    const int c4 = x0 - R + (i % (WIN / 4)) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[q][e] = rp[y * w + min(max(c4 + e, 0), w - 1)];
  }
  const int bi = min(tid, MB * MB / 4 - 1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    u[e] = cp[(y0 + bi / 4) * w + x0 + (bi % 4) * 4 + e];
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const int i = tid + q * EM_THREADS;
    if (i < NWW) {
      win[i / (WIN / 4)][i % (WIN / 4)] =
          v[q][0] | (v[q][1] << 8) | (v[q][2] << 16) | (v[q][3] << 24);
    }
  }
  if (tid < MB * MB / 4) {
    blk[bi / 4][bi % 4] = u[0] | (u[1] << 8) | (u[2] << 16) | (u[3] << 24);
  }
  __syncthreads();

  const int r0 = ROWS * (lane % TPG);
  unsigned b[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int m = 0; m < 4; ++m) b[r][m] = blk[r0 + r][m];
  }
  // one round: warp w takes the groups 4 w + lane / 8
  const bool valid = 4 * warp + lane / TPG < GROUPS;
  const int grp = valid ? 4 * warp + lane / TPG : GROUPS - 1;
  const int ky = grp / 2, kx0 = (grp % 2) * 8;
  unsigned acc[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const unsigned* wr = &win[2 * ky + r0 + r][kx0 / 2];
    unsigned a[8], s[7];
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q] = wr[q];
#pragma unroll
    for (int q = 0; q < 7; ++q) s[q] = __byte_perm(a[q], a[q + 1], 0x5432);
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[j] = vsad4(b[r][m], j % 2 ? s[j / 2 + m] : a[j / 2 + m], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    unsigned v2 = acc[j];
#pragma unroll
    for (int off = 1; off < TPG; off <<= 1) {
      v2 += __shfl_xor_sync(0xffffffffu, v2, off);
    }
    if (valid && lane % TPG == j % TPG) row_s[ky * NDS + kx0 + j] = (int)v2;
  }
  __syncthreads();
  for (int i = tid; i < NCAND; i += EM_THREADS) map_out[o * NCAND + i] = row_s[i];
}

__global__ void __launch_bounds__(THREADS)
sea_kernel(const int* __restrict__ cur, const int* __restrict__ ref, int h,
           int w, int rh, int rw, int oy, int ox, int* __restrict__ dy_out,
           int* __restrict__ dx_out, int* __restrict__ sad_out,
           int* __restrict__ rows_out) {
  __shared__ int win[WIN][WIN + 1];
  __shared__ int blk[MB][MB];
  __shared__ int curc[MB];         // column sums of the block
  __shared__ int winc[ND][WIN];    // 16-row column sums of the window
  __shared__ int rowmin[ND];       // the smallest bound of each dy row
  __shared__ int warp_best[THREADS / 32];
  __shared__ int best_s;           // the running best key sad << 11 | k

  const int bx = blockIdx.x, by = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t o = ((size_t)blockIdx.z * gridDim.y + by) * gridDim.x + bx;
  stage(cur + (size_t)blockIdx.z * h * w, ref + (size_t)blockIdx.z * rh * rw,
        w, rh, rw, oy, ox, by * MB, bx * MB, win, blk);
  if (tid < ND) rowmin[tid] = INT_MAX;
  if (tid == 0) best_s = INT_MAX;
  __syncthreads();

  if (tid < MB) {
    int s = 0;
    for (int r = 0; r < MB; ++r) s += blk[r][tid];
    curc[tid] = s;
  }
  for (int i = tid; i < ND * WIN; i += THREADS) {
    const int ky = i / WIN, x = i % WIN;
    int s = 0;
    for (int r = 0; r < MB; ++r) s += win[ky + r][x];
    winc[ky][x] = s;
  }
  __syncthreads();
  for (int k = tid; k < ND * ND; k += THREADS) {
    const int ky = k / ND, kx = k % ND;
    int lb = 0;
#pragma unroll
    for (int c = 0; c < MB; ++c) lb += abs(curc[c] - winc[ky][kx + c]);
    atomicMin(&rowmin[ky], lb);
  }

  // this thread's share of an exact row: candidate kx = tid / 8 (and, in
  // warp 0, kx = 32 + tid / 8 for tid < 8), block rows 2 (tid % 8) and
  // 2 (tid % 8) + 1, held in registers
  const int r0 = 2 * (tid & 7);
  int b[2][MB];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int c = 0; c < MB; ++c) b[rr][c] = blk[r0 + rr][c];
  }
  __syncthreads();

  int n_rows = 0;
  for (int s = 0; s < ND; ++s) {
    const int ky = R + ((s + 1) >> 1) * (1 - 2 * (s & 1));
    // uniform over the block: rowmin and best_s were written before the
    // last barrier
    if (rowmin[ky] > (best_s >> 11)) continue;
    ++n_rows;
    int key = INT_MAX;
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && tid >= 32) break;  // kx = 32 is warp 0's alone
      const int kx = (tid >> 3) + pass * (THREADS / 8);
      unsigned int acc = 0;
      if (kx < ND) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int c = 0; c < MB; ++c) {
            acc = __sad(b[rr][c], win[ky + r0 + rr][kx + c], acc);
          }
        }
      }
      // whole warps: the 8 threads of a candidate are aligned lanes
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (kx < ND) key = min(key, (int)(acc << 11) | (ky * ND + kx));
    }
    block_min(key, &best_s, warp_best);
  }
  if (tid == 0) {
    const int k = best_s & 2047;
    dy_out[o] = k / ND - R;
    dx_out[o] = k % ND - R;
    sad_out[o] = best_s >> 11;
    if (rows_out != nullptr) rows_out[o] = n_rows;
  }
}

// One block per (g, MB); gridDim.z is limited to 65535. The reference is
// [g, rh, rw] with cur's origin at its row (rh - h) / 2, column (rw - w) / 2:
// each extent is cur's own (no halo on that axis) or cur's plus 2 R.
bool bad_extents(int g, int h, int w, int rh, int rw) {
  return g < 1 || g > 65535 || (rh != h && rh != h + 2 * R) ||
         (rw != w && rw != w + 2 * R);
}

template <bool MAP>
int launch_tiled(const int* cur, const int* ref, int g, int h, int w, int rh,
                 int rw, int* dy, int* dx, int* sad, int* map, void* stream) {
  if (bad_extents(g, h, w, rh, rw)) return (int)cudaErrorInvalidValue;
  const dim3 grid(w / MB, h / MB, g);
  tiled_kernel<MAP><<<grid, TILED_THREADS, 0, (cudaStream_t)stream>>>(
      cur, ref, h, w, rh, rw, (rh - h) / 2, (rw - w) / 2, dy, dx, sad, map);
  return (int)cudaGetLastError();
}

int launch_search(const int* cur, const int* ref, int g, int h, int w, int rh,
                  int rw, int* dy, int* dx, int* sad, void* stream) {
  return launch_tiled<false>(cur, ref, g, h, w, rh, rw, dy, dx, sad, nullptr,
                             stream);
}

int launch_map(const int* cur, const int* ref, int g, int h, int w, int* map,
               void* stream) {
  return launch_tiled<true>(cur, ref, g, h, w, h, w, nullptr, nullptr,
                            nullptr, map, stream);
}

int launch_even_map(const int* cur, const int* ref, int g, int h, int w,
                    int* map, void* stream) {
  if (bad_extents(g, h, w, h, w)) return (int)cudaErrorInvalidValue;
  even_map_kernel<<<dim3(w / MB, h / MB, g), EM_THREADS, 0,
                    (cudaStream_t)stream>>>(cur, ref, h, w, map);
  return (int)cudaGetLastError();
}

int launch_sea(const int* cur, const int* ref, int g, int h, int w, int rh,
               int rw, int* dy, int* dx, int* sad, int* rows, void* stream) {
  if (bad_extents(g, h, w, rh, rw)) return (int)cudaErrorInvalidValue;
  const dim3 grid(w / MB, h / MB, g);
  sea_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cur, ref, h, w, rh, rw, (rh - h) / 2, (rw - w) / 2, dy, dx, sad, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// cur, ref: [h, w] int32 (h, w multiples of 16); dy, dx, sad: [h/16, w/16].
extern "C" int tvc_full_search(const int* cur, const int* ref, int h, int w,
                               int* dy, int* dx, int* sad, void* stream) {
  return launch_search(cur, ref, 1, h, w, h, w, dy, dx, sad, stream);
}

// cur, ref: [h, w] int32 samples 0-255 (h, w multiples of 16); map:
// [h/16, w/16, 289] int32, candidate ((dy+16)/2)*17 + (dx+16)/2.
extern "C" int tvc_sad_map_even(const int* cur, const int* ref, int h, int w,
                                int* map, void* stream) {
  return launch_even_map(cur, ref, 1, h, w, map, stream);
}

// cur, ref: [h, w] int32 (h, w multiples of 16); map: [h/16, w/16, 1089]
// int32, candidate (dy+16)*33 + (dx+16).
extern "C" int tvc_sad_map(const int* cur, const int* ref, int h, int w,
                           int* map, void* stream) {
  return launch_map(cur, ref, 1, h, w, map, stream);
}

// The G-batched search: cur, ref [g, h, w] int32, plane g of cur against
// plane g of ref; dy, dx, sad: [g, h/16, w/16].
extern "C" int tvc_full_search_g(const int* cur, const int* ref, int g, int h,
                                 int w, int* dy, int* dx, int* sad,
                                 void* stream) {
  return launch_search(cur, ref, g, h, w, h, w, dy, dx, sad, stream);
}

// The G-batched even map: cur, ref [g, h, w] int32 samples 0-255; map
// [g, h/16, w/16, 289].
extern "C" int tvc_sad_map_even_g(const int* cur, const int* ref, int g,
                                  int h, int w, int* map, void* stream) {
  return launch_even_map(cur, ref, g, h, w, map, stream);
}

// The G-batched whole map: cur, ref [g, h, w] int32; map [g, h/16, w/16, 1089].
extern "C" int tvc_sad_map_g(const int* cur, const int* ref, int g, int h,
                             int w, int* map, void* stream) {
  return launch_map(cur, ref, g, h, w, map, stream);
}

// The pre-haloed search of g row shards (or 2-D tiles): cur [g, h, w] int32,
// ref_ext [g, rh, rw] int32 with rh = h + 32 and rw = w (columns replicate
// at the edge) or w + 32 (column halo present); dy, dx, sad [g, h/16, w/16].
extern "C" int tvc_full_search_haloed(const int* cur, const int* ref_ext,
                                      int g, int h, int w, int rh, int rw,
                                      int* dy, int* dx, int* sad,
                                      void* stream) {
  if (rh != h + 2 * R) return (int)cudaErrorInvalidValue;
  return launch_search(cur, ref_ext, g, h, w, rh, rw, dy, dx, sad,
                       stream);
}

// The SEA search of tvc_full_search's operands; rows [h/16, w/16] int32,
// the dy rows each MB evaluated exactly, or null.
extern "C" int tvc_full_search_sea(const int* cur, const int* ref, int h,
                                   int w, int* dy, int* dx, int* sad,
                                   int* rows, void* stream) {
  return launch_sea(cur, ref, 1, h, w, h, w, dy, dx, sad, rows, stream);
}

// The SEA search of tvc_full_search_g's operands.
extern "C" int tvc_full_search_sea_g(const int* cur, const int* ref, int g,
                                     int h, int w, int* dy, int* dx, int* sad,
                                     void* stream) {
  return launch_sea(cur, ref, g, h, w, h, w, dy, dx, sad, nullptr, stream);
}

// The SEA search of tvc_full_search_haloed's operands.
extern "C" int tvc_full_search_sea_haloed(const int* cur, const int* ref_ext,
                                          int g, int h, int w, int rh, int rw,
                                          int* dy, int* dx, int* sad,
                                          void* stream) {
  if (rh != h + 2 * R) return (int)cudaErrorInvalidValue;
  return launch_sea(cur, ref_ext, g, h, w, rh, rw, dy, dx, sad, nullptr,
                    stream);
}
