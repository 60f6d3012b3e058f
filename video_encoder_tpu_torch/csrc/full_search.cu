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
// with TVC_SEA=1 by full_search, its batched twin and full_search_pre_haloed;
// full_search_sea_stats also returns the count of dy rows evaluated exactly):
// successive elimination, in sea_kernel. Its bound on this card is the rows
// it evaluates, on words of four 8-bit samples, plus 1089 x 16 bound terms
// per MB. Design: one block of 128 threads per MB stages the window and the
// block as words of four samples (0-255, as every plane of the codec holds;
// the wrappers say so). Up front, all integer and none of it depending on the
// running best: the block's 16 column sums, the window's 16-row column sums
// at each of the 33 row offsets as sliding sums (96 threads, a column half
// each: 16 adds, then an add and a subtract per row offset, every sample
// loaded first), and each dy row's smallest bound LB = sum_c |curc[c] -
// winc[ky][kx + c]| over its 33 candidates (a lane pair per row, 17
// candidates each from a strip of 32 column sums in registers, the pair's
// minimum by one xor shuffle; the sums' row pitch of 49 words keeps the
// strips' loads free of bank conflicts). Then the rows in batches, not one by
// one: the first SEA_FIRST rows of the reference's centre-out order (dy = 0,
// -1, +1, -2, +2) are evaluated exactly; their best B is the sequential
// search's best after those rows (a row it pruned holds no SAD below its best
// then). Every later row whose smallest bound is <= B goes into a compacted
// list (a ballot of warp 0) and is evaluated in a second batch. The
// sequential search's best only falls, so it evaluates a subset of these
// rows, and a row evaluated here that it pruned has every SAD >= LB > its
// best then >= the final SAD: the packed-key first minimum over the evaluated
// rows, ties included, is the exhaustive search's, in five barriers per MB.
// An exact row is the exhaustive search's tiling (groups of 11 adjacent
// candidates x 4 lanes of four block rows, two xor shuffles) on packed words:
// a lane loads the 8 words of a block row's strip, shifts them to the run's
// first sample with one byte_perm each and by 1-3 samples more for the other
// candidates, and makes each candidate row with four vabsdiff4
// (run_sads_packed): a third of the instructions of one __sad per sample
// pair, on which this kernel was issue-bound. The bounds of the first batch's
// rows decide nothing and are skipped, except for the row count:
// full_search_sea_stats replays the count the sequential search evaluates
// from the rows' minima (walk the centre-out order; a row counts iff its
// smallest bound is <= the running best). The reference counts rows per tile
// of MBs (a tile evaluates a row iff one of its MBs needs it); here each MB
// counts its own, and the reference's count of a tile is the OR of its MBs'
// row masks, because a row an MB would prune cannot lower that MB's best.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int MB = 16;
constexpr int R = 16;
constexpr int ND = 2 * R + 1;     // 33
constexpr int WIN = MB + 2 * R;   // 48

// Stages the MB's clamped 48x48 reference window and its 16x16 block with
// NT threads; the caller synchronises. cur and ref point at the block's
// plane. Every thread issues all its loads before its first store, so a
// block waits for one round trip to memory, not one per element.
template <int NT>
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

// dy row index ky = dy + R of step s of the reference's centre-out order
// (dy = 0, -1, +1, -2, +2, ...; ops/motion.py SEA_ORDER)
__device__ __forceinline__ int sea_row(int s) {
  return R + ((s + 1) >> 1) * (1 - 2 * (s & 1));
}

constexpr int SEA_THREADS = 128;   // four warps per MB
constexpr int SEA_FIRST = 5;       // rows of the first batch

// four 8-bit samples in one word, the first in the low byte
__device__ __forceinline__ unsigned pack4(const int (&v)[4]) {
  return v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
}

// Stages the MB's clamped 48x48 reference window and its 16x16 block as
// words of four 8-bit samples (a window row is 12 words and a zero pad
// word); the caller synchronises. Every thread issues all its loads before
// its first store.
__device__ __forceinline__ void stage_packed(const int* __restrict__ cur,
                                             const int* __restrict__ ref,
                                             int w, int rh, int rw, int oy,
                                             int ox, int y0, int x0,
                                             unsigned (*win)[WPITCH],
                                             unsigned (*blk)[MB / 4]) {
  constexpr int NWW = WIN * WIN / 4;
  constexpr int NQ = (NWW + SEA_THREADS - 1) / SEA_THREADS;
  const int tid = threadIdx.x;
  int v[NQ][4], u[4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = min(tid + q * SEA_THREADS, NWW - 1);
    const int y = min(max(y0 - R + i / (WIN / 4) + oy, 0), rh - 1);
    const int c4 = x0 - R + (i % (WIN / 4)) * 4 + ox;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[q][e] = ref[y * rw + min(max(c4 + e, 0), rw - 1)];
  }
  const int bi = min(tid, MB * MB / 4 - 1);
#pragma unroll
  for (int e = 0; e < 4; ++e) u[e] = cur[(y0 + bi / 4) * w + x0 + (bi % 4) * 4 + e];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = tid + q * SEA_THREADS;
    if (i < NWW) win[i / (WIN / 4)][i % (WIN / 4)] = pack4(v[q]);
  }
  if (tid < MB * MB / 4) blk[bi / 4][bi % 4] = pack4(u);
  if (tid < WIN) win[tid][WIN / 4] = 0u;
}

// The SADs of the run of RUN candidates (ky, kx0 .. kx0 + RUN - 1) over
// this lane's four block rows (four words each), on packed words. Per block row the lane loads the 8 words that hold the run's
// strip of 26 samples and shifts them to start at sample kx0 (one
// byte_perm each, its selector set by kx0 % 4); the candidates at 1, 2 and
// 3 samples further read the strip shifted once more; each candidate row
// is four vabsdiff4 (four abs-diffs and their sum each). Then the group's
// four lanes' partial sums meet in two xor shuffles.
__device__ __forceinline__ void run_sads_packed(const unsigned (&b)[ROWS][MB / 4],
                                                const unsigned (*win)[WPITCH],
                                                int ky, int kx0, int r0,
                                                unsigned int (&acc)[RUN]) {
  const unsigned sel = 0x3210u + 0x1111u * (kx0 & 3);
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const unsigned* wr = &win[ky + r0 + r][kx0 >> 2];
    unsigned a[8], sh[4][6];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = wr[i];
    unsigned t[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) t[i] = __byte_perm(a[i], a[i + 1], sel);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        sh[s][i] = s == 0 ? t[i] : __byte_perm(t[i], t[i + 1], 0x3210u + 0x1111u * s);
      }
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
#pragma unroll
      for (int m = 0; m < MB / 4; ++m) {
        acc[j] = vsad4(b[r][m], sh[j & 3][(j >> 2) + m], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
  }
}

// Evaluates n_rows dy rows exactly, row q of the batch being row_of(q),
// on the register tiling of the exhaustive search: group gi is run gi %
// RUNS of row gi / RUNS, and warp w takes the groups 32 i + 8 w + lane / 4
// (the loop bound is uniform over the warp, so the shuffles see every
// lane). Each group's smallest key sad << 11 | k goes to its row's slot of
// rowkey.
template <class RowOf>
__device__ __forceinline__ void sea_rows(const unsigned (&b)[ROWS][MB / 4],
                                         const unsigned (*win)[WPITCH],
                                         int r0, int n_rows, RowOf row_of,
                                         int* rowkey) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_groups = n_rows * RUNS;
  for (int g0 = 8 * warp; g0 < n_groups; g0 += SEA_THREADS / 4) {
    const bool valid = g0 + (lane >> 2) < n_groups;
    const int gi = valid ? g0 + (lane >> 2) : n_groups - 1;
    const int q = gi / RUNS;
    const int ky = row_of(q), kx0 = (gi - q * RUNS) * RUN;
    unsigned int acc[RUN];
    run_sads_packed(b, win, ky, kx0, r0, acc);
    int key = INT_MAX;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      key = min(key, (int)(acc[j] << 11) | (ky * ND + kx0 + j));
    }
    if (valid && (lane & 3) == 0) atomicMin(&rowkey[ky], key);
  }
}

__global__ void __launch_bounds__(SEA_THREADS)
sea_kernel(const int* __restrict__ cur, const int* __restrict__ ref, int h,
           int w, int rh, int rw, int oy, int ox, int* __restrict__ dy_out,
           int* __restrict__ dx_out, int* __restrict__ sad_out,
           int* __restrict__ rows_out) {
  __shared__ unsigned win[WIN][WPITCH];
  __shared__ unsigned blk[MB][MB / 4];
  __shared__ int curc[MB];           // column sums of the block
  __shared__ int winc[ND][WIN + 1];  // 16-row column sums of the window
  __shared__ int rowmin[ND];         // the smallest bound of each dy row
  __shared__ int rowkey[ND];         // the smallest key of each evaluated row
  __shared__ int later[ND];          // the second batch's rows, compacted
  __shared__ int n_later;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t o =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  stage_packed(cur + (size_t)blockIdx.z * h * w,
               ref + (size_t)blockIdx.z * rh * rw, w, rh, rw, oy, ox,
               blockIdx.y * MB, blockIdx.x * MB, win, blk);
  if (tid < ND) rowkey[tid] = INT_MAX;
  __syncthreads();

  // column sums: task x < 48 slides down column x over the row offsets
  // 0..16, task 48 + x over 17..32 (all its samples loaded first, one
  // byte_perm each); tasks 96..111 sum the block's
  if (tid < 2 * WIN) {
    const int x = tid % WIN, k0 = tid < WIN ? 0 : ND / 2 + 1;
    const unsigned pick = 0x4440u | (x & 3);
    int a[2 * MB];
#pragma unroll
    for (int j = 0; j < 2 * MB; ++j) {
      a[j] = __byte_perm(win[min(k0 + j, WIN - 1)][x >> 2], 0u, pick);
    }
    int sum = 0;
#pragma unroll
    for (int j = 0; j < MB; ++j) sum += a[j];
    winc[k0][x] = sum;
#pragma unroll
    for (int j = 1; j <= ND / 2; ++j) {
      if (k0 + j < ND) {
        sum += a[j + MB - 1] - a[j - 1];
        winc[k0 + j][x] = sum;
      }
    }
  } else if (tid < 2 * WIN + MB) {
    const int c = tid - 2 * WIN;
    int sum = 0;
#pragma unroll
    for (int r = 0; r < MB; ++r) sum += __byte_perm(blk[r][c >> 2], 0u, 0x4440u | (c & 3));
    curc[c] = sum;
  }
  __syncthreads();

  // each row's smallest bound: tasks 2 q and 2 q + 1 take the candidates
  // kx = 0..16 and 16..32 of row sea_row(first + q) from a strip of 32
  // column sums, a lane pair of one warp (the loop bound is uniform over
  // the warp). The first batch's rows matter only to the row count.
  const int first = rows_out != nullptr ? 0 : SEA_FIRST;
  const int n_tasks = 2 * (ND - first);
  for (int t0 = 32 * warp; t0 < n_tasks; t0 += SEA_THREADS) {
    const int task = min(t0 + lane, n_tasks - 1);
    const int ky = sea_row(first + (task >> 1)), kx0 = (task & 1) * (ND / 2);
    int c[MB], sv[2 * MB];
#pragma unroll
    for (int i = 0; i < MB; ++i) c[i] = curc[i];
#pragma unroll
    for (int i = 0; i < 2 * MB; ++i) sv[i] = winc[ky][kx0 + i];
    int m = INT_MAX;
#pragma unroll
    for (int j = 0; j <= ND / 2; ++j) {
      unsigned int lb = 0;
#pragma unroll
      for (int i = 0; i < MB; ++i) lb = __sad(c[i], sv[i + j], lb);
      m = min(m, (int)lb);
    }
    m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
    if (t0 + lane < n_tasks && (lane & 1) == 0) rowmin[ky] = m;
  }

  // lane & 3 picks the four block rows this thread holds
  const int r0 = ROWS * (lane & 3);
  unsigned b[ROWS][MB / 4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int m = 0; m < MB / 4; ++m) b[r][m] = blk[r0 + r][m];
  }

  // the first batch: the first SEA_FIRST rows of the centre-out order
  sea_rows(b, win, r0, SEA_FIRST, [](int q) { return sea_row(q); }, rowkey);
  __syncthreads();

  // the second batch: every later row whose smallest bound is <= the
  // first batch's best SAD, compacted in order by a ballot of warp 0
  if (warp == 0) {
    int best = INT_MAX;
#pragma unroll
    for (int q = 0; q < SEA_FIRST; ++q) best = min(best, rowkey[sea_row(q)]);
    const int ky = sea_row(min(SEA_FIRST + lane, ND - 1));
    const bool keep = SEA_FIRST + lane < ND && rowmin[ky] <= (best >> 11);
    const unsigned int mask = __ballot_sync(0xffffffffu, keep);
    if (keep) later[__popc(mask & ((1u << lane) - 1))] = ky;
    if (lane == 0) n_later = __popc(mask);
  }
  __syncthreads();
  sea_rows(b, win, r0, n_later, [&](int q) { return later[q]; }, rowkey);
  __syncthreads();

  if (warp == 0) {
    // every row the sequential search evaluates was evaluated here, so
    // the smallest key is its result
    int key = min(rowkey[lane], lane == 0 ? rowkey[ND - 1] : INT_MAX);
    for (int off = 16; off > 0; off >>= 1) {
      key = min(key, __shfl_down_sync(0xffffffffu, key, off));
    }
    if (lane == 0) {
      const int k = key & 2047;
      dy_out[o] = k / ND - R;
      dx_out[o] = k % ND - R;
      sad_out[o] = key >> 11;
      if (rows_out != nullptr) {
        // the sequential count, replayed from the rows' minima
        int best = INT_MAX, n = 0;
        for (int st = 0; st < ND; ++st) {
          const int ky = sea_row(st);
          if (rowmin[ky] <= (best >> 11)) {
            ++n;
            best = min(best, rowkey[ky]);
          }
        }
        rows_out[o] = n;
      }
    }
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
  sea_kernel<<<grid, SEA_THREADS, 0, (cudaStream_t)stream>>>(
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
