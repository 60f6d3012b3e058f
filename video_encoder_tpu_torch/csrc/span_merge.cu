// Span merge of the chunk-emit pack: piece strings -> longer span strings,
// in two stages.
//
// Replaces: video_encoder_tpu/ops/pallas/pack.py,
//   - _make_mb_stage1_kernel (public super_merge_mb): per-MB sources
//     (header, Y00..Y11, Cb, Cr word strings and the piece bit counts) ->
//     stage-1 strings of m pieces each: tvc_span_merge_mb;
//   - _make_reduce_kernel -> _reduce (public super_merge): groups of
//     stage-1 strings -> the frame's span strings: tvc_span_merge;
//   - _make_chunk_kernel -> _chunk_call (public chunk_merge, pack.py:102,
//     121, 200): each run of k piece strings -> two half-chunk strings of
//     k/2 pieces, at the exact worst-case width (k/2) w + 1, so no string
//     can overflow: tvc_chunk_merge, with no overflow flag. No encode path
//     calls it, here or in the reference (its tests and pack micro-bench
//     do); at a 1080p frame's 65536 pieces of 24 words (k = 1024) it
//     writes 128 strings of 12289 words, and each block's string takes
//     (512 + 12289) x 4 = 51,204 bytes of shared memory, over the 48 KB a
//     launch gets without opting in (launch() below opts in).
//
// Bound on this card: neither ALU nor bandwidth at 1080p. Stage 1 reads
// 8160 MBs x 7 pieces x 16 words (7 MB of int64) and writes 512 strings of
// 513 words; stage 2 reads those and writes 128 strings of 2049 words.
// What costs is the placement of each word at a data-dependent bit offset.
//
// Design: one block per output string. Its threads load the bit counts of
// the string's pieces, take a block-wide exclusive scan (each thread sums
// a run of pieces, then warp shuffles and one warp over the warp totals),
// and keep the piece offsets in shared memory. Then each thread takes
// (piece, word) pairs: word j of a piece at bit offset o lands shifted
// right by o % 32 in output word o / 32 + j, and its low bits in the next
// word. The pieces' bit ranges are disjoint, so the pairs OR into a
// shared-memory string of cw words with atomicOr in any order; words past
// cw are dropped. The string's true bit count is written beside it, and a
// string longer than 32 * cw bits raises the overflow flag. This is the
// prefix-sum placement of the port's frame_concat; the TPU's log-step
// pairwise merge levels and their scoped-VMEM budgets were TPU layout
// choices and have no counterpart here. Words are int64 holding 32-bit
// values, as block_pack.cu writes them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Pieces of the per-MB sources, 8 per MB in the order header, Y00, Y01,
// Y10, Y11, Cb, Cr, empty. Piece gi >= 8 * n_mbs is an empty pad piece.
struct MbSource {
  const long long* hw;   // [n_mbs, hww]
  const long long* yw;   // [n_mbs, 4, w]
  const long long* cbw;  // [n_mbs, w]
  const long long* crw;  // [n_mbs, w]
  const int* pbits;      // [n_mbs * 8]
  int n_mbs, hww, w;

  __device__ int width() const { return w; }
  __device__ int bits(int gi) const {
    return gi < 8 * n_mbs ? pbits[gi] : 0;
  }
  __device__ unsigned int word(int gi, int j) const {
    const int mb = gi >> 3, slot = gi & 7;
    if (mb >= n_mbs) return 0u;
    const size_t m = (size_t)mb;
    switch (slot) {
      case 0: return j < hww ? (unsigned int)hw[m * hww + j] : 0u;
      case 1: case 2: case 3: case 4:
        return (unsigned int)yw[(m * 4 + slot - 1) * w + j];
      case 5: return (unsigned int)cbw[m * w + j];
      case 6: return (unsigned int)crw[m * w + j];
      default: return 0u;
    }
  }
};

// Strings [n, w] with bit counts [n], taken in order.
struct FlatSource {
  const long long* words;
  const int* pbits;
  int n, w;

  __device__ int width() const { return w; }
  __device__ int bits(int gi) const { return gi < n ? pbits[gi] : 0; }
  __device__ unsigned int word(int gi, int j) const {
    return gi < n ? (unsigned int)words[(size_t)gi * w + j] : 0u;
  }
};

// Output string s concatenates pieces [s*m, (s+1)*m) of src.
template <class Source>
__global__ void __launch_bounds__(THREADS)
merge_kernel(Source src, int m, int cw, long long* __restrict__ out,
             int* __restrict__ bits_out, unsigned char* __restrict__ ovf) {
  extern __shared__ unsigned int smem[];
  int* offs = (int*)smem;            // [m] piece bit offsets
  unsigned int* buf = smem + m;      // [cw] output words
  __shared__ int warp_tot[THREADS / 32];

  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = s * m;
  const int per = (m + THREADS - 1) / THREADS;
  const int i0 = min(tid * per, m), i1 = min(i0 + per, m);

  int local = 0;
  for (int i = i0; i < i1; ++i) local += src.bits(base + i);
  int v = local;  // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  for (int c = tid; c < cw; c += THREADS) buf[c] = 0u;
  __syncthreads();
  if (warp == 0) {
    int t = lane < THREADS / 32 ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += n;
    }
    if (lane < THREADS / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  int run = v - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    offs[i] = run;
    run += src.bits(base + i);
  }
  __syncthreads();

  const int w = src.width();
  for (int it = tid; it < m * w; it += THREADS) {
    const int i = it / w, j = it % w;
    const unsigned int word = src.word(base + i, j);
    if (word == 0u) continue;
    const int o = offs[i];
    const int t = (o >> 5) + j, sh = o & 31;
    if (t < cw) atomicOr(&buf[t], word >> sh);
    if (sh != 0 && t + 1 < cw) atomicOr(&buf[t + 1], word << (32 - sh));
  }
  __syncthreads();

  for (int c = tid; c < cw; c += THREADS) {
    out[(size_t)s * cw + c] = (long long)buf[c];
  }
  if (tid == 0) {
    const int total = warp_tot[THREADS / 32 - 1];
    bits_out[s] = total;
    if (ovf != nullptr && (long long)total > 32LL * cw) *ovf = 1;
  }
}

// ovf may be null where no string can be longer than cw words.
template <class Source>
int launch(const Source& src, int m, int cw, int n_out, long long* out,
           int* bits, unsigned char* ovf, cudaStream_t stream) {
  if (ovf != nullptr) cudaMemsetAsync(ovf, 0, 1, stream);
  const size_t smem = (size_t)(m + cw) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(merge_kernel<Source>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  if (n_out > 0) {
    merge_kernel<Source><<<n_out, THREADS, smem, stream>>>(src, m, cw, out,
                                                           bits, ovf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Stage 1. hw [n_mbs, hww], yw [n_mbs, 4, w], cbw, crw [n_mbs, w] int64;
// piece_bits [n_mbs * 8] int32 in piece order. Output string s holds
// pieces [s*m, (s+1)*m) (pieces past 8 * n_mbs are empty): out
// [n_out, cw] int64, bits [n_out] int32, ovf [1] bool.
extern "C" int tvc_span_merge_mb(const long long* hw, const long long* yw,
                                 const long long* cbw, const long long* crw,
                                 const int* piece_bits, int n_mbs, int hww,
                                 int w, int m, int cw, int n_out,
                                 long long* out, int* bits,
                                 unsigned char* ovf, void* stream) {
  const MbSource src{hw, yw, cbw, crw, piece_bits, n_mbs, hww, w};
  return launch(src, m, cw, n_out, out, bits, ovf, (cudaStream_t)stream);
}

// Stage 2. strings [n, w] int64, bits_in [n] int32; output string s
// concatenates strings [s*m, (s+1)*m): out [n_out, cw], bits [n_out], ovf.
extern "C" int tvc_span_merge(const long long* strings, const int* bits_in,
                              int n, int w, int m, int cw, int n_out,
                              long long* out, int* bits, unsigned char* ovf,
                              void* stream) {
  const FlatSource src{strings, bits_in, n, w};
  return launch(src, m, cw, n_out, out, bits, ovf, (cudaStream_t)stream);
}

// chunk_merge: words [n, w] int64, bits_in [n] int32, n a multiple of k
// (k even); output string s concatenates pieces [s*k/2, (s+1)*k/2): out
// [2n/k, (k/2) w + 1] int64, bits [2n/k] int32.
extern "C" int tvc_chunk_merge(const long long* words, const int* bits_in,
                               int n, int w, int k, long long* out,
                               int* bits, void* stream) {
  if (k < 2 || k % 2 != 0 || n % k != 0) return (int)cudaErrorInvalidValue;
  const FlatSource src{words, bits_in, n, w};
  const int m = k / 2;
  return launch(src, m, m * w + 1, n / m, out, bits, nullptr,
                (cudaStream_t)stream);
}
