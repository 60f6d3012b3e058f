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
//     writes 128 strings of 12289 words.
//
// Bound on this card: neither ALU nor bandwidth at 1080p. Stage 1 reads
// 8160 MBs x 7 pieces' used words (a few MB) and writes 512
// strings of 513 words; stage 2 reads those and writes 128 strings of 2049
// words. What costs is latency: a string's bit counts, then its pieces'
// words, the prefix scan and the store, in a few microseconds.
//
// Design: one block per output string, 256 threads (1024 where a string has
// more than 512 tasks: chunk_merge's 512 pieces of 24 words). A piece of u
// used words, u = min(ceil(bits / 32), its width), at bit offset o = 32 T + r
// makes the output words T + q, q = 0..u (q = u only if r != 0): its word q
// >> r ored with its word q - 1 << (32 - r), a funnel shift of two
// neighbours. Task (i, c) is positions [8 c, 8 c + 8) of piece i, and thread
// t takes tasks t, t + NT, ... As soon as a thread has its pieces' bit counts
// it loads its tasks' words (only used words: the pieces must hold zeros past
// their bit counts, which every producer does, the same condition under which
// the plain version's add equals an or), so the loads run under the block's
// exclusive scan of the bit counts (each thread a run of pieces, warp
// shuffles, one warp over the warp totals). Then each task makes its output
// words in a shared copy of the string: a word wholly inside its piece's bits
// is stored, and only a word that holds a piece boundary is ored in
// (atomicOr). Words past cw are dropped, and the string leaves as coalesced
// 32-bit stores. The string's true bit count is written beside it. The
// overflow flag (a string longer than 32 * cw bits) is derived in the same
// launch: each block adds one ticket and its verdict to a device-wide word
// with one atomic, issued after the scan and read at the end, and the last
// block writes the flag and resets the word, so a call is one device op. The
// ticket is one per device: two merges must not run at once on two streams
// (the port launches every kernel on the current stream). This is the
// prefix-sum placement of the port's frame_concat; the TPU's log-step
// pairwise merge levels and their scoped-VMEM budgets were TPU layout choices
// and have no counterpart here. Words are 32 bits in and out, as
// block_pack.cu writes them (int32 tensors holding uint32 bit patterns).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;           // output positions of a piece per task
constexpr int MAX_PIECES = 1024;   // pieces per string (scan: 4 per thread)

// tasks per thread: two in a block of 256 threads (few registers, so a
// frame's 512 stage-1 strings run in one wave), three in one of 1024
// (whose 64 registers a thread must not pass)
template <int NT>
__host__ __device__ constexpr int tasks_per_thread() {
  return NT == 256 ? 2 : 3;
}

// the overflow flag's ticket: the low 20 bits count the strings done, the
// rest the strings that overflowed; the last string's block resets it
__device__ unsigned int merge_tickets = 0;
constexpr unsigned int TICKET_BITS = 20;

// Pieces of the per-MB sources, 8 per MB in the order header, Y00, Y01,
// Y10, Y11, Cb, Cr, empty. Piece gi >= 8 * n_mbs is an empty pad piece.
struct MbSource {
  const unsigned int* hw;   // [n_mbs, hww]
  const unsigned int* yw;   // [n_mbs, 4, w]
  const unsigned int* cbw;  // [n_mbs, w]
  const unsigned int* crw;  // [n_mbs, w]
  const int* pbits;      // [n_mbs * 8]
  int n_mbs, hww, w;

  __host__ __device__ int max_width() const { return w > hww ? w : hww; }
  __device__ int bits(int gi) const {
    return gi < 8 * n_mbs ? __ldg(pbits + gi) : 0;
  }
  // the words of a piece with bits and how many it holds
  __device__ const unsigned int* words(int gi, int& cap) const {
    const size_t m = (size_t)(gi >> 3);
    cap = w;
    switch (gi & 7) {
      case 0: cap = hww; return hw + m * hww;
      case 1: case 2: case 3: case 4:
        return yw + (m * 4 + (gi & 7) - 1) * w;
      case 5: return cbw + m * w;
      case 6: return crw + m * w;
      default: cap = 0; return nullptr;
    }
  }
};

// Strings [n, w] with bit counts [n], taken in order.
struct FlatSource {
  const unsigned int* strings;
  const int* pbits;
  int n, w;

  __host__ __device__ int max_width() const { return w; }
  __device__ int bits(int gi) const { return gi < n ? __ldg(pbits + gi) : 0; }
  __device__ const unsigned int* words(int gi, int& cap) const {
    cap = w;
    return strings + (size_t)gi * w;
  }
};

// Output string s (blockIdx.x) concatenates pieces [s*m, (s+1)*m) of src.
// A piece of u used words at bit offset o = 32 T + r makes the output
// words T + q, q = 0..u (q = u only if r != 0): word q is its word q >> r
// ored with its word q - 1 << (32 - r), a funnel shift of two neighbours.
// Task (i, c) of the block is positions [c CHUNK, (c + 1) CHUNK) of piece
// i; thread t takes tasks t, t + NT, ... (at most TASKS).
template <class Source, int NT, int TASKS = tasks_per_thread<NT>()>
__global__ void __launch_bounds__(NT)
merge_kernel(Source src, int m, int cw, unsigned int* __restrict__ out,
             int* __restrict__ bits_out, unsigned char* __restrict__ ovf) {
  extern __shared__ unsigned int smem[];
  int* offs = (int*)smem;            // [m] piece bit offsets
  unsigned int* buf = smem + m;      // [cw] the output string
  __shared__ int warp_tot[NT / 32];

  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = s * m;
  const int chunks = (src.max_width() + CHUNK) / CHUNK;   // per piece

  // every bit count this thread needs, its tasks' and its run of the
  // scan's pieces, loaded first; then each task's words, loaded before the
  // scan: positions c CHUNK - 1 .. c CHUNK + CHUNK - 1 of its piece's used
  // words (zero elsewhere)
  const int per = (m + NT - 1) / NT;
  const int i0 = min(tid * per, m), i1 = min(i0 + per, m);
  int tbits[TASKS], nb[4];
#pragma unroll
  for (int k = 0; k < TASKS; ++k) {
    const int i = (tid + k * NT) / chunks;
    tbits[k] = i < m ? src.bits(base + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) nb[k] = i0 + k < i1 ? src.bits(base + i0 + k) : 0;
  unsigned int wd[TASKS][CHUNK + 1];
  int tused[TASKS];
#pragma unroll
  for (int k = 0; k < TASKS; ++k) {
    const int task = tid + k * NT, i = task / chunks, c = task % chunks;
    int cap = 0;
    const unsigned int* p = i < m ? src.words(base + i, cap) : nullptr;
    tused[k] = min((tbits[k] + 31) >> 5, cap);
#pragma unroll
    for (int e = 0; e <= CHUNK; ++e) {
      const int j = c * CHUNK - 1 + e;
      wd[k][e] = j >= 0 && j < tused[k] ? __ldg(p + j) : 0u;
    }
  }

  // the exclusive scan of the piece bit counts (each thread a run of up
  // to four pieces, warp shuffles, one warp over the warp totals)
  int local = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) local += nb[k];
  int v = local;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  for (int t = tid; t < cw; t += NT) buf[t] = 0u;
  __syncthreads();
  if (warp == 0) {
    int t = lane < NT / 32 ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += n;
    }
    if (lane < NT / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  int run = v - local + (warp > 0 ? warp_tot[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < i1) offs[i0 + k] = run;
    run += nb[k];
  }
  const int total = warp_tot[NT / 32 - 1];
  unsigned int ticket = 0;   // read only after the placement
  if (tid == 0) {
    bits_out[s] = total;
    if (ovf != nullptr) {
      ticket = atomicAdd(&merge_tickets, 1u + ((unsigned int)(
          (long long)total > 32LL * cw) << TICKET_BITS));
    }
  }
  __syncthreads();

  // place: a word wholly inside the piece's bits is this task's alone and
  // is stored; a word that holds a piece boundary is ored in
#pragma unroll
  for (int k = 0; k < TASKS; ++k) {
    const int task = tid + k * NT, i = task / chunks, c = task % chunks;
    if (i >= m || tbits[k] == 0) continue;
    const int o = offs[i], r = o & 31, u = tused[k];
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      const int q = c * CHUNK + e;
      if (q > u || (q == u && r == 0)) break;
      const unsigned int word = r == 0 ? wd[k][e + 1]
          : __funnelshift_l(wd[k][e + 1], wd[k][e], 32 - r);
      const int t = (o >> 5) + q;
      if (t >= cw) break;
      if (32 * t >= o && 32 * t + 32 <= o + tbits[k]) {
        buf[t] = word;
      } else if (word != 0u) {
        atomicOr(&buf[t], word);
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < cw; t += NT) out[(size_t)s * cw + t] = buf[t];

  if (tid == 0 && ovf != nullptr &&
      (ticket & ((1u << TICKET_BITS) - 1)) == gridDim.x - 1) {
    const unsigned int over = (ticket >> TICKET_BITS) +
                              ((long long)total > 32LL * cw);
    *ovf = over != 0u;
    atomicExch(&merge_tickets, 0u);
  }
}

// ovf may be null where no string can be longer than cw words.
template <class Source>
int launch(const Source& src, int m, int cw, int n_out, unsigned int* out,
           int* bits, unsigned char* ovf, cudaStream_t stream) {
  const int tasks = m * ((src.max_width() + CHUNK) / CHUNK);
  if (m < 1 || m > MAX_PIECES || tasks > tasks_per_thread<1024>() * 1024 ||
      n_out >= (1 << TICKET_BITS)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) {   // no string: the flag is all there is to write
    if (ovf != nullptr) cudaMemsetAsync(ovf, 0, 1, stream);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(m + cw) * sizeof(unsigned int);
  auto kernel = tasks <= tasks_per_thread<256>() * 256
      ? merge_kernel<Source, 256> : merge_kernel<Source, 1024>;
  const int nt = tasks <= tasks_per_thread<256>() * 256 ? 256 : 1024;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  kernel<<<n_out, nt, smem, stream>>>(src, m, cw, out, bits, ovf);
  return (int)cudaGetLastError();
}

}  // namespace

// Words are 32-bit in and out (int32 tensors holding uint32 bit patterns).
// Stage 1. hw [n_mbs, hww], yw [n_mbs, 4, w], cbw, crw [n_mbs, w] words;
// piece_bits [n_mbs * 8] int32 in piece order. Output string s holds
// pieces [s*m, (s+1)*m) (pieces past 8 * n_mbs are empty): out
// [n_out, cw] words, bits [n_out] int32, ovf [1] bool.
extern "C" int tvc_span_merge_mb(const unsigned int* hw,
                                 const unsigned int* yw,
                                 const unsigned int* cbw,
                                 const unsigned int* crw,
                                 const int* piece_bits, int n_mbs, int hww,
                                 int w, int m, int cw, int n_out,
                                 unsigned int* out, int* bits,
                                 unsigned char* ovf, void* stream) {
  const MbSource src{hw, yw, cbw, crw, piece_bits, n_mbs, hww, w};
  return launch(src, m, cw, n_out, out, bits, ovf, (cudaStream_t)stream);
}

// Stage 2. strings [n, w] words, bits_in [n] int32; output string s
// concatenates strings [s*m, (s+1)*m): out [n_out, cw] words, bits [n_out],
// ovf.
extern "C" int tvc_span_merge(const unsigned int* strings, const int* bits_in,
                              int n, int w, int m, int cw, int n_out,
                              unsigned int* out, int* bits, unsigned char* ovf,
                              void* stream) {
  const FlatSource src{strings, bits_in, n, w};
  return launch(src, m, cw, n_out, out, bits, ovf, (cudaStream_t)stream);
}

// chunk_merge: words [n, w], bits_in [n] int32, n a multiple of k (k even);
// output string s concatenates pieces [s*k/2, (s+1)*k/2): out
// [2n/k, (k/2) w + 1] words, bits [2n/k] int32.
extern "C" int tvc_chunk_merge(const unsigned int* words, const int* bits_in,
                               int n, int w, int k, unsigned int* out,
                               int* bits, void* stream) {
  if (k < 2 || k % 2 != 0 || n % k != 0) return (int)cudaErrorInvalidValue;
  const FlatSource src{words, bits_in, n, w};
  const int m = k / 2;
  return launch(src, m, m * w + 1, n / m, out, bits, nullptr,
                (cudaStream_t)stream);
}
