// Exp-Golomb symbols of each 8x8 block, packed MSB-first into that block's
// own string of n_words 32-bit words, in the format-1 syntax or the
// format-2 syntax (DC prediction; formats 3 and 4 share it).
//
// Replaces: video_encoder_tpu/ops/pallas/entropy_pack.py,
// _make_block_pack_kernel (launched by _block_pack_call, public
// block_pack), fmt 1 and fmt >= 2.
//
// Bound on this card: device memory. A 1088x1920 luma plane is 32640
// blocks: 8.4 MB of int32 levels in, and at n_words = 16 the strings'
// 32-bit words (2.1 MB) and the bit counts out; a 0.0032 ms bound at
// 3.35 TB/s.
//
// Design: one warp per block. Lane l loads levels l and l + 32, so each of
// the block's two 128-byte halves arrives in one coalesced access and the
// nonzero mask is two __ballot_sync words, bit p for scan position p (the
// AC positions only in format 2, whose runs count from position 1). A
// lane owns the (run, level) pair of each of its nonzero positions: the
// run is the distance to the mask's previous set bit (__clz), and the
// pair is one code, ue(run) then se(level), of at most 13 + 25 = 38 bits.
// An exclusive warp scan of the two pairs' lengths (both halves at once,
// 16 bits each) gives each code its bit offset after the header (cbf and
// ue(nnz - 1) in format 1; cbf, se(dc - dc_pred) and ue(nnz_ac) in format
// 2: at most 41 bits, one 64-bit code). The codes are ORed into a
// per-warp shared string that starts as the header (atomicOr: two lanes
// may share a word, never a bit; a code spans at most three words). The
// lanes then store the string's words together, zero-filled, and lane 0
// the bit count. Bits past 32 n_words are dropped and the count keeps the
// untruncated length, so the caller detects overflow as the reference
// does. n_words <= BLOCK_WORDS_MAX (78), the exact worst case
// (codec/entropy.py), bounds the shared string. On the card the codes'
// placement and scan, not the bytes, set the kernel's time (PERF.md §6).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;           // blocks (warps) per thread block
constexpr int MAX_WORDS = 78;      // entropy.BLOCK_WORDS_MAX

// length of ue(v): 2 floor(log2(v + 1)) + 1; its code is v + 1 in as many
// bits
__device__ __forceinline__ int ue_len(unsigned v) {
  return 2 * (32 - __clz(v + 1)) - 1;
}

// the ue value of se(v): 2v - 1 for v > 0, -2v otherwise
__device__ __forceinline__ unsigned se_ue(int v) {
  return v > 0 ? 2u * (unsigned)v - 1u : 2u * (unsigned)(-v);
}

// The header as a code left-aligned in 64 bits; hdr gets its length.
template <bool V2>
__device__ __forceinline__ unsigned long long header(int nnz, int dc,
                                                    int dc_pred, bool cbf,
                                                    int& hdr) {
  unsigned long long h = (unsigned long long)cbf << 63;
  hdr = 1;
  if (cbf) {
    if (V2) {
      const unsigned dv = se_ue(dc - dc_pred);
      const int l1 = ue_len(dv), l2 = ue_len((unsigned)nnz);
      h |= (unsigned long long)(dv + 1) << (63 - l1);
      h |= (unsigned long long)(nnz + 1) << (63 - l1 - l2);
      hdr += l1 + l2;
    } else {
      const int l1 = ue_len((unsigned)nnz - 1);
      h |= (unsigned long long)nnz << (63 - l1);
      hdr += l1;
    }
  }
  return h;
}

// OR a code of len <= 38 bits at bit offset off into the shared string; it
// spans at most three words, and words at or past n_words are dropped.
__device__ __forceinline__ void put(unsigned* s, int n_words, int off,
                                    unsigned long long v, int len) {
  const int wi = off >> 5, end = (off & 31) + len;
  const unsigned long long top = v << (64 - len);   // the code, left-aligned
  const unsigned long long rest = top << (32 - (off & 31));
  if (wi < n_words) atomicOr(s + wi, (unsigned)(top >> (32 + (off & 31))));
  if (end > 32 && wi + 1 < n_words) atomicOr(s + wi + 1, (unsigned)(rest >> 32));
  if (end > 64 && wi + 2 < n_words) atomicOr(s + wi + 2, (unsigned)rest);
}

// V2 = false: format 1. V2 = true: format 2, dc_pred[i] the block's DC
// predictor (its left neighbour's DC level, 0 at the start of a block row).
template <bool V2>
__global__ void __launch_bounds__(32 * WARPS)
block_pack_kernel(const int* __restrict__ levels,
                  const int* __restrict__ dc_pred, int n, int n_words,
                  unsigned* __restrict__ words, int* __restrict__ bits) {
  __shared__ unsigned s_str[WARPS][MAX_WORDS + 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * WARPS + warp;
  if (i >= n) return;                       // uniform over the warp
  const int* lv = levels + i * 64;
  const int a = lv[lane], b = lv[lane + 32];

  unsigned lo = __ballot_sync(FULL, a != 0);
  const unsigned hi = __ballot_sync(FULL, b != 0);
  if (V2) lo &= ~1u;                        // the DC is coded apart
  const int nnz = __popc(lo) + __popc(hi);
  const int dc = __shfl_sync(FULL, a, 0);
  const bool cbf = nnz > 0 || (V2 && dc != 0);
  int hdr;
  const unsigned long long head =
      header<V2>(nnz, dc, V2 ? dc_pred[i] : 0, cbf, hdr);

  // this lane's pair codes at positions lane and lane + 32
  const unsigned below = (1u << lane) - 1u;
  const int first = V2 ? 0 : -1;            // where runs are counted from
  int n0 = 0, n1 = 0;
  unsigned long long c0 = 0, c1 = 0;
  if ((lo >> lane) & 1) {
    const unsigned bl = lo & below;
    const unsigned run = (unsigned)(lane - (bl ? 31 - __clz(bl) : first) - 1);
    const unsigned lu = se_ue(a);
    const int ll = ue_len(lu);
    n0 = ue_len(run) + ll;
    c0 = ((unsigned long long)(run + 1) << ll) | (lu + 1);
  }
  if ((hi >> lane) & 1) {
    const unsigned bh = hi & below;
    const int prev = bh ? 63 - __clz(bh) : (lo ? 31 - __clz(lo) : first);
    const unsigned run = (unsigned)(lane + 32 - prev - 1), lu = se_ue(b);
    const int ll = ue_len(lu);
    n1 = ue_len(run) + ll;
    c1 = ((unsigned long long)(run + 1) << ll) | (lu + 1);
  }

  // exclusive scan of the pair lengths, both halves in one word
  const int mine = n0 | (n1 << 16);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  const int excl = incl - mine;
  const int tot = __shfl_sync(FULL, incl, 31);
  const int off0 = hdr + (excl & 0xffff);
  const int off1 = hdr + (tot & 0xffff) + (excl >> 16);
  unsigned* str = s_str[warp];
#pragma unroll
  for (int k = 0; k < 3; ++k) {              // 3 x 32 >= MAX_WORDS
    const int w = lane + 32 * k;
    if (w < n_words)
      str[w] = w == 0 ? (unsigned)(head >> 32) : w == 1 ? (unsigned)head : 0u;
  }
  __syncwarp();
  if (n0) put(str, n_words, off0, c0, n0);
  if (n1) put(str, n_words, off1, c1, n1);
  __syncwarp();
  unsigned* out = words + i * n_words;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int w = lane + 32 * k;
    if (w < n_words) out[w] = str[w];
  }
  if (lane == 0) bits[i] = hdr + (tot & 0xffff) + (tot >> 16);
}

}  // namespace

// levels: [n, 64] int32 zigzag order (|level| <= 3925, SPEC.md §4);
// dc_pred: [n] int32, read for fmt >= 2 only (may be null for fmt 1);
// words: [n, n_words] 32-bit words (int32 tensors holding the uint32 bit
// pattern), 1 <= n_words <= 78; bits: [n] int32.
extern "C" int tvc_block_pack(const int* levels, const int* dc_pred, int n,
                              int n_words, int fmt, unsigned* words,
                              int* bits, void* stream) {
  if (n_words < 1 || n_words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + WARPS - 1) / WARPS;
    cudaStream_t s = (cudaStream_t)stream;
    if (fmt >= 2) {
      block_pack_kernel<true><<<blocks, 32 * WARPS, 0, s>>>(
          levels, dc_pred, n, n_words, words, bits);
    } else {
      block_pack_kernel<false><<<blocks, 32 * WARPS, 0, s>>>(
          levels, dc_pred, n, n_words, words, bits);
    }
  }
  return (int)cudaGetLastError();
}
