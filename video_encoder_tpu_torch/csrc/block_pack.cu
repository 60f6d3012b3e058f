// Exp-Golomb symbols of each 8x8 block, packed MSB-first into that block's
// own string of n_words 32-bit words, in the format-1 syntax or the
// format-2 syntax (DC prediction; formats 3 and 4 share it).
//
// Replaces: video_encoder_tpu/ops/pallas/entropy_pack.py,
// _make_block_pack_kernel (launched by _block_pack_call, public
// block_pack), fmt 1 and fmt >= 2.
//
// Bound on this card: memory latency and divergence, not bandwidth. A
// 1088x1920 luma plane is 32640 blocks: 8 MB of int32 levels in and 4 MB
// of int64 words out at n_words = 16, while each block's symbol loop runs
// serially in one thread for as many nonzero levels as the block has.
//
// Design: one thread per block walks its 64 zigzag levels once to count
// the nonzeros, then writes cbf, ue(nnz-1) and, for each nonzero level,
// ue(run) and se(level) (format 1), or cbf, se(dc - dc_pred), ue(nnz_ac)
// and the (run, level) pairs of the AC positions 1..63 with runs counted
// from position 1 (format 2), through a 64-bit bit accumulator that emits
// a word whenever 32 bits are full; words past n_words are dropped and the rest
// of the string is zero-filled. The returned bit count is the untruncated
// length, so the caller detects overflow as the reference does. The TPU
// kernel's lane-axis log-step cumsum/cummax and its masked per-word
// reductions existed because a TPU lane cannot run a serial loop cheaply;
// a GPU thread can.

#include <cuda_runtime.h>

namespace {

struct BitWriter {
  long long* out;
  int n_words;
  int widx;
  int nacc;
  unsigned long long acc;
  int bits;

  __device__ void put(unsigned int val, int len) {
    // nacc + len <= 31 + 27 < 64: the longest code is se(dc - dc_pred) of
    // format 2 at |dc - dc_pred| = 7850, 27 bits (a level's is 25)
    acc = (acc << len) | val;
    nacc += len;
    bits += len;
    if (nacc >= 32) {
      nacc -= 32;
      if (widx < n_words) out[widx] = (unsigned int)(acc >> nacc);
      ++widx;
      acc &= (1ull << nacc) - 1;
    }
  }

  __device__ void ue(unsigned int v) {
    const unsigned int v1 = v + 1;
    put(v1, 2 * (32 - __clz(v1)) - 1);
  }

  __device__ void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }

  __device__ void finish() {
    if (nacc > 0) {
      if (widx < n_words) out[widx] = (unsigned int)(acc << (32 - nacc));
      ++widx;
    }
    for (int i = widx; i < n_words; ++i) out[i] = 0;
  }
};

// V2 = false: format 1. V2 = true: format 2, dc_pred[i] the block's DC
// predictor (its left neighbour's DC level, 0 at the start of a block row).
template <bool V2>
__global__ void block_pack_kernel(const int* __restrict__ levels,
                                  const int* __restrict__ dc_pred, int n,
                                  int n_words, long long* __restrict__ words,
                                  int* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* lv = levels + (size_t)i * 64;
  constexpr int FIRST = V2 ? 1 : 0;  // first position of the run/level scan

  int nnz = 0;
  for (int k = FIRST; k < 64; ++k) nnz += lv[k] != 0;
  const bool cbf = nnz > 0 || (V2 && lv[0] != 0);

  BitWriter bw{words + (size_t)i * n_words, n_words, 0, 0, 0ull, 0};
  bw.put(cbf, 1);
  if (cbf) {
    if (V2) {
      bw.se(lv[0] - dc_pred[i]);
      bw.ue(nnz);
    } else {
      bw.ue(nnz - 1);
    }
    int prev = FIRST - 1;
    for (int k = FIRST; k < 64; ++k) {
      const int v = lv[k];
      if (v != 0) {
        bw.ue(k - prev - 1);
        bw.se(v);
        prev = k;
      }
    }
  }
  bw.finish();
  bits[i] = bw.bits;
}

}  // namespace

// levels: [n, 64] int32 zigzag order; dc_pred: [n] int32, read for
// fmt >= 2 only (may be null for fmt 1); words: [n, n_words] int64 holding
// 32-bit values; bits: [n] int32.
extern "C" int tvc_block_pack(const int* levels, const int* dc_pred, int n,
                              int n_words, int fmt, long long* words,
                              int* bits, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    if (fmt >= 2) {
      block_pack_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          levels, dc_pred, n, n_words, words, bits);
    } else {
      block_pack_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          levels, dc_pred, n, n_words, words, bits);
    }
  }
  return (int)cudaGetLastError();
}
