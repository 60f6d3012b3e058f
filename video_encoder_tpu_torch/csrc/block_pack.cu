// Format-1 Exp-Golomb symbols of each 8x8 block, packed MSB-first into
// that block's own string of n_words 32-bit words.
//
// Replaces: video_encoder_tpu/ops/pallas/entropy_pack.py,
// _make_block_pack_kernel (launched by _block_pack_call, public
// block_pack), fmt 1. The fmt >= 2 syntax (DC prediction) is not ported.
//
// Bound on this card: memory latency and divergence, not bandwidth. A
// 1088x1920 luma plane is 32640 blocks: 8 MB of int32 levels in and 4 MB
// of int64 words out at n_words = 16, while each block's symbol loop runs
// serially in one thread for as many nonzero levels as the block has.
//
// Design: one thread per block walks its 64 zigzag levels once to count
// the nonzeros, then writes cbf, ue(nnz-1) and, for each nonzero level,
// ue(run) and se(level) through a 64-bit bit accumulator that emits a word
// whenever 32 bits are full; words past n_words are dropped and the rest
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
    acc = (acc << len) | val;  // nacc + len <= 31 + 25 < 64
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

__global__ void block_pack_kernel(const int* __restrict__ levels, int n,
                                  int n_words, long long* __restrict__ words,
                                  int* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* lv = levels + (size_t)i * 64;

  int nnz = 0;
  for (int k = 0; k < 64; ++k) nnz += lv[k] != 0;

  BitWriter bw{words + (size_t)i * n_words, n_words, 0, 0, 0ull, 0};
  bw.put(nnz > 0, 1);
  if (nnz > 0) {
    bw.ue(nnz - 1);
    int prev = -1;
    for (int k = 0; k < 64; ++k) {
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

// levels: [n, 64] int32 zigzag order; words: [n, n_words] int64 holding
// 32-bit values; bits: [n] int32.
extern "C" int tvc_block_pack(const int* levels, int n, int n_words,
                              long long* words, int* bits, void* stream) {
  if (n > 0) {
    const int threads = 128;
    block_pack_kernel<<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(levels, n, n_words, words,
                                                bits);
  }
  return (int)cudaGetLastError();
}
