// The frame pack's tail: from block_pack's per-block strings and bit
// counts and the MB arrays (qp delta, mode, vector) to each string's words,
// its total bits, every MB's bits and the overflow flag, in two launches:
// mb_header_kernel (the headers, the MB totals and each tile's sum), then
// frame_place_kernel (each tile's offset, the scan inside it and the
// placement of its pieces). rc mb's first pass needs only the MB totals:
// the first launch alone, with no words. The chunk emit takes the first
// launch's header words and piece bit counts into its span merges.
//
// Replaces no TPU kernel: the reference packs the MB headers in jnp
// (video_encoder_tpu/codec/entropy.py, _header_slots :206 and
// _header_slots_v2 :340, each a pack_dense) and joins the pieces with
// tree_concat (:851), left to XLA. The port's plain version
// (codec/entropy.py assemble: _header_slots, pack_header and frame_concat)
// is about 235 device ops a 1080p frame on the card: a bitlen of ten
// wheres per symbol kind, a pack_dense of the headers, an int64 cumsum of
// 57,120 piece lengths, the shift splits and two index_add_s over
// [57120, 16] targets.
//
// Bound on this card: memory. A 1080p frame at qp 28 reads the pieces'
// used words and bit counts once (about 0.4 MB), writes the frame's cap
// words once (261,122 words, 1.0 MB) and the header words and MB totals
// (0.1 MB): about 1.5 MB, under 1 us at 3.35 TB/s.
//
// Design. A string is a run of m MBs in raster order (a frame, or an MB
// row of the tile grid); n strings lie back to back, the leading axes
// folded. A tile is TILE consecutive MBs of one string.
//   mb_header_kernel: one thread per MB, one warp per tile. A thread codes
//   its MB's four header symbols exactly as entropy._header_slots does
//   (ue(mode) in a P frame; se(dx), se(dy) for an inter MB of a P frame,
//   from format 2 on less the left MB's vector where both are inter;
//   se(qp_delta)) into a 64-bit code that becomes the MB's two words,
//   reads its six blocks' bit counts straight from block_pack's luma
//   [2 nby, 2 nbx] and chroma [nby, nbx] grids, and writes the MB's total.
//   The warp's sum is the tile's, with its verdict (a header over 64 bits
//   or a block over its 32 w). The same launch zero-fills the strings'
//   words and the overflow flag, which the placement then only ORs into.
//   frame_place_kernel: one block per tile. The tile's offset is the sum
//   of its string's earlier tile sums (at most a few hundred int32 reads,
//   in L2); an int32 warp scan of its MB totals gives each MB's offset
//   (a string's bits stay below 2^31: the wrapper checks m). The tile's
//   words are built in shared memory: a warp takes an MB, its lanes the
//   word positions of each of the seven pieces (all seven pieces' words
//   loaded before the first is placed), each output word a funnel shift of
//   two neighbouring piece words; a word inside one piece's bits is
//   stored, a word at a piece boundary ORed in (atomicOr: bit ranges are
//   disjoint). The tile then leaves as coalesced 32-bit stores, its first
//   and last words ORed in with a global atomic where a neighbouring tile
//   shares them. Words past cap are dropped; a string's last tile writes
//   its total and the verdict of total > 32 cap, and any tile whose MBs
//   overflowed sets the flag. Pieces must hold zeros past their bit counts,
//   as block_pack writes them; a piece over its budget contributes only the
//   words it has (the frame is then flagged, and its words are discarded
//   by the worst-case rerun), and nothing is written outside the tile's
//   shared buffer or past cap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;            // MBs per tile: one warp of the headers
constexpr int PLACE_WARPS = 8;      // warps of a placement block
constexpr int HEADER_WORDS = 2;     // entropy.HEADER_WORDS
constexpr int MAX_WORDS = 78;       // entropy.BLOCK_WORDS_MAX
constexpr int PIECES = 7;           // header, Y00, Y01, Y10, Y11, Cb, Cr
constexpr unsigned FULL = 0xffffffffu;

// length of ue(v): 2 floor(log2(v + 1)) + 1; its code is v + 1 in as many
// bits. Header symbols are a few bits; v + 1 must fit in 32 bits.
__device__ __forceinline__ int ue_len(unsigned v) {
  return 2 * (32 - __clz(v + 1)) - 1;
}

// the ue value of se(v): 2v - 1 for v > 0, -2v otherwise
__device__ __forceinline__ unsigned se_ue(int v) {
  return v > 0 ? 2u * (unsigned)v - 1u : 0u - 2u * (unsigned)v;
}

// Append a code of len <= 63 bits (code < 2^len) at bit off of a 64-bit
// MSB-first string; bits past 64 are dropped, off keeps the full length.
__device__ __forceinline__ void put64(unsigned long long& acc, int& off,
                                      unsigned code, int len) {
  if (off < 64) {
    const int end = off + len;
    acc |= end <= 64 ? (unsigned long long)code << (64 - end)
                     : (unsigned long long)code >> (end - 64);
  }
  off += len;
}

// Tile b of string s = b / tps: MBs [t TILE, min((t + 1) TILE, m)) of the
// string, flat MB i = s m + j. Luma block (a, c2) of MB i on MB row R =
// i / nbx, column c = i % nbx is (2R + a) 2 nbx + 2c + c2. Null outputs
// are skipped: the lengths-only entry writes mb_bits alone.
template <bool V2>
__global__ void __launch_bounds__(TILE)
mb_header_kernel(const int* __restrict__ qpd,
                 const unsigned char* __restrict__ inter,
                 const int* __restrict__ dy, const int* __restrict__ dx,
                 const int* __restrict__ ybits, const int* __restrict__ cbbits,
                 const int* __restrict__ crbits, int m, int tps, int nbx,
                 int w, bool is_p, unsigned* __restrict__ hw,
                 int* __restrict__ mb_bits, int* __restrict__ piece_bits,
                 int* __restrict__ tile_info, unsigned* __restrict__ zero,
                 long long n_zero, unsigned char* __restrict__ ovf) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int s = b / tps, j = (b - s * tps) * TILE + lane;
  int bits = 0;
  bool over = false;
  if (j < m) {
    const long long i = (long long)s * m + j;
    const long long row = i / nbx;
    const int c = (int)(i - row * nbx);
    unsigned long long h = 0;
    int hb = 0;
    const bool in = inter[i] != 0;
    if (is_p) put64(h, hb, in ? 1u : 2u, in ? 1 : 3);
    if (is_p && in) {
      int vy = dy[i], vx = dx[i];
      if (V2 && c > 0 && inter[i - 1] != 0) {
        vy -= dy[i - 1];
        vx -= dx[i - 1];
      }
      const unsigned ux = se_ue(vx), uy = se_ue(vy);
      put64(h, hb, ux + 1u, ue_len(ux));
      put64(h, hb, uy + 1u, ue_len(uy));
    }
    const unsigned uq = se_ue(qpd[i]);
    put64(h, hb, uq + 1u, ue_len(uq));

    const long long y0 = 2 * row * (2LL * nbx) + 2 * c;   // Y00
    const int b00 = ybits[y0], b01 = ybits[y0 + 1];
    const int b10 = ybits[y0 + 2 * nbx], b11 = ybits[y0 + 2 * nbx + 1];
    const int bcb = cbbits[i], bcr = crbits[i];
    const int lim = 32 * w;
    bits = hb + b00 + b01 + b10 + b11 + bcb + bcr;
    over = hb > 32 * HEADER_WORDS || b00 > lim || b01 > lim || b10 > lim ||
           b11 > lim || bcb > lim || bcr > lim;
    mb_bits[i] = bits;
    if (hw != nullptr) {
      hw[2 * i] = (unsigned)(h >> 32);
      hw[2 * i + 1] = (unsigned)h;
    }
    if (piece_bits != nullptr) {
      int* p = piece_bits + 8 * i;
      p[0] = hb; p[1] = b00; p[2] = b01; p[3] = b10; p[4] = b11;
      p[5] = bcb; p[6] = bcr; p[7] = 0;
    }
  }
  if (tile_info != nullptr) {
    int sum = bits;
#pragma unroll
    for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
    const bool any = __any_sync(FULL, over);
    if (lane == 0) {
      tile_info[2 * b] = sum;
      tile_info[2 * b + 1] = any;
    }
  }
  if (zero != nullptr) {     // the strings' words, before any placement
    const long long tid = (long long)b * TILE + lane;
    const long long nt = (long long)gridDim.x * TILE;
    long long k0 = 0;
    if (((uintptr_t)zero & 15) == 0) {
      uint4* z4 = reinterpret_cast<uint4*>(zero);
      const long long n4 = n_zero >> 2;
      for (long long k = tid; k < n4; k += nt) z4[k] = make_uint4(0, 0, 0, 0);
      k0 = n4 << 2;
    }
    for (long long k = k0 + tid; k < n_zero; k += nt) zero[k] = 0u;
  }
  if (ovf != nullptr && b == 0 && lane == 0) *ovf = 0;
}

// The pieces of MB i: the header's two words (hw), the four luma blocks
// and the two chroma blocks of w words each, with their bit counts.
struct Pieces {
  const unsigned* hw;
  const unsigned* yw;
  const int* yb;
  const unsigned* cbw;
  const int* cbb;
  const unsigned* crw;
  const int* crb;
  int nbx, w;
};

__global__ void __launch_bounds__(32 * PLACE_WARPS)
frame_place_kernel(Pieces pc, const int* __restrict__ mb_bits,
                   const int* __restrict__ tile_info, int m, int tps, int cap,
                   int buf_words, unsigned* __restrict__ out,
                   long long* __restrict__ totals,
                   unsigned char* __restrict__ ovf) {
  constexpr int NT = 32 * PLACE_WARPS;
  extern __shared__ unsigned buf[];    // [buf_words] the tile's words
  __shared__ int s_off[TILE];          // MB bit offsets from buf's bit 0
  __shared__ int s_part[PLACE_WARPS];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s = b / tps, t = b - s * tps;

  // the bits of the string's earlier tiles
  int part = 0;
  for (int k = s * tps + tid; k < b; k += NT) part += tile_info[2 * k];
#pragma unroll
  for (int d = 16; d; d >>= 1) part += __shfl_xor_sync(FULL, part, d);
  if (lane == 0) s_part[warp] = part;
  const int j0 = t * TILE, n = min(TILE, m - j0);
  const long long i0 = (long long)s * m + j0;
  const int v = warp == 0 && lane < n ? mb_bits[i0 + lane] : 0;
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int k = 0; k < PLACE_WARPS; ++k) base += s_part[k];
  const int tile_sum = tile_info[2 * b], r0 = base & 31;
  if (warp == 0) {                     // exclusive scan of the MB totals
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    s_off[lane] = r0 + incl - v;
  }
  const long long span = (long long)r0 + tile_sum;
  int nw = (int)((span + 31) >> 5);
  const bool clipped = nw > buf_words;    // only where a piece overflowed
  if (clipped) nw = buf_words;
  for (int k = tid; k < nw; k += NT) buf[k] = 0u;
  __syncthreads();

  // place: warp w takes MBs w, w + PLACE_WARPS, ...; lane l positions l,
  // l + 32, ... of each piece
  for (int jj = warp; jj < n; jj += PLACE_WARPS) {
    const long long i = i0 + jj;
    const long long row = i / pc.nbx;
    const long long y0 = 2 * row * (2LL * pc.nbx) + 2 * (i - row * pc.nbx);
    const long long yo[4] = {y0, y0 + 1, y0 + 2 * pc.nbx, y0 + 2 * pc.nbx + 1};
    const unsigned* src[PIECES];
    int pb[PIECES], off[PIECES], used[PIECES];
    src[0] = pc.hw + 2 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      src[1 + k] = pc.yw + yo[k] * pc.w;
      pb[1 + k] = pc.yb[yo[k]];
    }
    src[5] = pc.cbw + i * pc.w;
    pb[5] = pc.cbb[i];
    src[6] = pc.crw + i * pc.w;
    pb[6] = pc.crb[i];
    pb[0] = mb_bits[i] - pb[1] - pb[2] - pb[3] - pb[4] - pb[5] - pb[6];
    int o = s_off[jj], most = 0;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      off[p] = o;
      o += pb[p];
      used[p] = min((pb[p] + 31) >> 5, p == 0 ? HEADER_WORDS : pc.w);
      most = max(most, used[p]);
    }
    unsigned carry[PIECES];
#pragma unroll
    for (int p = 0; p < PIECES; ++p) carry[p] = 0u;
    for (int q0 = 0; q0 <= most; q0 += 32) {
      const int q = q0 + lane;
      unsigned cur[PIECES];
#pragma unroll
      for (int p = 0; p < PIECES; ++p) cur[p] = q < used[p] ? __ldg(src[p] + q) : 0u;
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
        unsigned prev = __shfl_up_sync(FULL, cur[p], 1);
        if (lane == 0) prev = carry[p];
        carry[p] = __shfl_sync(FULL, cur[p], 31);
        const int r = off[p] & 31;
        if (pb[p] == 0 || q > used[p] || (q == used[p] && r == 0)) continue;
        const unsigned word = r == 0 ? cur[p]
            : __funnelshift_l(cur[p], prev, 32 - r);
        const int tw = (off[p] >> 5) + q;
        if (tw >= nw) continue;
        if (32 * tw >= off[p] && 32 * tw + 32 <= off[p] + pb[p]) {
          buf[tw] = word;
        } else if (word != 0u) {
          atomicOr(&buf[tw], word);
        }
      }
    }
  }
  __syncthreads();

  // the tile's words out; its first and last words may be shared with
  // the tiles before and after it
  const bool head_shared = r0 != 0 || clipped;
  const bool tail_shared = (span & 31) != 0 || clipped;
  unsigned* dst = out + (long long)s * cap;
  const int w0 = base >> 5;
  for (int k = tid; k < nw; k += NT) {
    const long long g = (long long)w0 + k;
    if (g >= cap) break;
    const unsigned word = buf[k];
    if ((k == 0 && head_shared) || (k == nw - 1 && tail_shared) || clipped) {
      if (word != 0u) atomicOr(dst + g, word);
    } else {
      dst[g] = word;
    }
  }
  if (tid == 0) {
    if (tile_info[2 * b + 1]) *ovf = 1;
    if (t == tps - 1) {
      const long long total = (long long)base + tile_sum;
      totals[s] = total;
      if (total > 32LL * cap) *ovf = 1;
    }
  }
}

int tiles_of(int n_strings, int m, int nbx, long long& blocks) {
  if (n_strings < 0 || m < 1 || nbx < 1 ||
      ((long long)n_strings * m) % nbx != 0) {
    return (int)cudaErrorInvalidValue;
  }
  blocks = (long long)n_strings * ((m + TILE - 1) / TILE);
  return blocks > 0x7fffffffLL ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// MBs per tile: the wrappers size tile_info as n_strings * ceil(m / TILE).
extern "C" int tvc_frame_pack_tile() { return TILE; }

// Launch 1 (and rc mb's lengths-only pass). qpd, dy, dx [n_strings * m]
// int32 and inter [n_strings * m] bool, flat MBs in raster order (m MBs a
// string, whole MB rows of nbx); ybits [.., 2 nby, 2 nbx], cbbits, crbits
// [.., nby, nbx] int32 (block_pack's counts at w words a block). Outputs,
// each nullable but mb_bits: hw [n_mbs, 2] words, mb_bits [n_mbs] int32,
// piece_bits [n_mbs, 8] int32, tile_info [n_tiles, 2] int32 (sum,
// verdict); zero [n_zero] words set to 0; ovf set to 0.
extern "C" int tvc_mb_headers(const int* qpd, const unsigned char* inter,
                              const int* dy, const int* dx, const int* ybits,
                              const int* cbbits, const int* crbits,
                              int n_strings, int m, int nbx, int w, int is_p,
                              int fmt, unsigned* hw, int* mb_bits,
                              int* piece_bits, int* tile_info, unsigned* zero,
                              long long n_zero, unsigned char* ovf,
                              void* stream) {
  long long blocks = 0;
  const int err = tiles_of(n_strings, m, nbx, blocks);
  if (err != 0 || w < 1 || w > MAX_WORDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks == 0) {
    if (ovf != nullptr) cudaMemsetAsync(ovf, 0, 1, st);
    return (int)cudaGetLastError();
  }
  const int tps = (m + TILE - 1) / TILE;
  if (fmt >= 2) {
    mb_header_kernel<true><<<(int)blocks, TILE, 0, st>>>(
        qpd, inter, dy, dx, ybits, cbbits, crbits, m, tps, nbx, w, is_p != 0,
        hw, mb_bits, piece_bits, tile_info, zero, n_zero, ovf);
  } else {
    mb_header_kernel<false><<<(int)blocks, TILE, 0, st>>>(
        qpd, inter, dy, dx, ybits, cbbits, crbits, m, tps, nbx, w, is_p != 0,
        hw, mb_bits, piece_bits, tile_info, zero, n_zero, ovf);
  }
  return (int)cudaGetLastError();
}

// Launch 2, after tvc_mb_headers with hw, tile_info, zero = out and ovf:
// the same strings and blocks (yw, cbw, crw the words at w a block);
// out [n_strings, cap] words, totals [n_strings] int64, ovf ORed.
extern "C" int tvc_frame_place(const unsigned* hw, const unsigned* yw,
                               const int* yb, const unsigned* cbw,
                               const int* cbb, const unsigned* crw,
                               const int* crb, const int* mb_bits,
                               const int* tile_info, int n_strings, int m,
                               int nbx, int w, int cap, unsigned* out,
                               long long* totals, unsigned char* ovf,
                               void* stream) {
  long long blocks = 0;
  const int err = tiles_of(n_strings, m, nbx, blocks);
  if (err != 0 || w < 1 || w > MAX_WORDS || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return (int)cudaGetLastError();
  // a tile's words when no piece is over its budget
  const int buf_words = TILE * (HEADER_WORDS + 6 * w) + 2;
  const size_t smem = (size_t)buf_words * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(frame_place_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const Pieces pc{hw, yw, yb, cbw, cbb, crw, crb, nbx, w};
  frame_place_kernel<<<(int)blocks, 32 * PLACE_WARPS, smem,
                       (cudaStream_t)stream>>>(
      pc, mb_bits, tile_info, m, (m + TILE - 1) / TILE, cap, buf_words, out,
      totals, ovf);
  return (int)cudaGetLastError();
}
