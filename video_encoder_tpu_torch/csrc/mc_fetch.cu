// Motion-compensated prediction of a P frame step: the three predictor
// planes (luma and both chroma) from per-macroblock vectors and modes in
// one launch, and the single-plane fetch on the same kernel.
//
// Replaces: video_encoder_tpu/ops/pallas/sad.py, make_mc_kernels ->
// mc_kernel (public mc_fetch_plane with 16x16 blocks and radius 16, and
// mc_fetch_plane_chroma with 8x8 blocks and radius 8), mc_kernel_g
// launched through tile_call_g (the vmap rule of both on [G, H, W]
// reference planes with per-GOP vectors [G, nby, nbx]) and
// mc_fetch_pre_haloed (sad.py:1038), the tile-sharded encode's fetch from
// a reference ref_ext [h + 2r, w] or [h + 2r, w + 2r] that already
// carries the neighbour shards' rows (and columns, on a 2-D tile grid).
// On the TPU each is one plane, and the engine composes a P step's
// prediction around them (video_encoder_tpu/pipeline/gop_engine.py
// predict_p_traced, dispatch._hpel_mc): a fetch per plane, under format 4
// a fetch from each of the four parity planes and a per-block select, and
// a mask that predicts 128 for an intra MB. Here that whole composition
// is one launch: it reads each MB's vector and mode, derives the chroma
// vector dy >> 1 (an arithmetic shift, SPEC.md §2), and under format 4
// (vectors in half-pels, P = 4 parity planes in motion.hpel_stack order)
// the integer part d >> 1 and the plane code (d2y & 1) * 2 + (d2x & 1),
// and reads only the selected parity plane; an intra MB reads nothing and
// writes 128. The batch (G GOPs x S shards) is blockIdx.z and a plane
// stride; the reference has extents, an origin (oy, ox) and a plane
// stride of its own, and the clamp acts only on an axis without a halo,
// where it is pad_ref's edge replication (|mv| <= the pad radius).
//
// Bound on this card: device memory. Each pixel of an inter MB is one
// 4-byte read of the selected plane (an intra MB reads nothing) and each
// output pixel one 4-byte write: a 1080p 4:2:0 step with every MB inter
// reads 12.5 MB and writes 12.5 MB, about 0.0075 ms at 3.35 TB/s.
//
// Design: one thread per four adjacent output pixels of a row, written
// with one 16-byte store (a luma block row holds four such quads, a
// chroma block row two, so a quad never straddles two blocks). The
// thread reads its block's vector and mode once. The four source pixels
// are one clamped, unaligned run of a source row, read as four scalar
// loads (two aligned 16-byte words and a select by the run's offset were
// no faster on the card, PERF.md). Neighbouring threads take
// neighbouring quads of a row, so loads and stores coalesce. All three
// planes' quads form one grid: luma's first, then each chroma plane's.
// The TPU kernels' one-hot bf16 matmuls stood in for a gather the TPU
// lacks; a GPU gathers directly.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

struct Plane {
  const int* ref;   // [B, P, rh, rw] int32
  int h, w;         // the predictor plane [B, h, w]
  int rh, rw;       // the reference's extents
  int oy, ox;       // the predictor's origin inside the reference
  int bs;           // pixels per block side: 16 luma, 8 chroma
  int shift;        // the block vector of this plane is the MB's >> shift
  long long out;    // offset of this plane's [B, h, w] in the output
  int quads;        // h * w / 4
};

struct Planes {
  Plane p[3];
  int n;            // 1 (a single-plane fetch) or 3 (a P step)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
mc_predict_kernel(const Planes ps, const int* __restrict__ dy,
                  const int* __restrict__ dx,
                  const unsigned char* __restrict__ inter, int nby, int nbx,
                  int np, int* __restrict__ out) {
  // the quad's plane: luma's quads first, then each chroma plane's (no
  // dynamic index into the parameter struct, which would go to local memory)
  int q = blockIdx.x * THREADS + threadIdx.x;
  int k = 0;
  if (ps.n == 3 && q >= ps.p[0].quads) {
    q -= ps.p[0].quads;
    k = q >= ps.p[1].quads ? 2 : 1;
    q -= k == 2 ? ps.p[1].quads : 0;
  }
  const Plane pl = k == 0 ? ps.p[0] : k == 1 ? ps.p[1] : ps.p[2];
  if (q >= pl.quads) return;
  const size_t b = blockIdx.z;
  const int w4 = pl.w >> 2;
  const int y = q / w4, x = (q - y * w4) << 2;
  const size_t mb = (b * nby + y / pl.bs) * nbx + x / pl.bs;
  int4 v = make_int4(128, 128, 128, 128);
  if (inter == nullptr || inter[mb]) {
    int vy = dy[mb] >> pl.shift, vx = dx[mb] >> pl.shift;
    int plane = 0;
    if (np == 4) {  // half-pels: the parity plane, then the integer part
      plane = ((vy & 1) << 1) | (vx & 1);
      vy >>= 1;
      vx >>= 1;
    }
    // 64-bit: (b * P + plane) * rh * rw passes int32 for a large batch
    const int* row =
        pl.ref + ((b * np + plane) * pl.rh +
                  clampi(y + vy + pl.oy, 0, pl.rh - 1)) * (size_t)pl.rw;
    const int sx = x + vx + pl.ox, e = pl.rw - 1;
    v.x = __ldg(row + clampi(sx, 0, e));
    v.y = __ldg(row + clampi(sx + 1, 0, e));
    v.z = __ldg(row + clampi(sx + 2, 0, e));
    v.w = __ldg(row + clampi(sx + 3, 0, e));
  }
  *reinterpret_cast<int4*>(out + pl.out + (b * pl.h + y) * pl.w + x) = v;
}

// A plane of predictors [h, w] from a reference of extents (rh, rw):
// each extent is the plane's own or that plus 2 bs (a halo of the pad
// radius), the origin in the middle.
bool set_plane(Plane* pl, const int* ref, int h, int w, int rh, int rw,
               int bs, int shift, long long out) {
  if (h % bs || w % bs || (rh != h && rh != h + 2 * bs) ||
      (rw != w && rw != w + 2 * bs)) {
    return false;
  }
  *pl = Plane{ref, h, w, rh, rw, (rh - h) / 2, (rw - w) / 2, bs, shift, out,
              h * w / 4};
  return true;
}

int launch(const Planes& ps, const int* dy, const int* dx,
           const unsigned char* inter, int b, int np, int* out,
           void* stream) {
  // the 16-byte stores need an aligned output
  if (b < 1 || b > 65535 || (np != 1 && np != 4) ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  long long quads = 0;
  for (int k = 0; k < ps.n; ++k) quads += ps.p[k].quads;
  const int nby = ps.p[0].h / ps.p[0].bs, nbx = ps.p[0].w / ps.p[0].bs;
  const dim3 grid((unsigned)((quads + THREADS - 1) / THREADS), 1, b);
  mc_predict_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      ps, dy, dx, inter, nby, nbx, np, out);
  return (int)cudaGetLastError();
}

// One plane, P = 1, no mask: the predictor [g, h, w] of block size bs at
// the vectors as given.
int fetch(const int* ref, const int* dy, const int* dx, int g, int h, int w,
          int rh, int rw, int bs, int* out, void* stream) {
  Planes ps{};
  ps.n = 1;
  if (!set_plane(&ps.p[0], ref, h, w, rh, rw, bs, 0, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(ps, dy, dx, nullptr, g, 1, out, stream);
}

}  // namespace

// The three predictors of a P frame step of b planes (G GOPs x S shards):
// ref_y [b, p, rh, rw], ref_cb and ref_cr [b, p, crh, crw] int32 (p = 1,
// or 4 parity planes in motion.hpel_stack order, the vectors then in
// half-pels); dy, dx [b, h/16, w/16] int32 per MB (luma units); inter
// [b, h/16, w/16] bool (an intra MB predicts 128). Each reference extent
// is the plane's own or that plus twice the pad radius (16 luma, 8
// chroma). out: [b, h, w] luma, then [b, h/2, w/2] cb, then cr, int32,
// 16-byte aligned. geometry: int[8] in host memory, {b, p, h, w, rh, rw,
// crh, crw}: one pointer in place of eight arguments, as the wrapper
// keeps it per shape.
extern "C" int tvc_mc_predict(const int* ref_y, const int* ref_cb,
                              const int* ref_cr, const int* dy, const int* dx,
                              const unsigned char* inter, const int* geometry,
                              int* out, void* stream) {
  const int b = geometry[0], p = geometry[1], h = geometry[2],
            w = geometry[3], rh = geometry[4], rw = geometry[5],
            crh = geometry[6], crw = geometry[7];
  Planes ps{};
  ps.n = 3;
  const long long luma = (long long)b * h * w;
  if (h % 16 || w % 16 ||
      !set_plane(&ps.p[0], ref_y, h, w, rh, rw, 16, 0, 0) ||
      !set_plane(&ps.p[1], ref_cb, h / 2, w / 2, crh, crw, 8, 1, luma) ||
      !set_plane(&ps.p[2], ref_cr, h / 2, w / 2, crh, crw, 8, 1,
                 luma + luma / 4)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(ps, dy, dx, inter, b, p, out, stream);
}

// ref, out: [h, w] int32; dy, dx: [h/bs, w/bs] int32.
extern "C" int tvc_mc_fetch(const int* ref, const int* dy, const int* dx,
                            int h, int w, int bs, int* out, void* stream) {
  return fetch(ref, dy, dx, 1, h, w, h, w, bs, out, stream);
}

// The G-batched fetch: ref, out [g, h, w] int32; dy, dx [g, h/bs, w/bs]
// int32; plane g is fetched from ref[g] at its own vectors.
extern "C" int tvc_mc_fetch_g(const int* ref, const int* dy, const int* dx,
                              int g, int h, int w, int bs, int* out,
                              void* stream) {
  return fetch(ref, dy, dx, g, h, w, h, w, bs, out, stream);
}

// The pre-haloed fetch of g row shards (or 2-D tiles): ref_ext [g, rh, rw]
// int32 with rh = h + 2 bs and rw = w or w + 2 bs; dy, dx [g, h/bs, w/bs]
// int32 (|mv| <= bs); out [g, h, w].
extern "C" int tvc_mc_fetch_haloed(const int* ref_ext, const int* dy,
                                   const int* dx, int g, int h, int w, int rh,
                                   int rw, int bs, int* out, void* stream) {
  if (rh != h + 2 * bs) return (int)cudaErrorInvalidValue;
  return fetch(ref_ext, dy, dx, g, h, w, rh, rw, bs, out, stream);
}
