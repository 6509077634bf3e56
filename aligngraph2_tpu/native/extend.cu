// Static-band seed extension for Hopper (sm_90a), called from JAX through
// the XLA foreign function interface (ops/extend.py extend_cuda).  The
// plain specification is ops/extend.py extend_reference; both compute
// the same recurrence bit for bit:
//
//   * band in the standard frame: cell (i, j), row i in 1..NQ and band
//     column j in 0..W-1, reads t[i-1+j]; row 0 is all zeros;
//   * local alignment with linear gaps: M = max(H[j] + sub, H[j+1] + gap,
//     0) with DIAG/UP ties going to DIAG, then the query-gap chain
//     H_j = gap*j + max_{k<=j} (M_k - gap*k);
//   * 2-bit codes STOP/DIAG/UP/LEFT (LEFT iff the chain raised the cell),
//     16 rows packed per int32 word, words laid out (B, NQ/16, W);
//   * best cell: the first row reaching the maximum, then its smallest
//     column;
//   * a lane stops after row i when i >= qlen or, with x_drop > 0 and a
//     positive best, when the row's maximum fell more than x_drop below
//     the best.  Words past that row are left unwritten: the traceback
//     starts at best_i and never reads them.
//
// One warp per alignment, C = W/32 contiguous band columns per lane (the
// aligner's W = max(band_width, 256) gives 256 or 512).  The
// DP state (H, the lane's best cell) stays in registers for the whole
// read; only the packed words leave the SM, as 16-byte stores that a
// warp issues for one contiguous W*4-byte row of words.  Per row: one
// __shfl_down_sync brings the "up" predecessor of the lane's last column,
// an in-lane serial pass plus a 5-step shuffle max-scan resolves the gap
// chain, and DPX add-max instructions do the max-plus arithmetic.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
extend_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
              const int32_t* __restrict__ qlen, int32_t* __restrict__ score,
              int32_t* __restrict__ best_i, int32_t* __restrict__ best_j,
              int32_t* __restrict__ words, int B, int NQ, int match,
              int mismatch, int gap, int x_drop) {
  constexpr int W = 32 * C;
  // t bytes a lane reads for one 16-row block: columns j0..j0+C-1 of rows
  // 16w+1..16w+16, i.e. t[16w + j0 .. 16w + j0 + C + 14], as u32 words
  constexpr int kTWords = (C + 15 + 3) / 4;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const int j0 = C * lane;
  const int NW = NQ / 16;
  const int len = qlen[b];
  const uint8_t* qb = q + (size_t)b * NQ;
  const uint8_t* tb = t + (size_t)b * (NQ + W) + j0;
  int32_t* wb = words + (size_t)b * NW * W + j0;

  int H[C];
#pragma unroll
  for (int c = 0; c < C; ++c) H[c] = 0;
  int tbest = 0, trow = 0, tcol = 0;
  bool alive = true;

  for (int w = 0; w < NW && alive; ++w) {
    const uint4 qv = *reinterpret_cast<const uint4*>(qb + 16 * w);
    const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
    uint32_t tv[kTWords];
    const uint32_t* tp = reinterpret_cast<const uint32_t*>(tb + 16 * w);
#pragma unroll
    for (int k = 0; k < kTWords; ++k) tv[k] = tp[k];
    int acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0;

#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int i = 16 * w + s + 1;
      const int qc = (qw[s >> 2] >> (8 * (s & 3))) & 0xff;
      int up_last = __shfl_down_sync(kFull, H[0], 1);
      if (lane == 31) up_last = kNeg;
      int M[C], code[C], P[C];
      int run = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = s + c;
        const int tc = (tv[k >> 2] >> (8 * (k & 3))) & 0xff;
        const int dv = H[c] + (tc == qc ? match : mismatch);
        const int up = (c + 1 < C) ? H[c + 1] : up_last;
        const int m = __viaddmax_s32(up, gap, dv);  // max(up + gap, dv)
        code[c] = m > 0 ? (m == dv ? kDiag : kUp) : kStop;
        M[c] = max(m, 0);
        run = __viaddmax_s32(M[c], -gap * (j0 + c), run);
        P[c] = run;
      }
      // exclusive max-scan of the lanes' running maxima
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = kNeg;
      int rmax = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        H[c] = max(P[c], excl) + gap * (j0 + c);
        if (H[c] > M[c]) code[c] = kLeft;
        acc[c] |= code[c] << (2 * s);
        rmax = max(rmax, H[c]);
      }
      if (rmax > tbest) {
        tbest = rmax;
        trow = i;
        int fc = C - 1;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (H[c] == rmax) fc = c;
        tcol = j0 + fc;
      }
      bool next = i < len;
      if (x_drop > 0) {
        const int frontier = __reduce_max_sync(kFull, rmax);
        const int best = __reduce_max_sync(kFull, tbest);
        next = next && (best == 0 || frontier >= best - x_drop);
      }
      if (!next) {  // uniform across the warp
        alive = false;
        break;
      }
    }
    int4* dst = reinterpret_cast<int4*>(wb + (size_t)w * W);
#pragma unroll
    for (int k = 0; k < C / 4; ++k)
      dst[k] = make_int4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                         acc[4 * k + 3]);
  }

  // warp reduction: highest score, then first row, then smallest column
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, tbest, d);
    const int r2 = __shfl_xor_sync(kFull, trow, d);
    const int c2 = __shfl_xor_sync(kFull, tcol, d);
    if (s2 > tbest ||
        (s2 == tbest && (r2 < trow || (r2 == trow && c2 < tcol)))) {
      tbest = s2;
      trow = r2;
      tcol = c2;
    }
  }
  if (lane == 0) {
    score[b] = tbest;
    best_i[b] = trow;
    best_j[b] = tcol;
  }
}

template <int C>
void launch(cudaStream_t stream, const uint8_t* q, const uint8_t* t,
            const int32_t* qlen, int32_t* score, int32_t* best_i,
            int32_t* best_j, int32_t* words, int B, int NQ, int match,
            int mismatch, int gap, int x_drop) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  extend_kernel<C><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      q, t, qlen, score, best_i, best_j, words, B, NQ, match, mismatch, gap,
      x_drop);
}

ffi::Error ExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                      ffi::Buffer<ffi::U8> t, ffi::Buffer<ffi::S32> qlen,
                      int32_t match, int32_t mismatch, int32_t gap,
                      int32_t x_drop, ffi::ResultBuffer<ffi::S32> score,
                      ffi::ResultBuffer<ffi::S32> best_i,
                      ffi::ResultBuffer<ffi::S32> best_j,
                      ffi::ResultBuffer<ffi::S32> words) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || td[0] != qd[0])
    return ffi::Error::InvalidArgument("q must be (B, NQ), t (B, NQ + W)");
  const int64_t B = qd[0], NQ = qd[1], W = td[1] - NQ;
  if (NQ % 16 != 0)
    return ffi::Error::InvalidArgument("NQ must be a multiple of 16");
  if (qlen.element_count() != static_cast<size_t>(B) ||
      words->element_count() != static_cast<size_t>(B * NQ / 16 * W))
    return ffi::Error::InvalidArgument("qlen or words has the wrong size");
  if (B == 0) return ffi::Error::Success();
  const int Bi = static_cast<int>(B), NQi = static_cast<int>(NQ);
  const uint8_t* qp = q.typed_data();
  const uint8_t* tp = t.typed_data();
  switch (W) {
    case 256:
      launch<8>(stream, qp, tp, qlen.typed_data(), score->typed_data(),
                best_i->typed_data(), best_j->typed_data(),
                words->typed_data(), Bi, NQi, match, mismatch, gap, x_drop);
      break;
    case 512:
      launch<16>(stream, qp, tp, qlen.typed_data(), score->typed_data(),
                 best_i->typed_data(), best_j->typed_data(),
                 words->typed_data(), Bi, NQi, match, mismatch, gap,
                 x_drop);
      break;
    default:
      return ffi::Error::InvalidArgument("band width W must be 256 or 512");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(AgxExtend, ExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()  // q
                                  .Arg<ffi::Buffer<ffi::U8>>()  // t
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qlen
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap")
                                  .Attr<int32_t>("x_drop")
                                  .Ret<ffi::Buffer<ffi::S32>>()  // score
                                  .Ret<ffi::Buffer<ffi::S32>>()  // best_i
                                  .Ret<ffi::Buffer<ffi::S32>>()  // best_j
                                  .Ret<ffi::Buffer<ffi::S32>>());  // words
