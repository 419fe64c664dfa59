// Fused distance + top-k scans for Hopper (sm_90a): the kernels of the
// store's search path, ported from erlvectordb_tpu/ops/fused_topk.py.
//
//   B1 intkey_scan  <- _intkey_scan / _make_intkey_kernel
//        key[b, s] = max over the 1024-row slice s of (dot(q8[b], c8[r]) << 10) | lane
//   B2 l2key_scan   <- _l2key_scan / _make_l2key_kernel
//        key[b, s] = max over s of ((dot - bias[r]) << 10) | lane
//   B3 pos_scan     <- _pos_scan / _make_pos_kernel (int8, f32 and packed int4 codes)
//        s = (fma(dot * m[r] (* qm[b]), bv[r]) - f[b]) * g[b]
//        key = (int32(clip(rint(s), +-2e9)) & ~1023) | lane, max per slice
//   B4 fused_scan   <- _fused_scan / _make_scan_kernel, cell_cap == 0 (int8, f32, int4)
//        sims = fma(dot * qmult[b], rowmult[r], rowbias[r]); monotone float->int
//        key with the low 12 bits = lane in a 4096-row tile; top-T per tile
//        (tile_scan_kernel in scan_common.cuh)
//
// What bounds them on an H100: the scan reads the whole code plane once per
// query group, so at 1024 queries x 1.2M x 128 codes the work is ~315 G
// MACs against 150 MB of int8 codes (77 MB packed int4): compute-bound.
// This first version does the dots with __dp4a (4 int8 MACs per
// instruction, no tensor cores; a packed int4 word unpacks to two __dp4a
// operands) or fmaf for f32 codes, which puts its floor well above the int8
// tensor-core roofline; wgmma/TMA staging is later work.  The simple design:
//   * one block of 256 threads per (1024-row slice or 4096-row tile, group of
//     queries); blocks are independent, so nothing carries across them;
//   * codes are staged through shared memory in coalesced [256 rows x 64 B]
//     pieces (row stride padded by one word so each thread reads its own row
//     without bank conflicts) and the query group's matching columns are
//     read as 16-byte broadcasts;
//   * each thread owns one row of the staged piece and keeps one dot per
//     query of the group in registers, then folds its key into a running max
//     (B1-B3) or a sorted per-thread top-T list (B4);
//   * a warp-shuffle + shared-memory max over the block finishes each slice
//     (B1-B3) or extracts the tile's top-T, T rounds of a block max (B4).
//
// Bit-exactness with the JAX kernels: keys are shifted and subtracted as
// uint32 (JAX wraps int32; signed overflow is undefined in C++); B3/B4 keep
// the JAX operation order with __fmul_rn/__fsub_rn, and the one place where
// XLA fuses the JAX expression into a multiply-add (``x * m + b``, the row
// bias add) is an explicit __fmaf_rn — no other contraction (the file is
// built with -fmad=false); rounding is rintf (half to even, like jnp.round).
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "scan_common.cuh"

namespace {

using namespace evdb;

enum Mode { kIntkey = 0, kL2key = 1, kPos = 2 };

// B1, B2, B3: one block per (1024-row slice, 32 queries).
template <class Fmt, int MODE>
__global__ void __launch_bounds__(kThreads) slice_scan_kernel(
    const typename Fmt::Word* __restrict__ q,
    const typename Fmt::Word* __restrict__ codes, int B, int ww, int n_slices,
    const int* __restrict__ bias, const float* __restrict__ qm,
    const float* __restrict__ f, const float* __restrict__ g,
    const float* __restrict__ m, const float* __restrict__ bv, int use_qm,
    int* __restrict__ out) {
  using Word = typename Fmt::Word;
  __shared__ Word cs[kThreads][kWords + 1];
  __shared__ __align__(16) Word qs[kSliceQ][kWords * Fmt::QW];
  __shared__ int red[kThreads / 32][kSliceQ];
  const int s = blockIdx.x, q0 = blockIdx.y * kSliceQ, t = threadIdx.x;

  // per-query factors of the pos epilogue (zero for queries past B); the
  // first piece_dots synchronises before they are read
  __shared__ float qm_s[kSliceQ], f_s[kSliceQ], g_s[kSliceQ];
  if (MODE == kPos && t < kSliceQ) {
    const bool ok = q0 + t < B;
    qm_s[t] = ok ? qm[q0 + t] : 0.f;
    f_s[t] = ok ? f[q0 + t] : 0.f;
    g_s[t] = ok ? g[q0 + t] : 0.f;
  }

  int best[kSliceQ];
#pragma unroll
  for (int j = 0; j < kSliceQ; ++j) best[j] = INT32_MIN;

  for (int p = 0; p < kSlice / kThreads; ++p) {
    const long long row0 = (long long)s * kSlice + p * kThreads;
    Word acc[kSliceQ];
    piece_dots<Fmt, kSliceQ>(q, codes, B, ww, q0, row0, cs, qs, acc);
    const long long row = row0 + t;
    const uint32_t lane = (uint32_t)(p * kThreads + t);  // row & 1023
    if constexpr (MODE == kIntkey) {
#pragma unroll
      for (int j = 0; j < kSliceQ; ++j) {
        const int key = (int)(((uint32_t)acc[j] << 10) | lane);
        best[j] = max(best[j], key);
      }
    } else if constexpr (MODE == kL2key) {
      const uint32_t br = (uint32_t)bias[row];
#pragma unroll
      for (int j = 0; j < kSliceQ; ++j) {
        const uint32_t d = (uint32_t)acc[j] - br;
        const int key = (int)((d << 10) | lane);
        best[j] = max(best[j], key);
      }
    } else {
      const float mr = m[row], br = bv[row];
#pragma unroll
      for (int j = 0; j < kSliceQ; ++j) {
        float v = to_f32(acc[j]);
        v = use_qm ? __fmaf_rn(__fmul_rn(v, mr), qm_s[j], br) : __fmaf_rn(v, mr, br);
        v = __fmul_rn(__fsub_rn(v, f_s[j]), g_s[j]);
        v = fminf(fmaxf(rintf(v), -2.0e9f), 2.0e9f);
        const int key = (int)(((uint32_t)(int)v & ~1023u) | lane);
        best[j] = max(best[j], key);
      }
    }
  }

  const int warp = t / 32;
#pragma unroll
  for (int j = 0; j < kSliceQ; ++j) {
    const int v = warp_max(best[j]);
    if ((t & 31) == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (t < kSliceQ && q0 + t < B) {
    int v = red[0][t];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) v = max(v, red[w][t]);
    out[(long long)(q0 + t) * n_slices + s] = v;
  }
}

template <class Fmt, int MODE>
int launch_slice(const void* q, const void* codes, int B, int ww, int n_slices,
                 const void* bias, const void* qm, const void* f, const void* g,
                 const void* m, const void* bv, int use_qm, void* out,
                 void* stream) {
  using Word = typename Fmt::Word;
  const dim3 grid(n_slices, (B + kSliceQ - 1) / kSliceQ);
  slice_scan_kernel<Fmt, MODE><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const Word*)q, (const Word*)codes, B, ww, n_slices, (const int*)bias,
      (const float*)qm, (const float*)f, (const float*)g, (const float*)m,
      (const float*)bv, use_qm, (int*)out);
  return (int)cudaGetLastError();
}

template <class Fmt>
int pos_scan(const void* q, const void* codes, const void* qm, const void* f,
             const void* g, const void* m, const void* bv, int use_qm, int B,
             int ww, int n_slices, void* out, void* stream) {
  return launch_slice<Fmt, kPos>(q, codes, B, ww, n_slices, nullptr, qm, f, g, m,
                                 bv, use_qm, out, stream);
}

template <class Fmt>
int fused_scan(const void* q, const void* codes, const void* qmult,
               const void* rowmult, const void* rowbias, int B, int ww,
               int n_tiles, int t, void* vals, void* rows, void* stream) {
  return launch_tile<Fmt, false>(q, codes, B, ww, n_tiles, t, qmult, rowmult,
                                 rowbias, nullptr, nullptr, nullptr, 0, 1, vals,
                                 rows, stream);
}

}  // namespace

// ---------------------------------------------------------------- C interface
// Row widths arrive in 32-bit code words: W/4 for int8 rows, W for f32 rows,
// W/8 for packed int4 rows (whose int8 query is W/4 words, reordered).

extern "C" {

int evdb_intkey_scan(const void* q, const void* codes, int B, int ww,
                     int n_slices, void* out, void* stream) {
  return launch_slice<I8, kIntkey>(q, codes, B, ww, n_slices, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, 0, out,
                                   stream);
}

int evdb_l2key_scan(const void* q, const void* codes, const void* bias, int B,
                    int ww, int n_slices, void* out, void* stream) {
  return launch_slice<I8, kL2key>(q, codes, B, ww, n_slices, bias, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, 0, out,
                                  stream);
}

int evdb_pos_scan_i8(const void* q, const void* codes, const void* qm,
                     const void* f, const void* g, const void* m,
                     const void* bv, int use_qm, int B, int ww, int n_slices,
                     void* out, void* stream) {
  return pos_scan<I8>(q, codes, qm, f, g, m, bv, use_qm, B, ww, n_slices, out,
                      stream);
}

int evdb_pos_scan_f32(const void* q, const void* codes, const void* qm,
                      const void* f, const void* g, const void* m,
                      const void* bv, int use_qm, int B, int ww, int n_slices,
                      void* out, void* stream) {
  return pos_scan<F32>(q, codes, qm, f, g, m, bv, use_qm, B, ww, n_slices, out,
                       stream);
}

int evdb_pos_scan_i4(const void* q, const void* codes, const void* qm,
                     const void* f, const void* g, const void* m,
                     const void* bv, int use_qm, int B, int ww, int n_slices,
                     void* out, void* stream) {
  return pos_scan<I4>(q, codes, qm, f, g, m, bv, use_qm, B, ww, n_slices, out,
                      stream);
}

int evdb_fused_scan_i8(const void* q, const void* codes, const void* qmult,
                       const void* rowmult, const void* rowbias, int B, int ww,
                       int n_tiles, int t, void* vals, void* rows,
                       void* stream) {
  return fused_scan<I8>(q, codes, qmult, rowmult, rowbias, B, ww, n_tiles, t,
                        vals, rows, stream);
}

int evdb_fused_scan_f32(const void* q, const void* codes, const void* qmult,
                        const void* rowmult, const void* rowbias, int B, int ww,
                        int n_tiles, int t, void* vals, void* rows,
                        void* stream) {
  return fused_scan<F32>(q, codes, qmult, rowmult, rowbias, B, ww, n_tiles, t,
                         vals, rows, stream);
}

int evdb_fused_scan_i4(const void* q, const void* codes, const void* qmult,
                       const void* rowmult, const void* rowbias, int B, int ww,
                       int n_tiles, int t, void* vals, void* rows,
                       void* stream) {
  return fused_scan<I4>(q, codes, qmult, rowmult, rowbias, B, ww, n_tiles, t,
                        vals, rows, stream);
}

}  // extern "C"
