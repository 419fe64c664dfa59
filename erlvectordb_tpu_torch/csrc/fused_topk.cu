// Fused distance + top-k scans for Hopper (sm_90a): the four kernels of the
// store's search path, ported from erlvectordb_tpu/ops/fused_topk.py.
//
//   B1 intkey_scan  <- _intkey_scan / _make_intkey_kernel
//        key[b, s] = max over the 1024-row slice s of (dot(q8[b], c8[r]) << 10) | lane
//   B2 l2key_scan   <- _l2key_scan / _make_l2key_kernel
//        key[b, s] = max over s of ((dot - bias[r]) << 10) | lane
//   B3 pos_scan     <- _pos_scan / _make_pos_kernel (int8 and f32 codes)
//        s = (fma(dot * m[r] (* qm[b]), bv[r]) - f[b]) * g[b]
//        key = (int32(clip(rint(s), +-2e9)) & ~1023) | lane, max per slice
//   B4 fused_scan   <- _fused_scan / _make_scan_kernel, cell_cap == 0 (int8 and f32)
//        sims = fma(dot * qmult[b], rowmult[r], rowbias[r]); monotone float->int
//        key with the low 12 bits = lane in a 4096-row tile; top-T per tile
//
// What bounds them on an H100: the scan reads the whole code plane once per
// query group, so at 1024 queries x 1.2M x 128 int8 the work is ~315 G int8
// MACs against ~150 MB of codes: compute-bound.  This first version does the
// dots with __dp4a (4 int8 MACs per instruction, no tensor cores) or fmaf for
// f32 codes, which puts its floor well above the int8 tensor-core roofline;
// wgmma/TMA staging is later work.  The simple design:
//   * one block of 256 threads per (1024-row slice or 4096-row tile, group of
//     queries); blocks are independent, so nothing carries across them;
//   * codes are staged through shared memory in coalesced [256 rows x 64 B]
//     pieces (row stride padded by one word so each thread reads its own row
//     without bank conflicts) and the query group's matching 64 B columns are
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // rows of a staged piece; one per thread
constexpr int kSlice = 1024;    // POS_SLICE: rows per key slice (B1-B3)
constexpr int kTile = 4096;     // TILE_N: rows per masked-extraction tile (B4)
constexpr int kWords = 16;      // 32-bit words of a row per staged piece (64 B)
constexpr int kSliceQ = 32;     // queries per block, B1-B3
constexpr int kTileQ = 8;       // queries per block, B4 (T keys each per thread)

enum Mode { kIntkey = 0, kL2key = 1, kPos = 2 };

// One 32-bit word holds 4 int8 codes (int) or one f32 code (float).
__device__ __forceinline__ int dot_word(int a, int b, int acc) {
  return __dp4a(a, b, acc);
}
__device__ __forceinline__ float dot_word(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float to_f32(int d) { return __int2float_rn(d); }
__device__ __forceinline__ float to_f32(float d) { return d; }

template <typename Word> struct Vec4;
template <> struct Vec4<int> { using T = int4; };
template <> struct Vec4<float> { using T = float4; };

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dots of NQ queries against the thread's row of the current 256-row piece.
// The whole row width is walked in kWords-word steps; every thread of the
// block must call this (it synchronises).
template <typename Word, int NQ>
__device__ __forceinline__ void piece_dots(
    const Word* __restrict__ q, const Word* __restrict__ codes, int B, int ww,
    int q0, long long row0, Word (*cs)[kWords + 1], Word (*qs)[kWords],
    Word acc[NQ]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = Word(0);
  for (int w0 = 0; w0 < ww; w0 += kWords) {
    // codes piece: 256 rows x 16 words, consecutive threads on consecutive words
#pragma unroll
    for (int i = t; i < kThreads * kWords; i += kThreads) {
      const int r = i / kWords, w = i % kWords;
      cs[r][w] = codes[(row0 + r) * ww + w0 + w];
    }
    for (int i = t; i < NQ * kWords; i += kThreads) {
      const int j = i / kWords, w = i % kWords;
      qs[j][w] = (q0 + j < B) ? q[(long long)(q0 + j) * ww + w0 + w] : Word(0);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; w += 4) {
      const Word a0 = cs[t][w], a1 = cs[t][w + 1], a2 = cs[t][w + 2], a3 = cs[t][w + 3];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const typename Vec4<Word>::T v =
            *reinterpret_cast<const typename Vec4<Word>::T*>(&qs[j][w]);
        Word s = dot_word(a0, v.x, acc[j]);
        s = dot_word(a1, v.y, s);
        s = dot_word(a2, v.z, s);
        acc[j] = dot_word(a3, v.w, s);
      }
    }
    __syncthreads();
  }
}

// B1, B2, B3: one block per (1024-row slice, 32 queries).
template <typename Word, int MODE>
__global__ void __launch_bounds__(kThreads) slice_scan_kernel(
    const Word* __restrict__ q, const Word* __restrict__ codes, int B, int ww,
    int n_slices, const int* __restrict__ bias, const float* __restrict__ qm,
    const float* __restrict__ f, const float* __restrict__ g,
    const float* __restrict__ m, const float* __restrict__ bv, int use_qm,
    int* __restrict__ out) {
  __shared__ Word cs[kThreads][kWords + 1];
  __shared__ __align__(16) Word qs[kSliceQ][kWords];
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
    piece_dots<Word, kSliceQ>(q, codes, B, ww, q0, row0, cs, qs, acc);
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

// B4: one block per (4096-row tile, 8 queries); top-T per tile and query.
template <typename Word, int T>
__global__ void __launch_bounds__(kThreads) tile_scan_kernel(
    const Word* __restrict__ q, const Word* __restrict__ codes, int B, int ww,
    int n_tiles, const float* __restrict__ qmult,
    const float* __restrict__ rowmult, const float* __restrict__ rowbias,
    float* __restrict__ vals, int* __restrict__ rows) {
  __shared__ Word cs[kThreads][kWords + 1];
  __shared__ __align__(16) Word qs[kTileQ][kWords];
  __shared__ int red[2][kThreads / 32];
  const int tile = blockIdx.x, q0 = blockIdx.y * kTileQ, t = threadIdx.x;

  float qmul[kTileQ];
#pragma unroll
  for (int j = 0; j < kTileQ; ++j) qmul[j] = (q0 + j < B) ? qmult[q0 + j] : 0.f;

  // per-thread top-T packed keys per query, sorted descending
  int top[kTileQ][T];
#pragma unroll
  for (int j = 0; j < kTileQ; ++j)
#pragma unroll
    for (int i = 0; i < T; ++i) top[j][i] = INT32_MIN;

  for (int p = 0; p < kTile / kThreads; ++p) {
    const long long row0 = (long long)tile * kTile + p * kThreads;
    Word acc[kTileQ];
    piece_dots<Word, kTileQ>(q, codes, B, ww, q0, row0, cs, qs, acc);
    const long long row = row0 + t;
    const uint32_t lane = (uint32_t)(p * kThreads + t);  // row & 4095
    const float rm = rowmult[row], rb = rowbias[row];
#pragma unroll
    for (int j = 0; j < kTileQ; ++j) {
      const float sims = __fmaf_rn(__fmul_rn(to_f32(acc[j]), qmul[j]), rm, rb);
      const uint32_t si = (uint32_t)__float_as_int(sims);
      // float order -> int order: negative floats map to INT32_MIN - si
      const uint32_t key = ((int)si >= 0) ? si : 0x80000000u - si;
      int v = (int)((key & ~0xFFFu) | lane);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int hi = max(top[j][i], v);
        v = min(top[j][i], v);
        top[j][i] = hi;
      }
    }
  }

  // T rounds of a block max per query; lane bits make keys unique, so exactly
  // one thread holds each winner and pops it off its list
  const int warp = t / 32;
  int round = 0;
#pragma unroll
  for (int j = 0; j < kTileQ; ++j) {
#pragma unroll
    for (int r = 0; r < T; ++r, ++round) {
      const int v = warp_max(top[j][0]);
      if ((t & 31) == 0) red[round & 1][warp] = v;
      __syncthreads();
      int mx = red[round & 1][0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) mx = max(mx, red[round & 1][w]);
      if (top[j][0] == mx) {
#pragma unroll
        for (int i = 0; i + 1 < T; ++i) top[j][i] = top[j][i + 1];
        top[j][T - 1] = INT32_MIN;
      }
      if (t == 0 && q0 + j < B) {
        const uint32_t kt = (uint32_t)mx & ~0xFFFu;
        const uint32_t sr = ((int)kt >= 0) ? kt : 0x80000000u - kt;
        const long long o = (long long)(q0 + j) * n_tiles * T + (long long)tile * T + r;
        vals[o] = __int_as_float((int)sr);
        rows[o] = (int)((uint32_t)mx & 0xFFFu) + tile * kTile;
      }
    }
  }
}

template <typename Word, int MODE>
int launch_slice(const void* q, const void* codes, int B, int ww, int n_slices,
                 const void* bias, const void* qm, const void* f, const void* g,
                 const void* m, const void* bv, int use_qm, void* out,
                 void* stream) {
  const dim3 grid(n_slices, (B + kSliceQ - 1) / kSliceQ);
  slice_scan_kernel<Word, MODE><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const Word*)q, (const Word*)codes, B, ww, n_slices, (const int*)bias,
      (const float*)qm, (const float*)f, (const float*)g, (const float*)m,
      (const float*)bv, use_qm, (int*)out);
  return (int)cudaGetLastError();
}

template <typename Word>
int launch_tile(const void* q, const void* codes, int B, int ww, int n_tiles,
                int t, const void* qmult, const void* rowmult,
                const void* rowbias, void* vals, void* rows, void* stream) {
  const dim3 grid(n_tiles, (B + kTileQ - 1) / kTileQ);
  cudaStream_t st = (cudaStream_t)stream;
  const Word* qq = (const Word*)q;
  const Word* cc = (const Word*)codes;
  const float *qm = (const float*)qmult, *rm = (const float*)rowmult,
              *rb = (const float*)rowbias;
  if (t == 2)
    tile_scan_kernel<Word, 2><<<grid, kThreads, 0, st>>>(qq, cc, B, ww, n_tiles, qm, rm, rb, (float*)vals, (int*)rows);
  else if (t == 4)
    tile_scan_kernel<Word, 4><<<grid, kThreads, 0, st>>>(qq, cc, B, ww, n_tiles, qm, rm, rb, (float*)vals, (int*)rows);
  else if (t == 8)
    tile_scan_kernel<Word, 8><<<grid, kThreads, 0, st>>>(qq, cc, B, ww, n_tiles, qm, rm, rb, (float*)vals, (int*)rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C interface
// Row widths arrive in 32-bit words: W/4 for int8 rows, W for f32 rows.

extern "C" {

int evdb_intkey_scan(const void* q, const void* codes, int B, int ww,
                     int n_slices, void* out, void* stream) {
  return launch_slice<int, kIntkey>(q, codes, B, ww, n_slices, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, 0, out,
                                    stream);
}

int evdb_l2key_scan(const void* q, const void* codes, const void* bias, int B,
                    int ww, int n_slices, void* out, void* stream) {
  return launch_slice<int, kL2key>(q, codes, B, ww, n_slices, bias, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, 0, out,
                                   stream);
}

int evdb_pos_scan_i8(const void* q, const void* codes, const void* qm,
                     const void* f, const void* g, const void* m,
                     const void* bv, int use_qm, int B, int ww, int n_slices,
                     void* out, void* stream) {
  return launch_slice<int, kPos>(q, codes, B, ww, n_slices, nullptr, qm, f, g,
                                 m, bv, use_qm, out, stream);
}

int evdb_pos_scan_f32(const void* q, const void* codes, const void* qm,
                      const void* f, const void* g, const void* m,
                      const void* bv, int use_qm, int B, int ww, int n_slices,
                      void* out, void* stream) {
  return launch_slice<float, kPos>(q, codes, B, ww, n_slices, nullptr, qm, f, g,
                                   m, bv, use_qm, out, stream);
}

int evdb_fused_scan_i8(const void* q, const void* codes, const void* qmult,
                       const void* rowmult, const void* rowbias, int B, int ww,
                       int n_tiles, int t, void* vals, void* rows,
                       void* stream) {
  return launch_tile<int>(q, codes, B, ww, n_tiles, t, qmult, rowmult, rowbias,
                          vals, rows, stream);
}

int evdb_fused_scan_f32(const void* q, const void* codes, const void* qmult,
                        const void* rowmult, const void* rowbias, int B, int ww,
                        int n_tiles, int t, void* vals, void* rows,
                        void* stream) {
  return launch_tile<float>(q, codes, B, ww, n_tiles, t, qmult, rowmult,
                            rowbias, vals, rows, stream);
}

}  // extern "C"
