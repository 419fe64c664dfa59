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
// operands) or fmaf for B4's f32 codes, which puts its floor well above the
// int8 tensor-core roofline (residual_scan.cu's B5 runs on mma_scan.cuh's
// tensor-core tile core, which these can take over).  The simple design:
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
// B3 on f32 codes (the default f32 store's scan) is its own kernel,
// pos_f32_kernel: at 1024 queries x 1.2M rows x 128 dims it is 1.57e11 f32
// FMAs, 4.7 ms at the 67 TFLOP/s of the CUDA cores, and the one-row-a-thread
// layout above is bound by shared-memory issue (one LDS.128 per 4 FFMA).  It
// is a register-tiled SIMT product, as an SGEMM is:
//   * one block of 256 threads per (128-query tile, 1024-row slice), the
//     slice walked in 128-row tiles; each thread owns an 8 x 8 (rows x
//     queries) outer-product micro-tile, rows ty + 16 i and queries tx + 16 j
//     of the 16 x 16 thread grid;
//   * codes and queries come in chunks of 64 k (rows at a pitch of 68
//     floats) by 16-byte cp.async, double-buffered with one barrier a chunk
//     (a wide chunk means fewer barriers and copies per FFMA); a thread
//     reads 4 k of its 8 rows and 8 queries with 16 LDS.128 and does 256
//     FFMA;
//   * every dot is one fmaf chain over k = 0 .. W-1 in order, as in the
//     kernel it replaces: no TF32 and no split-precision tensor-core
//     emulation, whose products round otherwise;
//   * the epilogue runs on the micro-tile in the order above, folding each
//     key into a running max per (query, slice); at the end of the slice the
//     16 threads of a query column reduce by one shuffle and shared memory.
// What bounds it now: a bit over half the FFMA rate.  One block of 8 warps
// an SM (254 registers a thread) leaves little to hide each chunk's barrier
// and the epilogue, by count about a tenth of the FFMAs' issue at W 128.
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

// B3 on f32 codes: one block per (kFQ-query tile, 1024-row slice), in a
// 1-D grid with the query tile fastest, so the blocks that read a slice's
// codes run together (and the slice count has no grid.y limit).
constexpr int kFQ = 128;          // queries per block
constexpr int kFR = 128;          // rows per tile of the slice
constexpr int kFK = 64;           // k per staged chunk
constexpr int kFP = kFK + 4;      // smem row pitch (floats): 16-B aligned, and
                                  // 8 rows 68 words apart hit distinct banks
constexpr int kFStages = 2;       // cp.async pipeline depth
constexpr int kFStageFloats = 2 * kFR * kFP;   // codes then queries
constexpr int kFSmem = kFStages * kFStageFloats * 4;   // 139,264 B, dynamic

// Thread (tx, ty) of the 16 x 16 grid owns rows ty + 16 i and queries
// tx + 16 j (i, j < 8) of the block's 128 x 128 tile; the stages hold rows
// of kFK k each (row-major at pitch kFP), so a thread reads 4 k of a row or a
// query with one LDS.128 and the 8 queries' reads of a warp phase fall on
// distinct banks.
template <bool QM>
__global__ void __launch_bounds__(kThreads, 1) pos_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ codes, int B, int W,
    int n_slices, const float* __restrict__ qm, const float* __restrict__ f,
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ bv, int* __restrict__ out) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ float qm_s[kFQ], f_s[kFQ], g_s[kFQ];
  __shared__ int red[kThreads / 32][kFQ];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_tiles = (B + kFQ - 1) / kFQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * kFQ, s = (int)(blockIdx.x / q_tiles);
  const long long slice0 = (long long)s * kSlice;
  if (tid < kFQ) {   // read after the first barrier
    const bool ok = q0 + tid < B;
    qm_s[tid] = ok ? qm[q0 + tid] : 0.f;
    f_s[tid] = ok ? f[q0 + tid] : 0.f;
    g_s[tid] = ok ? g[q0 + tid] : 0.f;
  }
  const int kch = W / kFK;
  const int n_stage = (kSlice / kFR) * kch;

  // stage st: row tile st / kch, k chunk st % kch; 16-byte piece e = tid +
  // 256 p of each [128 x kFK] operand is row e / (kFK / 4), k 4 (e % (kFK / 4))
  auto issue = [&](int st) {
    if (st < n_stage) {
      float* cs = fsm + (st % kFStages) * kFStageFloats;
      float* qs = cs + kFR * kFP;
      const long long row0 = slice0 + (long long)(st / kch) * kFR;
      const int k0 = (st % kch) * kFK;
#pragma unroll
      for (int p = 0; p < kFR * kFK / 4 / kThreads; ++p) {
        const int e = tid + kThreads * p, r = e / (kFK / 4), c = 4 * (e % (kFK / 4));
        cp_async16(cs + r * kFP + c, codes + (row0 + r) * W + k0 + c, true);
        const bool ok = q0 + r < B;
        cp_async16(qs + r * kFP + c, ok ? q + (long long)(q0 + r) * W + k0 + c : q, ok);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int best[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) best[j] = INT32_MIN;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) issue(st);
  for (int st = 0; st < n_stage; ++st) {
    cp_async_wait<kFStages - 2>();   // this thread's copies of stage st
    __syncthreads();                 // everyone's, and stage st - 1 is done
    issue(st + kFStages - 1);        // into the buffer stage st - 1 used
    const float* cs = fsm + (st % kFStages) * kFStageFloats;
    const float* qs = cs + kFR * kFP;
#pragma unroll
    for (int k4 = 0; k4 < kFK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * kFP + k4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(qs + (tx + 16 * j) * kFP + k4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {   // k in order: one fmaf chain per dot
          float c = __fmaf_rn(a[i].x, b.x, acc[i][j]);
          c = __fmaf_rn(a[i].y, b.y, c);
          c = __fmaf_rn(a[i].z, b.z, c);
          acc[i][j] = __fmaf_rn(a[i].w, b.w, c);
        }
      }
    }
    if (st % kch == kch - 1) {
      // epilogue of this row tile, in the JAX kernel's operation order
      const int rt = st / kch;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rl = rt * kFR + ty + 16 * i;   // row & 1023
        const float mr = __ldg(m + slice0 + rl), br = __ldg(bv + slice0 + rl);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qj = tx + 16 * j;
          float v = acc[i][j];
          v = QM ? __fmaf_rn(__fmul_rn(v, mr), qm_s[qj], br) : __fmaf_rn(v, mr, br);
          v = __fmul_rn(__fsub_rn(v, f_s[qj]), g_s[qj]);
          // rint after the clamp (integer bounds): one conversion, not two
          const int si = __float2int_rn(fminf(fmaxf(v, -2.0e9f), 2.0e9f));
          best[j] = max(best[j], (int)(((uint32_t)si & ~1023u) | (uint32_t)rl));
          acc[i][j] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // the 16 threads of a query column: ty = 2w, 2w + 1 in warp w, then 8 warps
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = max(best[j], __shfl_xor_sync(0xffffffffu, best[j], 16));
    if ((tid & 31) < 16) red[warp][tx + 16 * j] = v;
  }
  __syncthreads();
  if (tid < kFQ && q0 + tid < B) {
    int v = red[0][tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) v = max(v, red[w][tid]);
    out[(long long)(q0 + tid) * n_slices + s] = v;
  }
}

template <bool QM>
int launch_pos_f32(int blocks, cudaStream_t st, const float* q, const float* codes,
                   int B, int W, int n_slices, const float* qm, const float* f,
                   const float* g, const float* m, const float* bv, int* out) {
  static bool configured = false;   // above 48 KB of dynamic shared memory
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        pos_f32_kernel<QM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  pos_f32_kernel<QM><<<blocks, kThreads, kFSmem, st>>>(q, codes, B, W, n_slices, qm,
                                                     f, g, m, bv, out);
  return (int)cudaGetLastError();
}

int pos_scan_f32(const void* q, const void* codes, const void* qm, const void* f,
                 const void* g, const void* m, const void* bv, int use_qm, int B,
                 int W, int n_slices, void* out, void* stream) {
  if (W % kFK) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kFQ - 1) / kFQ * n_slices;
  auto go = use_qm ? launch_pos_f32<true> : launch_pos_f32<false>;
  return go(blocks, (cudaStream_t)stream, (const float*)q, (const float*)codes, B, W,
            n_slices, (const float*)qm, (const float*)f, (const float*)g,
            (const float*)m, (const float*)bv, (int*)out);
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
  return pos_scan_f32(q, codes, qm, f, g, m, bv, use_qm, B, ww, n_slices, out,
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
