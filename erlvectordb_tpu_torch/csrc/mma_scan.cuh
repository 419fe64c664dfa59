// The int8 tensor-core tile core of the scans and the block mainloop they
// share (B1-B3 on int8 and packed int4 codes in fused_topk.cu, B4 and B6 in
// tile_scan.cu, B5 in residual_scan.cu): codes staged once per 128 queries
// (packed int4 unpacked once into shared memory), fragments read with
// ldmatrix, dots on mma.sync m16n8k32 s8 with int32 accumulators.  Integer
// sums are exact in any order, so a kernel built on this core gives the
// same dots as a __dp4a scan, bit for bit.
//
// Operands, as the mma sees them:
//   A (16 x 32 int8, row-major)  16 queries of the block's query tile;
//   B (32 x 8 int8, col-major)   8 code rows, each row's 32 bytes of k;
//   C (16 x 8 int32)             thread (g = lane / 4, t = lane % 4) holds
//                                [0], [1]: query g,     code rows 2t, 2t+1;
//                                [2], [3]: query g + 8, code rows 2t, 2t+1.
// A warp covers 16 queries x 64 code rows (8 n-blocks) per kK-wide k stage:
// one ldmatrix.x4 of query per 32 k, one ldmatrix.x4 per two n-blocks.
//
// Shared-memory layout: rows of int8 at a pitch of their width + 16 bytes,
// so the 8 rows an ldmatrix phase reads start 4 banks apart (conflict-free).
// Packed nibbles unpack to the order [high nibbles | low nibbles] of each
// 32-bit code word, i.e. elements [0 2 4 6 | 1 3 5 7] of its 8-element
// group: the order in which the wrappers already hand over the query.
//
// Below them, the bf16 mma.sync helpers of B7's gather (cell_probe.cu), on
// packed int4 and int8 codes.

#pragma once

#include "scan_common.cuh"

namespace evdb {
namespace mma {

constexpr int kWarpQ = 16;                  // queries per warp (one m16 tile)
constexpr int kRows = 64;                   // code rows per stage (8 n-blocks)
constexpr int kK = 128;                     // int8 elements per stage (64 packed B)
constexpr int kPad = 16;                    // row pitch pad, bytes
constexpr int kCodePitch = kK + kPad;       // 144 B

// byte-wise sign extension of four nibbles 0..15 -> int8 -8..7: a byte with
// bit 3 set gains 0xF0 (8 * 0x1E = 0xF0, no carry between bytes)
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t x) {
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// one packed code word (8 elements) -> two int8 words: high nibbles
// (elements 0, 2, 4, 6), then low nibbles (1, 3, 5, 7)
__device__ __forceinline__ uint2 unpack_word(uint32_t c) {
  return make_uint2(sext_nibbles((c >> 4) & 0x0F0F0F0Fu),
                    sext_nibbles(c & 0x0F0F0F0Fu));
}

// 16 packed bytes (32 elements) -> 32 int8 bytes at dst (16-byte aligned)
__device__ __forceinline__ void unpack_store(int8_t* dst, uint4 p) {
  const uint2 a = unpack_word(p.x), b = unpack_word(p.y);
  const uint2 c = unpack_word(p.z), d = unpack_word(p.w);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(a.x, a.y, b.x, b.y);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += dots of the warp's 16 query rows (qs: row 0 of them, pitch qp
// bytes, at the stage's first k) with the 64 code rows at cs (pitch
// kCodePitch) over kK elements; acc[j] is the C fragment of n-block j
// (code rows 8j .. 8j + 7).
__device__ __forceinline__ void warp_tile_dots(const int8_t* qs, int qp,
                                               const int8_t* cs, int (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3, r = lane & 7;
  // ldmatrix.x4 row addresses: lanes 8m .. 8m + 7 give matrix m's rows.
  // A: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
  // B: matrices (n-block j, k 0-15), (j, 16-31), (j + 1, 0-15), (j + 1, 16-31)
  const int8_t* qa = qs + ((m & 1) * 8 + r) * qp + (m >> 1) * 16;
  const int8_t* ca = cs + ((m >> 1) * 8 + r) * kCodePitch + (m & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < kK; ks += 32) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + ks);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, ca + j * 8 * kCodePitch + ks);
      mma_s8(acc[j], a, b[0], b[1]);
      mma_s8(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------- bf16 mma.sync (B7, int4 and int8 codes)
//
// mma.sync m16n8k16 bf16 with f32 accumulators, thread (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major)  a0: row g,     k 2t, 2t+1;  a1: row g + 8, same k;
//                           a2: row g,     k 2t+8, 2t+9; a3: row g + 8, same k;
//   B (16 x 8, col-major)   b0: k 2t, 2t+1, column g;   b1: k 2t+8, 2t+9;
//   C (16 x 8)              [0], [1]: row g, columns 2t, 2t+1; [2], [3]: row g + 8.
// The lower k of each pair sits in the register's low 16 bits.

// one packed code word (bytes i = 0..3, element 2i in the high nibble) ->
// four bf16x2, r[i] = (element 2i, element 2i + 1) of byte i: (n ^ 8) | 0x4300
// is the bf16 128 + (n ^ 8), less 136 the signed nibble (both steps exact)
__device__ __forceinline__ void nibbles_bf16(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t t0 = __byte_perm(hi, lo, 0x5140);   // h0 l0 h1 l1
  const uint32_t t1 = __byte_perm(hi, lo, 0x7362);   // h2 l2 h3 l3
  r[0] = __byte_perm(t0, 0x43434343u, 0x4140);
  r[1] = __byte_perm(t0, 0x43434343u, 0x4342);
  r[2] = __byte_perm(t1, 0x43434343u, 0x4140);
  r[3] = __byte_perm(t1, 0x43434343u, 0x4342);
#pragma unroll
  for (int i = 0; i < 4; ++i)   // x * 1.0 - 136.0
    asm("fma.rn.bf16x2 %0, %0, %1, %2;\n"
        : "+r"(r[i]) : "r"(0x3F803F80u), "r"(0xC308C308u));
}

// one int8 code word (signed bytes i = 0..3) -> two bf16x2, r[0] = (byte 0,
// byte 1), r[1] = (byte 2, byte 3): a byte's low 7 bits m under 0x43 are the
// bf16 128 + m, its sign bit s under 0xC3 the bf16 -(128 + 128 s), and their
// sum is the signed byte m - 128 s (every step exact)
__device__ __forceinline__ void bytes_bf16(uint32_t w, uint32_t (&r)[2]) {
  const uint32_t m = w & 0x7F7F7F7Fu, s = w & 0x80808080u;
  const uint32_t c0 = __byte_perm(s, 0xC3C3C3C3u, 0x4140);   // s0 C3 s1 C3
  const uint32_t c1 = __byte_perm(s, 0xC3C3C3C3u, 0x4342);   // s2 C3 s3 C3
  r[0] = __byte_perm(m, 0x43434343u, 0x4140);                // m0 43 m1 43
  r[1] = __byte_perm(m, 0x43434343u, 0x4342);
  asm("fma.rn.bf16x2 %0, %0, %1, %2;\n" : "+r"(r[0]) : "r"(0x3F803F80u), "r"(c0));
  asm("fma.rn.bf16x2 %0, %0, %1, %2;\n" : "+r"(r[1]) : "r"(0x3F803F80u), "r"(c1));
}

// two f32 -> one bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ------------------------------------------------------ the block mainloop

constexpr int kWarps = 8;
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kBlockQ = kWarpQ * kWarps;          // 128 queries per block
constexpr int kStages = 4;                        // copy ring depth, stages
constexpr int kStageBytes = kRows * kCodePitch;   // a stage of int8 rows
constexpr int kPackedStage = kRows * kK / 2;      // a stage of packed rows
constexpr int kQStage = kBlockQ * kCodePitch;     // a k stage of the query tile
constexpr int kSmemMax = 232448;                  // 227 KB a block may use

// Whether dots of a row of W codes (int8, or packed int4 in -8..7) with an
// int8 query can pass 2^22 in magnitude: |d| <= 128 * 128 * W, 8 * 128 * W.
__host__ __device__ constexpr bool wide_dots(bool packed, int W) {
  return (long long)(packed ? 8 : 128) * 128 * W > (1LL << 22);
}

// The int dot as f32.  For |d| <= 2^22, 1.5 * 2^23 + d holds d in its low
// mantissa bits: an integer add and an f32 subtract instead of a conversion
// (those issue at a quarter of the FFMA rate).  WIDE rows take the
// conversion, which rounds as the reference's int -> f32 does.
template <bool WIDE>
__device__ __forceinline__ float dot_f32(int d) {
  if constexpr (WIDE) return __int2float_rn(d);
  return __fsub_rn(__int_as_float(0x4B400000 + d), 12582912.0f);
}

// One block's share of a tensor-core scan: rows [row0, row0 + kRows *
// n_pieces) of ``codes`` (int8 rows of W bytes, or PACKED int4 rows of W / 2)
// against the kBlockQ queries from q0 (int8 rows of W bytes, zero past B),
// in stages of 64 rows x kK k through a ring of kStages stages of cp.async
// copies, one barrier a stage.  At the last k stage of each 64-row piece,
// the live warps call epi(acc, piece, rf, tab): acc holds the piece's dots
// (zeroed after the call), rf[r] the row factors of its row r (.x, .y, .z
// from f0, f1, f2 for the first NF of them; .w, with CELL, the row's cell
// less the piece's first cell) and tab, with CELL, the [kBlockQ][ncell]
// block of ``table`` ([B, ldt] f32) over the cells the piece spans.
//
// A warp whose 16 queries all lie past B is not live: it skips the dots and
// the epilogue and takes part in the copies and barriers only.  Rows of up
// to kStages k stages (W <= 512) keep the query tile in shared memory for
// the whole run; wider rows stream its k stage through the ring beside the
// codes'.  Int8 stages are copied straight into the rows ldmatrix reads;
// packed ones land in a ring of packed bytes that each thread unpacks (the
// 16 bytes it copied itself, one stage ahead) into a double buffer of rows.
//
// Dynamic shared memory, as ops/fused_topk.py::mma_scan_layout sizes it:
// codes (int8: kStages x [64][144]; packed: 2 x [64][144] int8, then
// kStages x [64 x 64 B]) | the query's k stages [min(kw, kStages)][kBlockQ]
// [144] | a ring of nf pieces' row factors [64] float4 | with CELL, their
// table blocks [kBlockQ][ncell] f32.  nf = 4 up to W 256, else 2: a piece's
// factors are issued kStages - 1 stages ahead of its first k stage and read
// at its last, so 1 + ceil(3 / kw) pieces are in flight (a power of two,
// for the index).
template <bool PACKED, int NF, bool CELL, class Epi>
__device__ __forceinline__ void scan_block(
    unsigned char* smem, const int8_t* __restrict__ q,
    const int8_t* __restrict__ codes, int B, int W, int q0, long long row0,
    int n_pieces, const float* f0, const float* f1, const float* f2,
    const float* __restrict__ table, int ldt, int cell_cap, int ncell,
    Epi&& epi) {
  const int kw = W / kK;                       // k stages per 64-row piece
  const bool q_res = kw <= kStages;
  const int nf = kw <= 2 ? 4 : 2;
  const int row_bytes = PACKED ? W / 2 : W;
  int8_t* cs = reinterpret_cast<int8_t*>(smem);
  unsigned char* pk = smem + (PACKED ? 2 : kStages) * kStageBytes;
  int8_t* qs = reinterpret_cast<int8_t*>(pk + (PACKED ? kStages * kPackedStage : 0));
  float4* rf = reinterpret_cast<float4*>(qs + min(kw, kStages) * kQStage);
  float* tab = reinterpret_cast<float*>(rf + nf * kRows);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_stage = n_pieces * kw;
  // the tile's rows up to the last warp with a query below B
  const int n_live = min(kBlockQ, (B - q0 + kWarpQ - 1) / kWarpQ * kWarpQ);
  const bool live = warp * kWarpQ < n_live;

  if (q_res) {   // the whole query tile, k stage by k stage, zero past B
    const int q16 = W / 16;
    for (int i = tid; i < n_live * q16; i += kBlockThreads) {
      const int r = i / q16, c = i % q16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q0 + r < B)
        v = __ldg(reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * W) + c);
      *reinterpret_cast<uint4*>(qs + (c >> 3) * kQStage + r * kCodePitch
                                + 16 * (c & 7)) = v;
    }
  }

  // a piece's row factors and table block, into slot piece % nf
  auto load_factors = [&](int piece) {
    const int buf = piece & (nf - 1);
    const long long r0 = row0 + (long long)piece * kRows;
    if (NF > 0 && tid < kRows) {
      float4* d = rf + buf * kRows + tid;
      const long long row = r0 + tid;
      cp_async4(&d->x, f0 + row, true);
      if constexpr (NF > 1) cp_async4(&d->y, f1 + row, true);
      if constexpr (NF > 2) cp_async4(&d->z, f2 + row, true);
      if constexpr (CELL) d->w = __int_as_float((int)(row / cell_cap - r0 / cell_cap));
    }
    if constexpr (CELL) {
      const long long c0 = r0 / cell_cap;
      float* tb = tab + buf * kBlockQ * ncell;
      for (int i = tid; i < n_live * ncell; i += kBlockThreads) {
        const int r = i / ncell, c = i % ncell;
        const bool ok = q0 + r < B && c0 + c < ldt;
        cp_async4(tb + i, ok ? table + (long long)(q0 + r) * ldt + c0 + c : table, ok);
      }
    }
  };
  // stage st: piece st / kw, k stage st % kw; one commit group per stage
  // (empty past the end, to keep the count)
  auto issue = [&](int st) {
    if (st < n_stage) {
      const int piece = st / kw, kc = st % kw;
      const long long rp = row0 + (long long)piece * kRows;
      if constexpr (PACKED) {   // 64 rows x 4 x 16 B: row tid / 4, part tid % 4
        cp_async16(pk + (st % kStages) * kPackedStage + 16 * tid,
                   codes + (rp + (tid >> 2)) * row_bytes + kc * (kK / 2)
                   + 16 * (tid & 3));
      } else {                  // 64 rows x 8 x 16 B, into the rows ldmatrix reads
        int8_t* d = cs + (st % kStages) * kStageBytes;
#pragma unroll
        for (int i = 0; i < kRows * kK / 16 / kBlockThreads; ++i) {
          const int e = tid + kBlockThreads * i, r = e >> 3, c = e & 7;
          cp_async16(d + r * kCodePitch + 16 * c,
                     codes + (rp + r) * row_bytes + kc * kK + 16 * c);
        }
      }
      if (!q_res) {   // k stage kc of the query tile: n_live rows x 8 x 16 B
        int8_t* d = qs + (st % kStages) * kQStage;
        for (int e = tid; e < n_live * 8; e += kBlockThreads) {
          const int r = e >> 3, c = e & 7;
          const bool ok = q0 + r < B;
          cp_async16(d + r * kCodePitch + 16 * c,
                     ok ? q + (long long)(q0 + r) * W + kc * kK + 16 * c : q, ok);
        }
      }
      if (kc == 0) load_factors(piece);
    }
    cp_async_commit();
  };
  auto unpack = [&](int st) {   // this thread's 16 bytes of stage st
    const uint4 p = *reinterpret_cast<const uint4*>(
        pk + (st % kStages) * kPackedStage + 16 * tid);
    unpack_store(cs + (st & 1) * kStageBytes + (tid >> 2) * kCodePitch
                 + (tid & 3) * 32, p);
  };

  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  // at stage st the copies of stage st + kStages - 1 are issued (into the
  // slots stage st - 1 freed) and, packed, stage st + 1 is unpacked; the
  // barrier that ends stage st publishes stage st + 1 to every warp
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  cp_async_wait<kStages - 2>();
  if constexpr (PACKED) {
    if (n_stage > 0) unpack(0);
  }
  __syncthreads();

  for (int st = 0; st < n_stage; ++st) {
    const int piece = st / kw, kc = st % kw;
    issue(st + kStages - 1);
    cp_async_wait<kStages - 2>();      // this thread's stage st + 1
    if constexpr (PACKED) {
      if (st + 1 < n_stage) unpack(st + 1);
    }
    if (live) {
      const int8_t* qw = qs + (q_res ? kc : st % kStages) * kQStage
                         + warp * kWarpQ * kCodePitch;
      warp_tile_dots(qw, kCodePitch,
                     cs + (PACKED ? (st & 1) : st % kStages) * kStageBytes, acc);
      if (kc == kw - 1) {
        const int buf = piece & (nf - 1);
        epi(acc, piece, rf + buf * kRows, tab + buf * kBlockQ * ncell);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      }
    }
    __syncthreads();
  }
}

// Raise a kernel's dynamic shared-memory cap to kSmemMax and ask for the
// largest shared-memory carveout (two blocks of up to 113 KB an SM);
// returns a cudaError_t.  Each launcher calls it once per instantiation
// (``static const int rc = configure(kernel);``).
template <class Kernel>
int configure(Kernel* kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

}  // namespace mma
}  // namespace evdb
