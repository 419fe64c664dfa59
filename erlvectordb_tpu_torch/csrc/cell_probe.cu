// B7, the multiprobe gather + dot for Hopper (sm_90a), ported from
// erlvectordb_tpu/ops/cell_probe.py (_dma_gather_dots, kernel bodies
// _gather_dots_kernel and _gather_dots_kernel_packed).
//
//   out[b, j, c] = sum_w q[b, w] * code(cells[probe[b, j]], c, w)
//
// for each query b and each probed cell j: the query row against the probed
// cell's [cap, W] block of residual codes.  Two code layouts, two kernels:
//
//   I8   [K, cap, W] int8 (the cell-probe index's 8-bit residuals):
//        gather_dots_kernel, one block per (query, probe);
//   I4   [K, cap, W/2] uint8, two signed nibbles a byte, element 2p in the
//        high nibble (the int4r store's own rows): gather_mma_kernel, on
//        windows of (query, probe) pairs sorted by cell.
//
// Both take the query rounded to bf16 (held as f32), so every product is
// exact and results differ from any other f32 order of summation only by
// the rounding of the sums.  Probe ids outside [0, K) are clamped into it.
//
// What bounds it on an H100: the bytes, each distinct probed cell's block
// read once plus the [B, nprobe, cap] f32 output (25% of those bytes at
// (f-mp)'s nprobe 64, 72% at nprobe 512); the products, ~1 a byte, are far
// below the ~295 a byte where the tensor cores would be the limit.
//
// I8 (the first port's design, kept).  The block reads probe[b, j], holds the query row in
// shared memory and walks the cell's rows.  A row is G lanes of a warp (G =
// the row's 16-byte pieces rounded up to a power of two, at most 32): each
// lane loads 16-byte pieces of the row, converts the codes to f32 and
// accumulates products with the query in f32 (one __fmaf_rn chain per lane),
// and the G lanes finish with a shuffle reduction.  A lane's piece meets 64
// contiguous bytes of the query, so the query's 16-byte chunks are stored
// swizzled (chunk c at c ^ ((c >> 3) & 7)): the eight lanes of a quarter
// warp read eight different bank groups.  A code becomes an f32 by a byte
// permute into the mantissa of 2^23 and one subtraction, not by the
// quarter-rate I2F.  It reads a block once per (query, probe): 6.44 GB where
// 4.36 GB would do at the cell-probe index's shapes.
//
// I4.  What the design does about the bytes:
//
//   * The plan (ops/cell_probe.py::b7_plan): the wrapper sorts the flat
//     probe ids, keeping the pair order (``order``), with no host sync.  A
//     block takes a window of S consecutive sorted pairs (S <= 32) and walks
//     the runs of equal cells in it, so a cell is read at most (distinct
//     cells + windows) times per batch, not once per pair; a run crossing
//     into the next window is read again by that window's block, from L2.
//     For one query, or few pairs, nothing is sorted: windows of 1 to 8
//     pairs in pair order, each pair its own run, whose tiles the window's
//     block pipelines.
//   * The staging: a run's cell goes to shared memory through cp.async in
//     tiles of 128 rows x 128 k (64 bytes a row), double-buffered, so the
//     next tile's copy (or the next run's) is in flight during this tile's
//     products; shared memory stays at 26 KB (windows of up to 8 pairs) or
//     54 KB (up to 32) for any cap and W.  The run's queries are staged per
//     k chunk as bf16, converted from the f32 rows; in windows of up to 8
//     pairs, the rows are loaded into registers a stage ahead and the first
//     tile's copy and query loads go out before the window's runs are
//     worked out (gather_mma_kernel's EARLY).
//   * The products: mma.sync m16n8k16 bf16 with f32 accumulators (the
//     helpers in mma_scan.cuh).  A is 16 code rows (one warp a 16-row slice
//     of the tile), B the run's queries, 8 to an n-tile (a run of r queries
//     takes ceil(r / 8) of at most 4; idle columns are zero and not
//     stored).  Nibbles become bf16 in registers ((n ^ 8) | 0x4300, less
//     136: exact), not through I2F.  Each element's k sequence is the same
//     whatever its window or its column, so the output does not depend on S.
//   * The output: the C fragments go through shared memory, and each pair's
//     strip of rows is written as 16-byte vectors (streaming stores, so the
//     output does not push the cells out of L2), to out[order[i], row].
//
// The k order, stated once.  In each 128-element chunk of a row (64 packed
// bytes), thread t of a quad owns bytes 16t .. 16t + 15, one 32-bit word w
// (0..3) for each pair of mma k steps 2w, 2w + 1.  Byte 16t + 4w + 2s + j
// is the A pair of k step 2w + s at k 2t + 8j, 2t + 8j + 1 (its high nibble
// the lower k): elements 32t + 8w + 4s + 2j + {0, 1} of the chunk.  The
// query's bf16 chunk is staged with its 8-element groups transposed
// (position 32m + 8t + i holds element 32t + 8m + i,
// ops/cell_probe.py::b7_query_order), so thread t's B pairs for k steps 2w,
// 2w + 1 are the 16 bytes at 64w + 16t of a query's staged row, and the
// rows of a quarter warp's 16-byte loads fall in distinct banks (query rows
// 320 bytes apart, code rows 64).  A row's tail chunk (W % 128) is zero
// past W on both sides.
//
// The entry points launch on the given stream, allocate nothing, and return
// cudaGetLastError().

#include "mma_scan.cuh"

namespace {

using namespace evdb;

// ------------------------------------------------------------------- I8

constexpr int kProbeThreads = 256;

// the shared-memory slot of the query's 16-byte chunk c
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

// signed byte i of a 32-bit word, as f32: the biased byte in the mantissa of
// 2^23, less 2^23 + 128 (exact)
template <int I>
__device__ __forceinline__ float sbyte(uint32_t biased) {
  return __fsub_rn(__int_as_float((int)__byte_perm(biased, 0x4B000000u, 0x7440 | I)),
                   8388736.0f);
}

// the four signed bytes of w against q.x..q.w
__device__ __forceinline__ float word4(uint32_t w, float4 q, float acc) {
  const uint32_t b = w ^ 0x80808080u;
  acc = __fmaf_rn(sbyte<0>(b), q.x, acc);
  acc = __fmaf_rn(sbyte<1>(b), q.y, acc);
  acc = __fmaf_rn(sbyte<2>(b), q.z, acc);
  return __fmaf_rn(sbyte<3>(b), q.w, acc);
}

// the 16 int8 codes of piece p against query chunks 4p .. 4p+3
__device__ __forceinline__ float piece_i8(uint4 c, const float4* __restrict__ qs,
                                          int p, float acc) {
  acc = word4(c.x, qs[swz(4 * p + 0)], acc);
  acc = word4(c.y, qs[swz(4 * p + 1)], acc);
  acc = word4(c.z, qs[swz(4 * p + 2)], acc);
  return word4(c.w, qs[swz(4 * p + 3)], acc);
}

__global__ void __launch_bounds__(kProbeThreads) gather_dots_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ probe,
    const float* __restrict__ q, int n_cells, int cap, int row_bytes, int w,
    int nprobe, int group, float* __restrict__ out) {
  extern __shared__ __align__(16) float4 qs[];
  const long long pair = blockIdx.x;            // b * nprobe + j
  const long long b = pair / nprobe;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float4* qrow = reinterpret_cast<const float4*>(q + b * w);
  for (int c = t; c < w / 4; c += kProbeThreads) qs[swz(c)] = qrow[c];
  const int cell = min(max(probe[pair], 0), n_cells - 1);
  const uint8_t* blk = codes + (long long)cell * cap * row_bytes;
  float* o = out + pair * cap;
  __syncthreads();

  const int pieces = row_bytes / 16;
  const int rows_per_warp = 32 / group;
  const int sub = lane / group, gl = lane % group;
  const int nwarps = kProbeThreads / 32;
  // the bound is uniform across the warp, so every lane reaches the shuffles
  for (int r0 = warp * rows_per_warp; r0 < cap; r0 += nwarps * rows_per_warp) {
    const int row = r0 + sub;
    float acc = 0.f;
    if (row < cap) {
      const uint4* src = reinterpret_cast<const uint4*>(blk + (long long)row * row_bytes);
      for (int p = gl; p < pieces; p += group) acc = piece_i8(src[p], qs, p, acc);
    }
    for (int off = group / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (row < cap && gl == 0) o[row] = acc;
  }
}

// ------------------------------------------------------------------- I4

constexpr int kMmaThreads = 256;                 // 8 warps, 16 rows each
constexpr int kTileRows = 128;                   // code rows of a tile
constexpr int kChunk = 128;                      // k elements of a chunk
constexpr int kChunkBytes = kChunk / 2;          // packed bytes of a row's chunk
constexpr int kMaxWindow = 32;                   // pairs of a window, at most
constexpr int kQPitch = 2 * kChunk + 64;         // bytes of a staged query row
constexpr int kCPitch = kTileRows + 4;           // words of a staged C column

// NQ: the query columns a block stages, the window rounded up to whole
// n-tiles (8: windows of up to 8 pairs; 32: up to kMaxWindow)
template <int NQ>
struct MmaSmem {
  uint8_t codes[2][kTileRows * kChunkBytes];     // the tile ring, 2 x 8 KB
  uint8_t qs[2][NQ * kQPitch];                   // the query chunk, 2 slots
  float cs[NQ * kCPitch];                        // C of a tile, column-major
  long long pair[NQ];                            // the window's flat pairs
  long long qrow[NQ];                            // their queries
  int run0[NQ + 1];                              // window slots the runs start at
  int cell[NQ];                                  // their clamped cells
  int nruns;
};

// the warp's 16 code rows of a chunk (cw: pitch kChunkBytes) against the
// run's nt n-tiles of staged query (qs), into acc
template <int NT>
__device__ __forceinline__ void warp_chunk_dots(const uint8_t* cw, const uint8_t* qs,
                                                int nt, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 ra = *reinterpret_cast<const uint4*>(cw + g * kChunkBytes + 16 * t);
  const uint4 rb = *reinterpret_cast<const uint4*>(cw + (g + 8) * kChunkBytes + 16 * t);
  const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w};
  const uint32_t wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {   // word c: k steps 2c, 2c + 1
    uint32_t x[4], y[4];          // rows g, g + 8: byte i as a bf16 pair
    mma::nibbles_bf16(wa[c], x);
    mma::nibbles_bf16(wb[c], y);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const uint4 qv = *reinterpret_cast<const uint4*>(
            qs + (8 * j + g) * kQPitch + 64 * c + 16 * t);
        mma::mma_bf16(acc[j], x[0], y[0], x[1], y[1], qv.x, qv.y);
        mma::mma_bf16(acc[j], x[2], y[2], x[3], y[3], qv.z, qv.w);
      }
    }
  }
}

// One block per window of ``window`` consecutive pairs: ``cells`` the probe
// ids (clamped here), sorted, and ``order`` their flat pairs; or, with no
// ``order``, the ids in pair order (runs are then mostly single pairs, and
// the window only pipelines their tiles).  EARLY (the windows of up to 8
// pairs, NQ 8): stage 0's copy and query loads go out before the window's
// runs are worked out, and each next stage's query loads before this
// stage's products.  Without it (NQ 32: 16 registers of loads held across
// the products would cost a block an SM, measured), a stage's query is
// loaded after the previous stage's output, beside its tile's copy.
template <int NQ, bool EARLY>
__global__ void __launch_bounds__(kMmaThreads) gather_mma_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ cells,
    const long long* __restrict__ order, const float* __restrict__ q,
    int n_cells, int cap, int row_bytes, int w, int nprobe, long long n_pairs,
    int window, float* __restrict__ out) {
  constexpr int NT = NQ / 8;                       // n-tiles of a run, at most
  constexpr int kJobs = NQ * 32 / kMmaThreads;     // query float4s a thread stages
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<NQ>& sm = *reinterpret_cast<MmaSmem<NQ>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long w0 = (long long)blockIdx.x * window;
  const int n_win = (int)min((long long)window, n_pairs - w0);
  const int nk = (w + kChunk - 1) / kChunk;
  const int per_run = (cap + kTileRows - 1) / kTileRows * nk;

  // stage st = (run u, row tile, chunk kc): its code tile of the run's
  // ``cell`` into slot st & 1, zero past cap and past the row
  auto issue = [&](int st, int cell) {
    const int rem = st % per_run;
    const int row0 = rem / nk * kTileRows, byte0 = rem % nk * kChunkBytes;
    const uint8_t* blk = codes + (long long)cell * cap * row_bytes;
    uint8_t* d = sm.codes[st & 1];
#pragma unroll
    for (int i = 0; i < kTileRows * kChunkBytes / 16 / kMmaThreads; ++i) {
      const int e = tid + kMmaThreads * i, r = e >> 2, piece = e & 3;
      const int byte = byte0 + 16 * piece;
      const bool ok = row0 + r < cap && byte < row_bytes;
      cp_async16(d + r * kChunkBytes + 16 * piece,
                 ok ? blk + (long long)(row0 + r) * row_bytes + byte : blk, ok);
    }
  };
  // the query of a stage, a float4 a job, loaded into registers ahead of
  // its use (ld) and stored as bf16 in the k order (st): job e is column
  // e / 32, 8-element group (e % 32) / 2 = 4m + t, half e % 2, i.e. elements
  // kc * 128 + 32t + 8m + 4 * half; zero past the column's ``ok`` and past W
  float4 qv[kJobs];
  auto ld = [&](int kc, auto row_of) {
#pragma unroll
    for (int i = 0; i < kJobs; ++i) {
      const int e = tid + kMmaThreads * i, n = e >> 5, pos = (e >> 1) & 15;
      const int k = kc * kChunk + 32 * (pos & 3) + 8 * (pos >> 2) + 4 * (e & 1);
      const long long row = row_of(n);
      qv[i] = row >= 0 && k < w
          ? __ldg(reinterpret_cast<const float4*>(q + row * w + k))
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto st_q = [&](uint8_t* d) {
#pragma unroll
    for (int i = 0; i < kJobs; ++i) {
      const int e = tid + kMmaThreads * i, n = e >> 5;
      *reinterpret_cast<uint2*>(d + n * kQPitch + 8 * (e & 31)) =
          make_uint2(mma::bf16x2(qv[i].x, qv[i].y), mma::bf16x2(qv[i].z, qv[i].w));
    }
  };

  // stage 0 (run 0 starts at slot 0) needs no run structure: its tile's
  // copy and its query's loads go out before the window's runs are known;
  // columns past run 0 hold the next slots' queries, computed and not stored
  if constexpr (EARLY) {
    issue(0, min(max(cells[w0], 0), n_cells - 1));
    cp_async_commit();
    ld(0, [&](int n) -> long long {
      if (n >= n_win) return -1;
      return (order ? order[w0 + n] : w0 + n) / nprobe;
    });
  }

  // the window's runs of equal cells (sorted cells: maximal runs)
  if (warp == 0) {
    int c = 0;
    if (lane < n_win) {
      c = min(max(cells[w0 + lane], 0), n_cells - 1);
      const long long pr = order ? order[w0 + lane] : w0 + lane;
      sm.cell[lane] = c;
      sm.pair[lane] = pr;
      sm.qrow[lane] = pr / nprobe;
    }
    const int prev = __shfl_up_sync(0xffffffffu, c, 1);
    const unsigned starts =
        __ballot_sync(0xffffffffu, lane < n_win && (lane == 0 || c != prev));
    if ((starts >> lane) & 1u) sm.run0[__popc(starts & ((1u << lane) - 1u))] = lane;
    if (lane == 0) {
      sm.nruns = __popc(starts);
      sm.run0[__popc(starts)] = n_win;
    }
  }
  if constexpr (EARLY) st_q(sm.qs[0]);
  __syncthreads();
  const int n_stage = sm.nruns * per_run;
  if constexpr (!EARLY) {
    const int r0 = sm.run0[1];
    issue(0, sm.cell[0]);
    cp_async_commit();
    ld(0, [&](int n) -> long long { return n < r0 ? sm.qrow[n] : -1; });
    st_q(sm.qs[0]);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bool vec = (cap & 3) == 0;

  // at stage st: its tile (issued at st - 1) and its query (stored at the
  // end of st - 1) are published by the barrier that opens it; then stage
  // st + 1's tile copy (and, EARLY, its query loads) go out, in flight
  // during st's products and output, and its query is stored into the
  // other slot (last read at st - 1) at the end
  for (int st = 0; st < n_stage; ++st) {
    const int u = st / per_run, rem = st % per_run;
    const int row0 = rem / nk * kTileRows, kc = rem % nk;
    const int p0 = sm.run0[u], r = sm.run0[u + 1] - p0;
    const int nt = (r + 7) >> 3;
    cp_async_wait<0>();
    __syncthreads();
    const bool next = st + 1 < n_stage;
    const int u1 = (st + 1) / per_run, p1 = sm.run0[min(u1, sm.nruns)];
    const int r1 = next ? sm.run0[u1 + 1] - p1 : 0;
    auto ld_next = [&]() {
      ld((st + 1) % per_run % nk,
         [&](int n) -> long long { return n < r1 ? sm.qrow[p1 + n] : -1; });
    };
    if (next) {
      issue(st + 1, sm.cell[p1]);
      if constexpr (EARLY) ld_next();
    }
    cp_async_commit();
    const bool live = row0 + 16 * warp < cap;
    if (live)
      warp_chunk_dots<NT>(sm.codes[st & 1] + 16 * warp * kChunkBytes,
                          sm.qs[st & 1], nt, acc);
    if (kc == nk - 1) {   // the tile's last chunk: C out through shared memory
      if (live) {
        const int g = lane >> 2, t = lane & 3, row = 16 * warp + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            float* c0 = sm.cs + (8 * j + 2 * t) * kCPitch + row;
            c0[0] = acc[j][0];
            c0[kCPitch] = acc[j][1];
            c0[8] = acc[j][2];
            c0[kCPitch + 8] = acc[j][3];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
      }
      __syncthreads();
      const int rows = min(kTileRows, cap - row0);
      if (vec) {
        const int nv = rows >> 2;
        for (int e = tid; e < r * nv; e += kMmaThreads) {
          const int n = e / nv, v = e - n * nv;
          __stcs(reinterpret_cast<float4*>(out + sm.pair[p0 + n] * cap + row0) + v,
                 *reinterpret_cast<const float4*>(sm.cs + n * kCPitch + 4 * v));
        }
      } else {
        for (int e = tid; e < r * rows; e += kMmaThreads) {
          const int n = e / rows, v = e - n * rows;
          __stcs(out + sm.pair[p0 + n] * cap + row0 + v, sm.cs[n * kCPitch + v]);
        }
      }
    }
    if (next) {
      if constexpr (!EARLY) ld_next();
      st_q(sm.qs[(st + 1) & 1]);
    }
  }
}

template <int NQ>
int launch_gather_mma(const void* codes, const void* cells, const void* order,
                      const void* q, int n_cells, int cap, int w, int nprobe,
                      int n_pairs, int window, void* out, void* stream) {
  static const int rc = evdb::mma::configure(gather_mma_kernel<NQ, NQ == 8>);
  if (rc) return rc;
  const int blocks = (n_pairs + window - 1) / window;
  gather_mma_kernel<NQ, NQ == 8><<<blocks, kMmaThreads, sizeof(MmaSmem<NQ>),
                          (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int*)cells, (const long long*)order,
      (const float*)q, n_cells, cap, w / 2, w, nprobe, n_pairs, window,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C interface

extern "C" {

// I8: ``codes`` [n_cells, cap, row_bytes] int8 (row_bytes = W, a multiple of
// 16, 16-byte aligned); ``probe`` [B, nprobe] int32 cell ids (clamped to the
// table); ``q`` [B, W] f32; ``out`` [B, nprobe, cap] f32.
int evdb_gather_dots(const void* codes, const void* probe, const void* q,
                     int n_cells, int cap, int row_bytes, int w, int B,
                     int nprobe, void* out, void* stream) {
  if (n_cells < 1 || cap < 1 || B < 1 || nprobe < 1 || row_bytes % 16 ||
      w != row_bytes)
    return (int)cudaErrorInvalidValue;
  int group = 1;
  while (group < 32 && group < row_bytes / 16) group *= 2;
  const long long blocks = (long long)B * nprobe;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // whole groups of eight 16-byte chunks: the swizzle permutes within them
  const size_t smem = (size_t)((w + 31) / 32) * 32 * sizeof(float);
  gather_dots_kernel<<<(unsigned)blocks, kProbeThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int*)probe, (const float*)q, n_cells, cap,
      row_bytes, w, nprobe, group, (float*)out);
  return (int)cudaGetLastError();
}

// I4: ``codes`` [n_cells, cap, W / 2] packed bytes (W a multiple of 32,
// 16-byte aligned); ``cells`` the n_pairs = B * nprobe probe ids, sorted
// where ``order`` (int64, their flat pairs b * nprobe + j) is given, else in
// pair order; ``q`` [B, W] f32, bf16-exact; ``out`` [B, nprobe, cap] f32.
int evdb_gather_dots_i4(const void* codes, const void* cells, const void* order,
                        const void* q, int n_cells, int cap, int w, int nprobe,
                        int n_pairs, int window, void* out, void* stream) {
  if (n_cells < 1 || cap < 1 || nprobe < 1 || n_pairs < 1 || w < 32 || w % 32 ||
      window < 1 || window > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  return window <= 8
      ? launch_gather_mma<8>(codes, cells, order, q, n_cells, cap, w, nprobe,
                             n_pairs, window, out, stream)
      : launch_gather_mma<32>(codes, cells, order, q, n_cells, cap, w, nprobe,
                              n_pairs, window, out, stream);
}

}  // extern "C"
