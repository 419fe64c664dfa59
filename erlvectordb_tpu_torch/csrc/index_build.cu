// The cell-probe index build's two row passes on the card (sm_90a).  They
// replace no TPU kernel: the JAX package seeds k-means++ with whole-array
// passes and encodes the residuals in numpy on the host.  They exist so
// that the port's build (core/cell_probe.py::CellProbeIndex.build) keeps
// its rows on the card.
//
//   kpp_update     one k-means++ distance update (ops/kmeans.py::
//                  _kpp_init): mind2[r] = min(mind2[r], |x_r - c_i|^2) and
//                  owner[r] = i where the new seed is nearer, for the rows
//                  the new seed can reach (every row for the first seed);
//   pairwise_norms the reconstruction norms of the encode (ops/
//                  index_build.py::encode_cells): sqrt of the squares summed
//                  in numpy's pairwise order, as np.linalg.norm(recon,
//                  axis=1) sums them.
//
// kpp_update.  A whole-sample draw reads every row of the sample (614 MB at
// 200,000 x 768, and 10,416 draws at the index cell's shape).  Each row
// keeps the seed that set its distance (owner); by the triangle inequality
// a row is out of the new seed's reach when |c_owner - c_i|^2 >= 4 (mind2 +
// eta) (1 + 2 delta), delta = (d + 4) 2^-24 bounding the relative rounding
// of both f32 sums in any order and eta their underflow, so its computed
// distance could not be below mind2.  A warp tests 32 rows (8 bytes each
// and one cached seed distance) and reads only the rows it keeps: the pass
// is bound by the bytes of the rows it reads, 3 KB a kept row.  The seed
// distances |c_j - c_i|^2 (j < i) are one warp a seed, in float64.  A kept
// row's distance is summed in one fixed order, which ops/index_build.py::
// row_d2 writes in plain PyTorch: each difference and square rounded (built
// with -fmad=false); element e into accumulator e % 128 in order of e (lane
// e / 4 % 32, its accumulator e % 4); a lane's four accumulators added in
// turn; then a shuffle-down tree over the 32 lanes with offsets halving.
// The order depends on the width alone, not on the rows' alignment (float4
// loads where rows start on 16 bytes, scalar loads otherwise).
//
// pairwise_norms.  One thread a row evaluates numpy's pairwise sum (blocks
// of up to 128 in 8 accumulators, halved at multiples of 8, over 8,192-value
// chunks added in turn) from a postfix program the wrapper derives from d:
// its leaves and their sums.  Up to 12,287 columns a block first stages the
// squares of up to 32 rows in shared memory (row pitch d + 1, so the threads
// that then walk one row each hit distinct banks); wider rows are read from
// global memory and squared there.  Bound by the bytes of recon it reads (4
// d a row).
//
// The entry points launch on the given stream, allocate nothing, and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStack = 32;            // pairwise program's stack depth
constexpr int kSmemFloats = 12288;    // 48 KB of staged squares a block

__device__ __forceinline__ float sq(float a, float b) {
  const float t = a - b;
  return t * t;
}

// lane 0's sum of (x - c)^2 over one row in row_d2's order
template <bool V4>
__device__ float row_d2(const float* __restrict__ xr,
                        const float* __restrict__ c, int d, int lane) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int e = lane * 4; e < d; e += 128) {
    if (V4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + e);
      const float4 cv = *reinterpret_cast<const float4*>(c + e);
      a0 = a0 + sq(xv.x, cv.x);
      a1 = a1 + sq(xv.y, cv.y);
      a2 = a2 + sq(xv.z, cv.z);
      a3 = a3 + sq(xv.w, cv.w);
    } else {
      a0 = a0 + sq(xr[e], c[e]);
      if (e + 1 < d) a1 = a1 + sq(xr[e + 1], c[e + 1]);
      if (e + 2 < d) a2 = a2 + sq(xr[e + 2], c[e + 2]);
      if (e + 3 < d) a3 = a3 + sq(xr[e + 3], c[e + 3]);
    }
  }
  float v = ((a0 + a1) + a2) + a3;
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// sd2[j] = |c_j - c_i|^2 in float64 for the seeds j < i: one warp a seed
__global__ void kpp_seed_d2_kernel(const float* __restrict__ cents, int i,
                                   int d, double* __restrict__ sd2) {
  const int lane = threadIdx.x & 31;
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (j >= i) return;   // whole warps
  const float* a = cents + (size_t)j * d;
  const float* c = cents + (size_t)i * d;
  double acc = 0.0;
  for (int e = lane; e < d; e += 32) {
    const double t = (double)a[e] - (double)c[e];
    acc += t * t;
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) sd2[j] = acc;
}

// one warp a group of 32 rows: the reach test a lane a row, then the kept
// rows one after another by the whole warp; i == 0 keeps every row
template <bool V4>
__global__ void kpp_update_kernel(const float* __restrict__ x,
                                  const float* __restrict__ cents, int n,
                                  int d, int i,
                                  const double* __restrict__ sd2, double grow,
                                  double eta, float* __restrict__ mind2,
                                  int* __restrict__ owner,
                                  unsigned long long* __restrict__ scanned) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float* c = cents + (size_t)i * d;
  unsigned long long kept = 0;
  for (long long base = warp * 32; base < n; base += warps * 32) {
    const long long r = base + lane;
    float m = 0.f;
    bool live = false;
    if (r < n) {
      m = mind2[r];
      live = i == 0 || !(sd2[owner[r]] >= 4.0 * ((double)m + eta) * grow);
    }
    unsigned todo = __ballot_sync(0xffffffffu, live);
    kept += __popc(todo);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long rr = base + j;
      const float s = row_d2<V4>(x + rr * d, c, d, lane);
      const float mj = __shfl_sync(0xffffffffu, m, j);
      // torch.minimum: the smaller, NaN wins
      if (lane == 0 && (s < mj || s != s)) {
        mind2[rr] = s;
        owner[rr] = i;
      }
    }
  }
  if (lane == 0 && kept) atomicAdd(scanned, kept);
}

// a leaf of numpy's pairwise sum over a[0 .. len): of a's values, or with
// SQUARE of their squares
template <bool SQUARE>
__device__ __forceinline__ float leaf_at(const float* a, int k) {
  const float v = a[k];
  return SQUARE ? v * v : v;
}

template <bool SQUARE>
__device__ float pairwise_leaf(const float* a, int len) {
  if (len < 8) {
    float r = -0.0f;
    for (int k = 0; k < len; ++k) r = r + leaf_at<SQUARE>(a, k);
    return r;
  }
  float r0 = leaf_at<SQUARE>(a, 0), r1 = leaf_at<SQUARE>(a, 1);
  float r2 = leaf_at<SQUARE>(a, 2), r3 = leaf_at<SQUARE>(a, 3);
  float r4 = leaf_at<SQUARE>(a, 4), r5 = leaf_at<SQUARE>(a, 5);
  float r6 = leaf_at<SQUARE>(a, 6), r7 = leaf_at<SQUARE>(a, 7);
  int k = 8;
  for (; k < len - len % 8; k += 8) {
    r0 = r0 + leaf_at<SQUARE>(a, k);     r1 = r1 + leaf_at<SQUARE>(a, k + 1);
    r2 = r2 + leaf_at<SQUARE>(a, k + 2); r3 = r3 + leaf_at<SQUARE>(a, k + 3);
    r4 = r4 + leaf_at<SQUARE>(a, k + 4); r5 = r5 + leaf_at<SQUARE>(a, k + 5);
    r6 = r6 + leaf_at<SQUARE>(a, k + 6); r7 = r7 + leaf_at<SQUARE>(a, k + 7);
  }
  float res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
  for (; k < len; ++k) res = res + leaf_at<SQUARE>(a, k);
  return res;
}

// prog: [len, 2] int32; (start, count) pushes a leaf's sum, (-1, 0) adds
// the two sums on top.  STAGED: ``rows`` rows a block staged as squares in
// shared memory; else one row a thread read from recon.
template <bool STAGED>
__global__ void pairwise_norms_kernel(const float* __restrict__ recon, int m,
                                      int d, const int* __restrict__ prog,
                                      int prog_len, int rows,
                                      float* __restrict__ out) {
  extern __shared__ float staged[];
  const long long row0 = (long long)blockIdx.x * rows;
  const int here = (int)min((long long)rows, m - row0);
  const float* a;
  if (STAGED) {
    const int pitch = d + 1;
    for (int e = threadIdx.x; e < here * d; e += blockDim.x) {
      const int r = e / d, k = e - r * d;
      const float v = recon[(row0 + r) * d + k];
      staged[r * pitch + k] = v * v;
    }
    __syncthreads();
    a = staged + threadIdx.x * pitch;
  } else {
    a = recon + (row0 + threadIdx.x) * d;
  }
  if (threadIdx.x >= here) return;
  float stack[kStack];
  int top = 0;
  for (int p = 0; p < prog_len; ++p) {
    const int start = prog[2 * p], count = prog[2 * p + 1];
    if (start >= 0) {
      stack[top++] = pairwise_leaf<!STAGED>(a + start, count);
    } else {
      const float b = stack[--top];
      stack[top - 1] = stack[top - 1] + b;
    }
  }
  // the reduction's identity, then numpy's float32 square root
  out[row0 + threadIdx.x] = sqrtf(0.0f + stack[0]);
}

}  // namespace

// ---------------------------------------------------------------- C interface
// evdb_kpp_update: x [n, d] f32 contiguous, cents [k, d] f32 contiguous with
// row i the new seed, sd2 [k] f64 scratch, mind2 [n] f32 and owner [n]
// int32 updated in place, scanned one uint64 the kept rows are added to.
// evdb_pairwise_norms: recon [m, d] f32 contiguous, prog [prog_len, 2]
// int32 (ops/index_build.py::pairwise_program), ``rows`` a block with rows
// (d + 1) floats of shared memory each, or 0 to read the rows unstaged,
// out [m] f32.

extern "C" {

int evdb_kpp_update(const void* x, const void* cents, int n, int d, int i,
                    double grow, double eta, void* sd2, void* mind2,
                    void* owner, void* scanned, void* stream) {
  if (n < 1 || d < 1 || i < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (i > 0) {
    const int seed_blocks = (int)(((long long)i * 32 + kThreads - 1) / kThreads);
    kpp_seed_d2_kernel<<<seed_blocks, kThreads, 0, st>>>(
        (const float*)cents, i, d, (double*)sd2);
  }
  const int blocks = (int)(((long long)n + kThreads - 1) / kThreads);
  const bool v4 = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)cents % 16 == 0;
  auto kern = v4 ? kpp_update_kernel<true> : kpp_update_kernel<false>;
  kern<<<blocks, kThreads, 0, st>>>(
      (const float*)x, (const float*)cents, n, d, i, (const double*)sd2, grow,
      eta, (float*)mind2, (int*)owner, (unsigned long long*)scanned);
  return (int)cudaGetLastError();
}

int evdb_pairwise_norms(const void* recon, int m, int d, const void* prog,
                        int prog_len, int rows, void* out, void* stream) {
  if (m < 1 || d < 1 || rows < 0 || rows > kThreads ||
      rows * (long long)(d + 1) > kSmemFloats || prog_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows > 0) {
    pairwise_norms_kernel<true><<<(m + rows - 1) / rows, kThreads,
                                  rows * (d + 1) * sizeof(float), st>>>(
        (const float*)recon, m, d, (const int*)prog, prog_len, rows,
        (float*)out);
  } else {
    constexpr int kRowThreads = 128;
    pairwise_norms_kernel<false><<<(m + kRowThreads - 1) / kRowThreads,
                                   kRowThreads, 0, st>>>(
        (const float*)recon, m, d, (const int*)prog, prog_len, kRowThreads,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
