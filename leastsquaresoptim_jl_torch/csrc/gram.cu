// Gram matrix and right-hand side (J'J, J'y) of a dense 2-D J in one pass.
//
// Replaces leastsquaresoptim_jl_tpu/ops/gram.py::_xtx_pallas (the Pallas
// row-block X'X kernel) and the work its wrapper _gram_pallas adds around
// it: the row tail and the separate J'y gemv. It computes what they compute,
// not their block structure. The TPU kernel folds n in {32, 64} into 128
// lanes and leaves J'y to XLA for TPU layout reasons; here neither applies,
// so every row of J is read once and J'y comes from the same staged tiles.
//
// What bounds it on Hopper. At m >> n the least traffic is one read of J:
// at (2^20, 256) in float32 that is 1 GiB, so >= 0.32 ms at 3.35 TB/s. The
// arithmetic is 2 m n^2 FLOPs for the full product (0.137 TFLOP there,
// 17.2 GFLOP at config #3's (8192, 1024)); computing only the tiles on or
// above the diagonal halves it, to about m n (n + 64) here. This kernel
// uses the float32 FMA pipes, not the tensor cores (67 TFLOP/s peak on an
// H100 SXM at 700 W), so above n ~ 64 it is bound by FMAs and by the
// shared-memory reads that feed them, not by the read of J. wgmma/TMA is
// later work.
//
// Design: the (n, n) output is cut into TN x TN tiles (TN = 64, or 32 when
// n = 32); one block computes one tile on or above the diagonal over one
// chunk of rows, so blockIdx.x walks the upper tiles and blockIdx.y the row
// chunks (the split over rows fills the 132 SMs even at n = 32 and 64, where
// there is a single tile). The block stages BK = 32 rows of the tile's two
// column panels (one panel on the diagonal) and of y in shared memory, as
// float32, and its 256 threads each hold a (TN/16) x (TN/16) register tile
// of float32 sums, its entries 16 rows and 16 columns apart. Diagonal
// blocks also sum J'y for their columns from the same staged rows. Each
// block writes its tile and the tile's mirror into
// its chunk's slice of a float32 scratch (chunks, n, n) that the caller
// allocates (and its part of a (chunks, n) scratch for J'y); the caller
// sums over the chunk axis, as the JAX package sums its partials in XLA.
// There are no atomics: the result is the same from run to run.
//
// The library is built with -fmad=false, so the multiply-adds are written
// as explicit fmaf. Rows past m are loaded as zeros. The input is float32
// or bfloat16; accumulation is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBK = 32;        // rows of J staged per step
constexpr int kThreads = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Upper-triangle tile t (row-major over ti <= tj) of an nt x nt tile grid.
__device__ __forceinline__ void tile_of(int t, int nt, int* ti, int* tj) {
  int i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// acc[a][b] += sum_k A[k][ty + 16 a] * B[k][tx + 16 b] over one staged
// step. Output (i, j) of a thread sits 16 apart, so a warp's reads of B hit
// 16 consecutive floats and its reads of A two broadcast addresses: no bank
// conflicts. Inlined, so A and B stay shared-memory references.
template <int PT, int LD>
__device__ __forceinline__ void tile_step(const float (&A)[kBK][LD],
                                          const float (&B)[kBK][LD],
                                          float (&acc)[PT][PT], int tx,
                                          int ty) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    float av[PT], bv[PT];
#pragma unroll
    for (int a = 0; a < PT; ++a) av[a] = A[k][ty + 16 * a];
#pragma unroll
    for (int b = 0; b < PT; ++b) bv[b] = B[k][tx + 16 * b];
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
      for (int b = 0; b < PT; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const T* __restrict__ J, const T* __restrict__ y, int64_t m,
                int n, int64_t rows_per_chunk, float* __restrict__ gp,
                float* __restrict__ bp) {
  constexpr int PT = TN / 16;   // outputs per thread along each side
  constexpr int LD = TN + 4;    // padded row of a staged panel
  __shared__ float As[kBK][LD];
  __shared__ float Bs[kBK][LD];
  __shared__ float ys[kBK];

  const int nt = n / TN;
  int ti, tj;
  tile_of(blockIdx.x, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int col_a = ti * TN;
  const int col_b = tj * TN;
  const int64_t chunk = blockIdx.y;
  const int64_t row0 = chunk * rows_per_chunk;
  int64_t row1 = row0 + rows_per_chunk;
  if (row1 > m) row1 = m;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[PT][PT];
#pragma unroll
  for (int a = 0; a < PT; ++a)
#pragma unroll
    for (int b = 0; b < PT; ++b) acc[a][b] = 0.0f;
  float bacc = 0.0f;

  for (int64_t r0 = row0; r0 < row1; r0 += kBK) {
    // Stage BK rows of both column panels (one on the diagonal);
    // neighbouring threads read neighbouring columns of one row of J.
    for (int e = tid; e < kBK * TN; e += kThreads) {
      const int r = e / TN;
      const int c = e % TN;
      const int64_t row = r0 + r;
      float va = 0.0f, vb = 0.0f;
      if (row < row1) {
        const T* jr = J + row * n;
        va = to_f32(jr[col_a + c]);
        if (!diag) vb = to_f32(jr[col_b + c]);
      }
      As[r][c] = va;
      if (!diag) Bs[r][c] = vb;
    }
    if (diag && tid < kBK) {
      const int64_t row = r0 + tid;
      ys[tid] = row < row1 ? to_f32(y[row]) : 0.0f;
    }
    __syncthreads();

    if (diag) {
      tile_step<PT, LD>(As, As, acc, tx, ty);
      if (tid < TN) {
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) bacc = fmaf(As[k][tid], ys[k], bacc);
      }
    } else {
      tile_step<PT, LD>(As, Bs, acc, tx, ty);
    }
    __syncthreads();
  }

  float* g = gp + chunk * static_cast<int64_t>(n) * n;
#pragma unroll
  for (int a = 0; a < PT; ++a) {
    const int i = col_a + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < PT; ++b) {
      const int j = col_b + tx + 16 * b;
      g[static_cast<int64_t>(i) * n + j] = acc[a][b];
      if (!diag) g[static_cast<int64_t>(j) * n + i] = acc[a][b];
    }
  }
  if (diag && tid < TN) bp[chunk * n + col_a + tid] = bacc;
}

template <typename T>
int launch(const void* J, const void* y, int64_t m, int n,
           int64_t rows_per_chunk, int chunks, void* gp, void* bp,
           void* stream) {
  const T* jp = static_cast<const T*>(J);
  const T* yp = static_cast<const T*>(y);
  float* g = static_cast<float*>(gp);
  float* b = static_cast<float*>(bp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 32) {
    dim3 grid(1, chunks);
    gram_kernel<T, 32><<<grid, kThreads, 0, s>>>(jp, yp, m, n, rows_per_chunk,
                                                 g, b);
  } else if (n % 64 == 0) {
    const int nt = n / 64;
    dim3 grid(nt * (nt + 1) / 2, chunks);
    gram_kernel<T, 64><<<grid, kThreads, 0, s>>>(jp, yp, m, n, rows_per_chunk,
                                                 g, b);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). gp is a float32 (chunks, n, n)
// scratch and bp a float32 (chunks, n) scratch; chunk c covers rows
// [c * rows_per_chunk, (c + 1) * rows_per_chunk) of J. Each returns
// cudaGetLastError() right after the launch: 0 means it was enqueued.
extern "C" int lso_gram_f32(const void* J, const void* y, int64_t m, int n,
                            int64_t rows_per_chunk, int chunks, void* gp,
                            void* bp, void* stream) {
  return launch<float>(J, y, m, n, rows_per_chunk, chunks, gp, bp, stream);
}

extern "C" int lso_gram_bf16(const void* J, const void* y, int64_t m, int n,
                             int64_t rows_per_chunk, int chunks, void* gp,
                             void* bp, void* stream) {
  return launch<__nv_bfloat16>(J, y, m, n, rows_per_chunk, chunks, gp, bp,
                               stream);
}
