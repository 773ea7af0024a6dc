// K2 rls_scores: l_i = sum_j (B M)_ij B_ij for row-major B (n, p) and the
// p x p inverse M = (B^T B + n lam I)^{-1} (paper eq. 9, step 5).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rls_scores.py::rls_scores_fused (body _rls_kernel).
//
// Bound on an H100 SXM: 2*n*p^2 operations against 4*(n*p + p*p + n) bytes
// (float32). At the main path's shape (n = 463,715, p = 2048) that is
// 3.89e12 operations, 58 ms at the 67 TFLOP/s float32 rate of the CUDA
// cores, against 3.8 GB, 1.1 ms at 3.35 TB/s: bound by operations.
//
// Design against that bound: the Pallas kernel kept all of M in VMEM; at
// p = 2048 in float32 M is 16 MB, far above the 227 KB of shared memory a
// block can use. So each block owns a 128-row tile of B (64 in float64)
// and walks M in 128-column blocks j; for each j it forms
// T_j = B_rows * M[:, j] from 16-deep k-slabs of B and M staged in shared
// memory, then folds rowsum(T_j * B_rows[:, j]) into per-thread row
// partials. T is never written to device memory (one read of B per
// column block, served mostly from L2; M stays in L2), each block reduces
// over all j itself, so there is no cross-block reduction and no atomics,
// and one score per row is written at the end.
#include "tile.cuh"

using namespace repro_tile;

namespace {

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
rls_scores_kernel(const T* __restrict__ B, const Acc* __restrict__ M,
                  T* __restrict__ out, int n, int p) {
  constexpr int BM = Tile<Acc>::BM, BN = Tile<Acc>::BN, BK = Tile<Acc>::BK;
  constexpr int TM = BM / TY, TN = BN / TX;
  __shared__ __align__(16) Acc Bs[BK][BM + PAD];
  __shared__ __align__(16) Acc Ms[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t row0 = (int64_t)blockIdx.x * BM;

  Acc part[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) part[i] = Acc(0);

  for (int j0 = 0; j0 < p; j0 += BN) {
    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

    for (int k0 = 0; k0 < p; k0 += BK) {
      stage_rows<T, Acc, BM, BK>(Bs, B, row0, n, k0, p, p);
      // M[k0 + c, j0 + j] -> Ms[c][j]: rows of M are contiguous in j
      for (int e = tid; e < BK * BN; e += NT) {
        const int c = e / BN, j = e % BN;
        const int gk = k0 + c, gj = j0 + j;
        Ms[c][j] = (gk < p && gj < p) ? M[(int64_t)gk * p + gj] : Acc(0);
      }
      __syncthreads();
      tile_fma<Acc, BM, BN, BK>(Bs, Ms, acc);
      __syncthreads();
    }
    // fold T_j ⊙ B[rows, j-block] into the row partials
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t r = row0 + ty * TM + i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gj = j0 + tx + j * TX;
        if (gj < p) part[i] = fma_(acc[i][j], Acc(B[r * p + gj]), part[i]);
      }
    }
  }

  // the 16 threads sharing a row set (one half-warp, same ty) hold the
  // column partials of those rows: reduce them with shuffles
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    Acc v = part[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int64_t r = row0 + ty * TM + i;
    if (tx == 0 && r < n) out[r] = T(v);
  }
}

template <typename T, typename Acc>
int launch(const void* B, const void* M, void* out, int n, int p,
           cudaStream_t stream) {
  constexpr int BM = Tile<Acc>::BM;
  const int64_t row_tiles = (n + BM - 1) / BM;
  rls_scores_kernel<T, Acc><<<(unsigned)row_tiles, NT, 0, stream>>>(
      static_cast<const T*>(B), static_cast<const Acc*>(M),
      static_cast<T*>(out), n, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of B and the scores) / acc (of M and the arithmetic):
// 0 = float32, 1 = float64. Returns cudaGetLastError() after the launch.
extern "C" int rls_scores_launch(const void* B, const void* M, void* out,
                                 int n, int p, int dtype, int acc, int device,
                                 void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && acc == 0) return launch<float, float>(B, M, out, n, p, s);
  if (dtype == 0 && acc == 1) return launch<float, double>(B, M, out, n, p, s);
  if (dtype == 1 && acc == 0) return launch<double, float>(B, M, out, n, p, s);
  if (dtype == 1 && acc == 1)
    return launch<double, double>(B, M, out, n, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rls_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
