// K1 kernel_block: C = k(X, Z) in R^{n x p} for row-major X (n, d), Z (p, d).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf_block.py::kernel_block
// (bodies _rbf_block_kernel, _linear_block_kernel, _poly_block_kernel over
// _cross_tile). Kinds: 0 rbf   exp(-max(|x|^2 + |z|^2 - 2 x.z, 0) / 2h^2)
//                      1 linear x.z
//                      2 poly   (x.z / scale + offset)^degree
//
// Bound on an H100 SXM: 2*n*p*d operations for the cross term and
// 4*(n*d + p*d + n*p) bytes (float32). At the main path's shape
// (n = 463,715, p = 2048, d = 90) that is 1.71e11 operations, 2.6 ms at the
// 67 TFLOP/s float32 rate of the CUDA cores (IEEE float32 cannot use the
// tensor cores), against 3.8 GB of output, 1.1 ms at 3.35 TB/s: bound by
// operations, with the output write close behind.
//
// Design against that bound: the Pallas tile held all of d in VMEM; here
// each block owns a 128 x 128 output tile (64 x 64 in float64) and loops
// over d in 16-deep slabs staged through shared memory, so the register
// tile stays small at any d. The squared norms |x|^2 and |z|^2 are
// accumulated from the same staged slabs (no separate norm pass), the
// ragged n, p and d edges are masked in the loads and stores (no padding
// copies), and the epilogue is fused, so C is written once and never read
// back. One-dimensional grid with the column tiles fastest: consecutive
// blocks share an X row tile, which then comes from L2.
#include "tile.cuh"

using namespace repro_tile;

namespace {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
kernel_block_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                    T* __restrict__ out, int n, int p, int d, int kind,
                    Acc two_h2, Acc scale, Acc offset, int degree,
                    int col_tiles) {
  constexpr int BM = Tile<Acc>::BM, BN = Tile<Acc>::BN, BK = Tile<Acc>::BK;
  constexpr int TM = BM / TY, TN = BN / TX;
  static_assert(BM + BN <= NT, "one norm per thread");
  __shared__ __align__(16) Acc Xs[BK][BM + PAD];
  __shared__ __align__(16) Acc Zs[BK][BN + PAD];
  __shared__ Acc xx[BM], zz[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * BM;
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
  Acc sq = Acc(0);  // thread t < BM: |x_t|^2; BM <= t < BM + BN: |z_t|^2

  for (int k0 = 0; k0 < d; k0 += BK) {
    stage_rows<T, Acc, BM, BK>(Xs, X, row0, n, k0, d, d);
    stage_rows<T, Acc, BN, BK>(Zs, Z, col0, p, k0, d, d);
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int c = 0; c < BK; ++c) sq = fma_(Xs[c][tid], Xs[c][tid], sq);
    } else if (tid < BM + BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c)
        sq = fma_(Zs[c][tid - BM], Zs[c][tid - BM], sq);
    }
    tile_fma<Acc, BM, BN, BK>(Xs, Zs, acc);
    __syncthreads();
  }
  if (tid < BM) {
    xx[tid] = sq;
  } else if (tid < BM + BN) {
    zz[tid - BM] = sq;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = col0 + tx + j * TX;
      if (c >= p) continue;
      Acc v = acc[i][j];
      if (kind == 0) {
        Acc d2 = xx[ty * TM + i] + zz[tx + j * TX] - Acc(2) * v;
        d2 = d2 > Acc(0) ? d2 : Acc(0);
        v = exp_(-d2 / two_h2);
      } else if (kind == 2) {
        const Acc base = v / scale + offset;
        Acc pw = Acc(1);
        for (int q = 0; q < degree; ++q) pw *= base;
        v = pw;
      }
      out[r * p + c] = T(v);
    }
  }
}

template <typename T, typename Acc>
int launch(const void* X, const void* Z, void* out, int n, int p, int d,
           int kind, double two_h2, double scale, double offset, int degree,
           cudaStream_t stream) {
  constexpr int BM = Tile<Acc>::BM, BN = Tile<Acc>::BN;
  const int64_t row_tiles = (n + BM - 1) / BM;
  const int64_t col_tiles = (p + BN - 1) / BN;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel_block_kernel<T, Acc><<<(unsigned)(row_tiles * col_tiles), NT, 0,
                                stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Z),
      static_cast<T*>(out), n, p, d, kind, Acc(two_h2), Acc(scale),
      Acc(offset), degree, (int)col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype / acc: 0 = float32, 1 = float64. Returns cudaGetLastError() after
// the launch (0 on success); the kernel runs on `stream` of device `device`.
extern "C" int kernel_block_launch(const void* X, const void* Z, void* out,
                                   int n, int p, int d, int dtype, int acc,
                                   int kind, double two_h2, double scale,
                                   double offset, int degree, int device,
                                   void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n <= 0 || p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && acc == 0)
    return launch<float, float>(X, Z, out, n, p, d, kind, two_h2, scale,
                                offset, degree, s);
  if (dtype == 0 && acc == 1)
    return launch<float, double>(X, Z, out, n, p, d, kind, two_h2, scale,
                                 offset, degree, s);
  if (dtype == 1 && acc == 0)
    return launch<double, float>(X, Z, out, n, p, d, kind, two_h2, scale,
                                 offset, degree, s);
  if (dtype == 1 && acc == 1)
    return launch<double, double>(X, Z, out, n, p, d, kind, two_h2, scale,
                                  offset, degree, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
