// K3 sparse_cross: k(X_csr, Z) in R^{n_rows x p} for a CSR row block X
// (data, indices, indptr) and a dense landmark block Z (p, d).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_block.py::
// _sparse_cross_pallas (body _pallas_tile_body; entry points sparse_cross
// and sparse_kernel_block, whose rbf/poly epilogue and row norms were XLA
// code around it). Kinds: 0 rbf    exp(-max(|x|^2 + |z|^2 - 2 x.z, 0) / 2h^2)
//                         1 linear x.z
//                         2 poly   (x.z / scale + offset)^degree
//
// Bound on an H100 SXM: 2*nnz*p + 5*n_rows*p operations; bytes = the
// stored values and their column ids, one read of Z^T and the output. At one
// chunk of the RCV1-shaped cell (131,072 rows, about 9.7 M stored values,
// p = 2048, d = 47,236, float32) that is 4.1e10 operations, 0.61 ms at the
// 67 TFLOP/s float32 rate of the CUDA cores, against 1.5 GB, 0.46 ms at
// 3.35 TB/s: bound by operations, with the output write close behind.
//
// The TPU body was two one-hot MXU matmuls over an output block holding
// every row; Hopper has no use for that. Here the design is a CSR x dense
// SpMM:
//  * Z^T is one (d, ld) copy (the wrapper makes it; ld is p padded to whole
//    slabs with zeros), so the landmark values of one feature column are a
//    contiguous row;
//  * a block owns WARPS rows, one warp each, and one slab of SLAB landmark
//    columns (1 KB: 256 float32 or 128 float64); the grid walks the rows
//    fastest, so the blocks in flight share one slab of Z^T in L2;
//  * a warp loads 32 (column, value) pairs of its row at once, coalesced,
//    broadcasts them one by one with shuffles, reads the slab row
//    Z^T[col, slab] with two 16-byte loads per lane and fma's into
//    per-lane accumulators;
//  * |x|^2 comes from the same values (a warp reduction at the end), |z|^2
//    from a short norm kernel over Z; the epilogue is fused into the one
//    store per output element, so the block is never read back.
// No atomics: every output element sums its row's values in CSR order, so
// a row's result does not depend on the other rows of its chunk (chunked
// and in-memory sparse fits agree exactly). Empty rows give k(0, z). Slots
// at or past indptr[n_rows] (padding) are never read. Float32 arithmetic is
// IEEE fma, never TF32. Not yet done: rows of very different lengths leave
// the warps of a block idle until its longest row ends.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int WARPS = 8;             // rows per block
constexpr int SLAB_BYTES = 1024;     // one slab row of Z^T
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// 16 bytes of T per lane per load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<double> { static constexpr int N = 2; };

__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load16(const double* __restrict__ p,
                                       double (&v)[2]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = x.x; v[1] = x.y;
}

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc s) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// zz[j] = |z_j|^2 for the rows of Z (p, d), one warp per row.
template <typename T, typename Acc>
__global__ void __launch_bounds__(WARPS * LANES)
row_sqnorm_kernel(const T* __restrict__ Z, int p, int d,
                  Acc* __restrict__ zz) {
  const int lane = threadIdx.x % LANES;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / LANES;
  if (row >= p) return;
  const T* z = Z + row * d;
  Acc s = Acc(0);
  for (int k = lane; k < d; k += LANES) {
    const Acc v = Acc(z[k]);
    s = fma_(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) zz[row] = s;
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(WARPS * LANES)
sparse_cross_kernel(const T* __restrict__ data,
                    const int* __restrict__ indices,
                    const int* __restrict__ indptr, const T* __restrict__ Zt,
                    const Acc* __restrict__ zz, T* __restrict__ out,
                    int n_rows, int p, int ld, int kind, Acc two_h2,
                    Acc scale, Acc offset, int degree) {
  constexpr int E = Vec<T>::N;                  // values per 16-byte load
  constexpr int SLAB = SLAB_BYTES / sizeof(T);  // landmark columns per block
  constexpr int R = SLAB / (LANES * E);         // loads per lane per value
  const int lane = threadIdx.x % LANES;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / LANES;
  if (row >= n_rows) return;                    // the whole warp leaves
  const int c0 = blockIdx.y * SLAB + lane * E;  // this lane's first column
  const int lo = indptr[row], hi = indptr[row + 1];

  Acc acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = Acc(0);
  Acc sq = Acc(0);

  for (int base = lo; base < hi; base += LANES) {
    const int k = base + lane;
    int col = 0;
    Acc v = Acc(0);
    if (k < hi) {
      col = __ldg(indices + k);
      v = Acc(__ldg(data + k));
      sq = fma_(v, v, sq);
    }
    const int cnt = min(LANES, hi - base);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int cj = __shfl_sync(FULL, col, j);
      const Acc vj = __shfl_sync(FULL, v, j);
      const T* zrow = Zt + (int64_t)cj * ld + c0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T z[E];
        load16(zrow + r * LANES * E, z);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fma_(vj, Acc(z[e]), acc[r][e]);
      }
    }
  }
  sq = warp_sum(sq);

  T* orow = out + row * p;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = c0 + r * LANES * E + e;
      if (c >= p) continue;
      Acc val = acc[r][e];
      if (kind == 0) {
        Acc d2 = sq + zz[c] - Acc(2) * val;
        d2 = d2 > Acc(0) ? d2 : Acc(0);
        val = exp_(-d2 / two_h2);
      } else if (kind == 2) {
        const Acc b = val / scale + offset;
        Acc pw = Acc(1);
        for (int q = 0; q < degree; ++q) pw *= b;
        val = pw;
      }
      orow[c] = T(val);
    }
  }
}

template <typename T, typename Acc>
int launch(const void* data, const void* indices, const void* indptr,
           const void* Z, const void* Zt, void* zz, void* out, int n_rows,
           int p, int d, int ld, int kind, double two_h2, double scale,
           double offset, int degree, cudaStream_t stream) {
  constexpr int SLAB = SLAB_BYTES / sizeof(T);
  if (ld % SLAB != 0 || ld < p) return (int)cudaErrorInvalidValue;
  const int64_t row_blocks = ((int64_t)n_rows + WARPS - 1) / WARPS;
  const int64_t slabs = ld / SLAB;
  if (row_blocks > 2147483647LL || slabs > 65535)
    return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    row_sqnorm_kernel<T, Acc><<<(unsigned)((p + WARPS - 1) / WARPS),
                                WARPS * LANES, 0, stream>>>(
        static_cast<const T*>(Z), p, d, static_cast<Acc*>(zz));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)row_blocks, (unsigned)slabs);
  sparse_cross_kernel<T, Acc><<<grid, WARPS * LANES, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(indices),
      static_cast<const int*>(indptr), static_cast<const T*>(Zt),
      static_cast<const Acc*>(zz), static_cast<T*>(out), n_rows, p, ld,
      kind, Acc(two_h2), Acc(scale), Acc(offset), degree);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype / acc: 0 = float32, 1 = float64. Zt is the (d, ld) copy of Z^T
// (ld a whole number of slabs, zero past p); zz is scratch for p values of
// the accumulation type (written and read only for kind 0). Returns
// cudaGetLastError() after the launches (0 on success); the kernels run on
// `stream` of device `device`.
extern "C" int sparse_cross_launch(const void* data, const void* indices,
                                   const void* indptr, const void* Z,
                                   const void* Zt, void* zz, void* out,
                                   int n_rows, int p, int d, int ld,
                                   int dtype, int acc, int kind,
                                   double two_h2, double scale, double offset,
                                   int degree, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_rows <= 0 || p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && acc == 0)
    return launch<float, float>(data, indices, indptr, Z, Zt, zz, out, n_rows,
                                p, d, ld, kind, two_h2, scale, offset, degree,
                                s);
  if (dtype == 0 && acc == 1)
    return launch<float, double>(data, indices, indptr, Z, Zt, zz, out,
                                 n_rows, p, d, ld, kind, two_h2, scale, offset,
                                 degree, s);
  if (dtype == 1 && acc == 0)
    return launch<double, float>(data, indices, indptr, Z, Zt, zz, out,
                                 n_rows, p, d, ld, kind, two_h2, scale, offset,
                                 degree, s);
  if (dtype == 1 && acc == 1)
    return launch<double, double>(data, indices, indptr, Z, Zt, zz, out,
                                  n_rows, p, d, ld, kind, two_h2, scale,
                                  offset, degree, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sparse_cross_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
