// Shared pieces of the port's KRR kernels (kernel_block.cu, rls_scores.cu,
// sparse_cross.cu).
//
// widen / narrow / is_zero: the storage types (float, double, bf16) against
// the accumulation types (float, double). A bf16 value widens exactly; a
// result narrows to bf16 round-to-nearest-even, as the reference's .astype
// and torch's .to do: a float64 result through float32 first, as they
// round it.
//
// cp_async / cp_async_commit / cp_async_wait: asynchronous copies from
// device memory into shared memory (Ampere's cp.async, kept on Hopper),
// with the copy's size a template argument; a copy that is not `valid`
// reads nothing and writes zeros, so ragged edges need no padding copies.
//
// The SIMT tiling (Tile, stage_rows, tile_fma) serves K2's float64 and
// mixed-precision builds: a block of 256 threads arranged 16 x 16 owns a
// BM x BN output tile and walks the contraction in BK-deep slabs staged
// through shared memory. Thread (ty, tx) owns rows ty*TM .. ty*TM+TM-1 of the tile
// (contiguous, so its A-operand reads merge into vector loads) and columns
// tx, tx+16, ... (strided, so neighbouring threads read neighbouring words
// of the B operand and store neighbouring output columns).
//
// All arithmetic is IEEE fma in the accumulation type Acc: float32 inputs
// accumulate in float32 on the CUDA cores, never in TF32 on the tensor
// cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_tile {

using bf16 = __nv_bfloat16;

template <typename Acc>
__device__ __forceinline__ Acc widen(float x) { return Acc(x); }
template <typename Acc>
__device__ __forceinline__ Acc widen(double x) { return Acc(x); }
template <typename Acc>
__device__ __forceinline__ Acc widen(bf16 x) {
  return Acc(__bfloat162float(x));
}

template <typename T, typename Acc>
__device__ __forceinline__ T narrow(Acc v) {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (std::is_same_v<Acc, double>) {
      return __float2bfloat16_rn(__double2float_rn(v));
    } else {
      return __float2bfloat16_rn(v);
    }
  } else {
    return T(v);
  }
}

__device__ __forceinline__ bool is_zero(float x) { return x == 0.f; }
__device__ __forceinline__ bool is_zero(double x) { return x == 0.0; }
__device__ __forceinline__ bool is_zero(bf16 x) {
  return (__bfloat16_as_ushort(x) & 0x7fffu) == 0;
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same_v<T, bf16>) {
    return __ushort_as_bfloat16((unsigned short)0);
  } else {
    return T(0);
  }
}

constexpr int TY = 16, TX = 16;
constexpr int NT = TY * TX;   // threads per block
constexpr int PAD = 4;        // keeps each staged row 16-byte aligned

// Copy BYTES (4, 8 or 16) from src to the shared-memory address dst; zeros
// when !valid (src is then never read, but must be a valid address). Two
// bytes (bf16 rows of odd length, only 2-byte aligned) have no cp.async:
// that copy is a plain load and store, visible after the same barrier.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(BYTES == 2 || BYTES == 4 || BYTES == 8 || BYTES == 16,
                "cp.async size");
  if constexpr (BYTES == 2) {
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src) : 0;
  } else {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = valid ? BYTES : 0;
    if constexpr (BYTES == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                   "l"(src), "r"(n)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d),
                   "l"(src), "n"(BYTES), "r"(n)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N commit groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename Acc> struct Tile;
template <> struct Tile<float> {
  static constexpr int BM = 128, BN = 128, BK = 16;
};
template <> struct Tile<double> {
  static constexpr int BM = 64, BN = 64, BK = 16;
};

// Stage rows [row0, row0 + ROWS) x columns [k0, k0 + BK) of the row-major
// (n_rows, ld) matrix A into S[k][row] (transposed), zero outside the
// matrix, so ragged rows and a ragged contraction need no padding copies.
template <typename T, typename Acc, int ROWS, int BK>
__device__ __forceinline__ void stage_rows(Acc (*S)[ROWS + PAD],
                                           const T* __restrict__ A,
                                           int64_t row0, int64_t n_rows,
                                           int k0, int k_len, int64_t ld) {
  for (int e = threadIdx.x; e < ROWS * BK; e += NT) {
    const int r = e / BK, c = e % BK;
    const int64_t gr = row0 + r;
    const int gc = k0 + c;
    S[c][r] = (gr < n_rows && gc < k_len) ? widen<Acc>(A[gr * ld + gc])
                                           : Acc(0);
  }
}

// acc[i][j] += sum_k S_a[k][ty*TM + i] * S_b[k][tx + j*TX]
template <typename Acc, int BM, int BN, int BK>
__device__ __forceinline__ void tile_fma(Acc (*Sa)[BM + PAD],
                                         Acc (*Sb)[BN + PAD],
                                         Acc (&acc)[BM / TY][BN / TX]) {
  constexpr int TM = BM / TY, TN = BN / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    Acc a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = Sa[k][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Sb[k][tx + j * TX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fma_(a[i], b[j], acc[i][j]);
  }
}

}  // namespace repro_tile
