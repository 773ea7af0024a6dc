// K2 rls_scores: l_i = sum_j (B M)_ij B_ij for row-major B (n, p) and the
// p x p inverse M = (B^T B + n lam I)^{-1} (paper eq. 9, step 5).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rls_scores.py::rls_scores_fused (body _rls_kernel).
//
// The Pallas kernel kept all of M in VMEM; at p = 2048 in float32 M is
// 16 MB, far above the 227 KB of shared memory a block can use. So a block
// owns a tile of rows of B and walks M in column blocks j; for each j it
// forms T_j = B_rows * M[:, j] over k-slabs of B and M staged in shared
// memory, then folds rowsum(T_j * B_rows[:, j]) into per-row partials. T is
// never written to device memory, each block reduces over all j itself (no
// atomics), and one score per row is written at the end. M is read as
// given: it is not bit-symmetric, and no transpose stands in for it.
//
// float32 data and accumulation (the main path's build): 3xTF32 on the
// tensor cores. Bound on an H100 SXM at the main path's shape (n = 463,715,
// p = 2048): 2*n*p^2 = 3.89e12 operations done three times (a_hi*b_hi +
// a_hi*b_lo + a_lo*b_hi) = 11.7e12 at 495 TFLOP/s TF32, 23.6 ms, against
// 4*(n*p + p*p + n) = 3.8 GB, 1.1 ms at 3.35 TB/s: bound by operations (the
// IEEE float32 bound of the same work is 58 ms at 67 TFLOP/s). Design: a
// block of 8 warps owns 128 rows and walks M in 256-column blocks, so B is
// read p / 256 = 8 times (8 * 3.8 GB = 30 GB, 9 ms at 3.35 TB/s, under the
// products; M, 16 MB, stays in L2). Slabs of 32 k-values of B and M arrive
// by 16-byte cp.async (4-byte where p is not a multiple of 4) into a ring
// of three shared-memory stages, padded so that fragment loads hit 32
// distinct banks. Each warp computes a 64 x 64 tile of T_j with
// mma.sync.m16n8k8 TF32: every operand is split in registers when its
// fragment is loaded into x_hi = tf32(x) (truncated) and x_lo = x - x_hi,
// and the three products accumulate in float32, small terms first. A
// product then errs by less than 3 * 2^-20 of |a b| (IEEE float32: 2^-24;
// one TF32 product: 2^-10). Measured on an H100 (chip_smoke.py, phase
// k2), the scores sit within 1.31e-5 (relative) of IEEE float32 at
// p = 2048, 2.54e-5 at 4096 and 4.96e-5 at 8192: the tensor cores'
// float32 accumulation, not the split, sets that error, and only p <= 2048
// stays 10x inside rtol 2e-4, so the wrapper (rls_scores.py) refuses a
// larger p in this build. The fold multiplies by the unsplit float32
// B[r, j].
//
// bf16 data with float32 accumulation (the reference's rule for bf16 B; M
// stays float32, never rounded to bf16): the same body, B staged as bf16
// (rows of 40 values, 80 bytes). A bf16 value is a TF32 value exactly, so
// B's low part is zero and two products remain, B * M_hi + B * M_lo, each
// exact in float32 but for M_lo's bits below TF32; the fold multiplies by
// the upcast bf16 B[r, j] and the score is rounded to bf16 once. Bound at
// the main path's shape: 2 * 2*n*p^2 = 7.8e12 operations at 495 TFLOP/s,
// 15.7 ms, against 1.9 GB of B, 0.57 ms: operations. The scores come back
// in bf16 (a relative step of 2^-8), far above the tensor cores' float32
// accumulation error, so this build takes any p (chip_smoke.py phase
// limits measures it at p = 2048, 4096 and 8192).
//
// float64, and the mixed builds (float32 data with float64 accumulation,
// the reverse, and bf16 data with float64 accumulation): SIMT fma on the
// CUDA cores (tile.cuh), one block of 256 threads per 128-row tile (64 in
// float64) against 128-column blocks of M (64 in float64) over 16-deep
// k-slabs. Bound in float64: the same 2*n*p^2 at 67 TFLOP/s.
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
        if (gj < p)
          part[i] = fma_(acc[i][j], widen<Acc>(B[r * p + gj]), part[i]);
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
    if (tx == 0 && r < n) out[r] = narrow<T>(v);
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


// ------------------------------------------ float32: 3xTF32 tensor cores

namespace tf32x3 {

constexpr int BM = 128, BN = 256, BK = 32, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 4;       // 8 warps of WM x WN
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
constexpr int MT = WM / 16, NT8 = WN / 8;     // m16 and n8 tiles a warp
// rows of the staged B slab: 36 floats or 40 bf16 (144 or 80 bytes, 16-byte
// aligned), so the a-fragments hit distinct banks
template <typename T> constexpr int LDA = BK + (sizeof(T) == 2 ? 8 : 4);
constexpr int LDB = BN + 8;                   // 264: b-fragments likewise
template <typename T>
constexpr int A_BYTES = BM * LDA<T> * (int)sizeof(T);
constexpr int B_BYTES = BK * LDB * (int)sizeof(float);
template <typename T> constexpr int STAGE_BYTES = A_BYTES<T> + B_BYTES;
template <typename T> constexpr int SMEM = STAGES * STAGE_BYTES<T>;

// x = hi + lo exactly: hi is x with the 13 low mantissa bits cleared (a
// TF32 value), lo = x - hi; the tensor cores read lo's top 19 bits. Two
// instructions: rounding both parts (cvt.rna) made K2 slower at the main
// path's shape on an H100 and changed no measured error
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage slab `it` (column block it / kt, k-slab it % kt) into `st`: rows
// [row0, row0 + BM) x k [k0, k0 + BK) of B and rows k of M x columns
// [j0, j0 + BN), zeros outside the matrices. BBYTES and MBYTES: the copies
// of B and of M, 16 bytes where p and the base addresses allow, else 4 (2
// for bf16 rows of odd length).
template <typename T, int BBYTES, int MBYTES>
__device__ __forceinline__ void load_slab(unsigned char* st,
                                          const T* __restrict__ B,
                                          const float* __restrict__ M,
                                          int64_t row0, int n, int p, int it,
                                          int kt) {
  const int j0 = (it / kt) * BN, k0 = (it % kt) * BK;
  T* As = reinterpret_cast<T*>(st);
  float* Bs = reinterpret_cast<float*>(st + A_BYTES<T>);
  constexpr int WA = BBYTES / (int)sizeof(T), WM_ = MBYTES / 4;
#pragma unroll
  for (int e = threadIdx.x; e < BM * BK / WA; e += THREADS) {
    const int r = e / (BK / WA), c = (e % (BK / WA)) * WA;
    const int64_t gr = row0 + r;
    const int gc = k0 + c;
    const bool ok = gr < n && gc < p;
    cp_async<BBYTES>(As + r * LDA<T> + c, ok ? B + gr * p + gc : B, ok);
  }
#pragma unroll
  for (int e = threadIdx.x; e < BK * BN / WM_; e += THREADS) {
    const int k = e / (BN / WM_), j = (e % (BN / WM_)) * WM_;
    const int gk = k0 + k, gj = j0 + j;
    const bool ok = gk < p && gj < p;
    cp_async<MBYTES>(Bs + k * LDB + j, ok ? M + (int64_t)gk * p + gj : M,
                     ok);
  }
}

// the TF32 operand of a staged B value: float32 is split (split() below);
// a bf16 value is its own TF32 high part, exactly, with no low part
__device__ __forceinline__ uint32_t tf32_of(bf16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

template <typename T, int BBYTES, int MBYTES>
__global__ void __launch_bounds__(THREADS, 1)
rls_scores_tf32x3(const T* __restrict__ B, const float* __restrict__ M,
                  T* __restrict__ out, int n, int p) {
  constexpr bool BF16 = std::is_same_v<T, bf16>;
  constexpr int LD = LDA<T>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int kt = (p + BK - 1) / BK, nj = (p + BN - 1) / BN;
  const int slabs = kt * nj;

  float part[MT][2];                  // rows g and g + 8 of each m16 tile
  float acc[MT][NT8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    part[mi][0] = part[mi][1] = 0.f;
#pragma unroll
    for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }

  // one commit group per slab, empty past the last, so that
  // wait_group(STAGES - 2) always means "slab it has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs)
      load_slab<T, BBYTES, MBYTES>(sm + s * STAGE_BYTES<T>, B, M, row0, n, p,
                                   s, kt);
    cp_async_commit();
  }

  for (int it = 0; it < slabs; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                  // slab it visible; slot it-1 free
    const int next = it + STAGES - 1;
    if (next < slabs)
      load_slab<T, BBYTES, MBYTES>(sm + (next % STAGES) * STAGE_BYTES<T>, B,
                                   M, row0, n, p, next, kt);
    cp_async_commit();

    const unsigned char* st = sm + (it % STAGES) * STAGE_BYTES<T>;
    const T* As = reinterpret_cast<const T*>(st) + wm * WM * LD;
    const float* Bs =
        reinterpret_cast<const float*>(st + A_BYTES<T>) + wn * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[NT8][2], bl[NT8][2];
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split(Bs[(kk + t + 4 * h) * LDB + ni * 8 + g], bh[ni][h],
                bl[ni][h]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const T* a = As + (mi * 16 + g) * LD + kk + t;
        uint32_t ah[4];
        if constexpr (BF16) {
          // two products, small term first: b_hi a + b_lo a (a_lo = 0)
          ah[0] = tf32_of(a[0]);
          ah[1] = tf32_of(a[8 * LD]);
          ah[2] = tf32_of(a[4]);
          ah[3] = tf32_of(a[8 * LD + 4]);
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) mma(acc[mi][ni], ah, bl[ni]);
        } else {
          uint32_t al[4];
          split(a[0], ah[0], al[0]);
          split(a[8 * LD], ah[1], al[1]);
          split(a[4], ah[2], al[2]);
          split(a[8 * LD + 4], ah[3], al[3]);
          // small terms first; each pass over the 8 n-tiles is independent
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) mma(acc[mi][ni], al, bh[ni]);
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni) mma(acc[mi][ni], ah, bl[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < NT8; ++ni) mma(acc[mi][ni], ah, bh[ni]);
      }
    }

    if (it % kt == kt - 1) {
      // column block done: fold T_j * B[rows, j-block] into the row
      // partials with the unsplit B, and start the next block from zero
      const int jw = (it / kt) * BN + wn * WN;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t r = row0 + wm * WM + mi * 16 + g + 8 * h;
#pragma unroll
          for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = jw + ni * 8 + 2 * t + e;
              if (r < n && j < p)
                part[mi][h] =
                    fmaf(acc[mi][ni][2 * h + e],
                         widen<float>(__ldg(B + r * p + j)), part[mi][h]);
              acc[mi][ni][2 * h + e] = 0.f;
            }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the stages are free for the sums

  // a row's partials: 4 threads of a quad, then the 4 warps across j
  float* red = reinterpret_cast<float*>(sm);  // [WARPS_N][BM]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = part[mi][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[wn * BM + wm * WM + mi * 16 + g + 8 * h] = v;
    }
  __syncthreads();
  if (threadIdx.x < BM && row0 + threadIdx.x < n) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_N; ++w) v += red[w * BM + threadIdx.x];
    out[row0 + threadIdx.x] = narrow<T>(v);
  }
}

template <typename T, int BBYTES, int MBYTES>
int launch_copies(const T* B, const float* M, T* out, int n, int p,
                  cudaStream_t stream) {
  auto kernel = rls_scores_tf32x3<T, BBYTES, MBYTES>;
  cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<T>);
  if (set != cudaSuccess) return (int)set;
  const int64_t row_tiles = (n + BM - 1) / BM;
  kernel<<<(unsigned)row_tiles, THREADS, SMEM<T>, stream>>>(B, M, out, n, p);
  return (int)cudaGetLastError();
}

// 16-byte copies where p is a multiple of 16 bytes' values and both
// operands are 16-byte aligned, else 4-byte ones (2-byte for bf16 rows of
// odd length)
template <typename T>
int launch(const T* B, const float* M, T* out, int n, int p,
           cudaStream_t stream) {
  constexpr int PER16 = 16 / (int)sizeof(T);
  const uintptr_t b = reinterpret_cast<uintptr_t>(B);
  const uintptr_t m = reinterpret_cast<uintptr_t>(M);
  if (p % PER16 == 0 && p % 4 == 0 && b % 16 == 0 && m % 16 == 0)
    return launch_copies<T, 16, 16>(B, M, out, n, p, stream);
  if constexpr (sizeof(T) == 2) {
    if (p % 2 == 0 && b % 4 == 0)
      return launch_copies<T, 4, 4>(B, M, out, n, p, stream);
    return launch_copies<T, 2, 4>(B, M, out, n, p, stream);
  } else {
    return launch_copies<T, 4, 4>(B, M, out, n, p, stream);
  }
}

}  // namespace tf32x3

}  // namespace

// dtype (of B and the scores): 0 = float32, 1 = float64, 2 = bf16; acc (of
// M and the arithmetic): 0 = float32, 1 = float64. (float32, float32) runs
// on the tensor cores as 3xTF32 and (bf16, float32) as 2xTF32, the others
// in SIMT fma. Returns cudaGetLastError() after the launch.
extern "C" int rls_scores_launch(const void* B, const void* M, void* out,
                                 int n, int p, int dtype, int acc, int device,
                                 void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && acc == 0)
    return tf32x3::launch(static_cast<const float*>(B),
                          static_cast<const float*>(M),
                          static_cast<float*>(out), n, p, s);
  if (dtype == 0 && acc == 1) return launch<float, double>(B, M, out, n, p, s);
  if (dtype == 1 && acc == 0) return launch<double, float>(B, M, out, n, p, s);
  if (dtype == 1 && acc == 1)
    return launch<double, double>(B, M, out, n, p, s);
  if (dtype == 2 && acc == 0)
    return tf32x3::launch(static_cast<const bf16*>(B),
                          static_cast<const float*>(M),
                          static_cast<bf16*>(out), n, p, s);
  if (dtype == 2 && acc == 1) return launch<bf16, double>(B, M, out, n, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rls_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
