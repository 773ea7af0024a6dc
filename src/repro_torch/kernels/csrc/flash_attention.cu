// K4 flash_attention: out = softmax(mask(q k^T * scale)) v for q (B, Hq, S, D)
// and k, v (B, Hkv, S, D), query head h reading KV head h / (Hq / Hkv).
// Masks: causal (q >= k) and a sliding window (q - k < window, window > 0).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_fwd_kernel (through _flash_fwd
// and flash_attention).
//
// Bound on an H100 SXM: 4*D operations per live (query, key) pair (q.k and
// p.v) against one read of q, k, v and one write of the output. At the
// phi4-mini prefill (B = 1, Hq = 24, Hkv = 8, S = 8192, D = 128, causal, bf16)
// that is 4*24*128*8192*8193/2 = 412 GFLOP, 0.42 ms at the 989 TFLOP/s of the
// bf16 tensor cores, against 2*(24 + 8 + 8 + 24)*8192*128 = 134 MB, 0.04 ms
// at 3.35 TB/s: bound by operations.
//
// Design against that bound, right and simple first: the Pallas kernel walks
// key blocks in a sequential grid axis and carries m, l and acc in VMEM
// scratch; Hopper has no sequential grid carry, so one block of 256 threads
// owns a 64-row query tile of one (batch, head) and walks the key tiles in a
// loop, skipping tiles the causal and window tests mask entirely (as the
// Pallas kernel's pl.when does: about half the pairs at causal). Per key
// tile: K (transposed) is staged in shared memory, S = Q K^T is a 64 x 64
// SIMT tile product (tile.cuh, 4 x 4 per thread), the mask and the online
// softmax run in registers with the row max and sum reduced over the 16
// threads that share a row, P goes to shared memory, V replaces K in the
// same buffer, and acc += P V. The running max, normaliser and accumulator
// stay in registers in float32. All arithmetic is IEEE float32 fma, for the
// bf16 build too (bf16 is loaded and converted), which is the arithmetic the
// Pallas kernel writes; that puts the kernel on the 67 TFLOP/s float32
// rate of the CUDA cores, 15x under the bound above. Tensor cores
// (mma.sync / wgmma with P rounded to bf16) are the redesign that closes it.
// Ragged S (any S <= 256): rows and keys past S are staged as zeros and the
// keys masked, so no tile is assumed full.
#include <cuda_bf16.h>

#include "tile.cuh"

using namespace repro_tile;

namespace {

constexpr int BQ = 64, BK = 64;        // query rows, keys per tile
constexpr int TM = BQ / TY;            // query rows per thread
constexpr int TNS = BK / TX;           // keys per thread in S = Q K^T
constexpr float NEG = -1e30f;          // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory in floats: Qs[D][BQ+PAD], one buffer that holds Ks[D][BK+PAD]
// and then Vs[BK][D+PAD], and Ps[BK][BQ+PAD].
template <int D> struct Smem {
  static constexpr int Q = D * (BQ + PAD);
  static constexpr int KT = D * (BK + PAD), VT = BK * (D + PAD);
  static constexpr int KV = KT > VT ? KT : VT;
  static constexpr int P = BK * (BQ + PAD);
  static constexpr int BYTES = (Q + KV + P) * (int)sizeof(float);
};

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int S, int causal, int window, float scale) {
  constexpr int TNO = D / TX;          // output columns per thread
  extern __shared__ __align__(16) float smem[];
  auto Qs = reinterpret_cast<float (*)[BQ + PAD]>(smem);
  float* kv = smem + Smem<D>::Q;
  auto Ks = reinterpret_cast<float (*)[BK + PAD]>(kv);
  auto Vs = reinterpret_cast<float (*)[D + PAD]>(kv);
  auto Ps = reinterpret_cast<float (*)[BQ + PAD]>(kv + Smem<D>::KV);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.y;                       // b * Hq + hq
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (int64_t)bh * S * D;
  const T* kb = k + (int64_t)kvh * S * D;
  const T* vb = v + (int64_t)kvh * S * D;

  // the query tile, upcast and scaled before the product as the Pallas
  // kernel does, transposed: Qs[d][row]
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    Qs[c][r] = q0 + r < S ? to_f(qb[(int64_t)(q0 + r) * D + c]) * scale : 0.f;
  }

  float m[TM], l[TM], acc[TM][TNO];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TNO; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // skip tiles masked entirely (the Pallas kernel's `live` test)
    if (window > 0 && q0 - (k0 + BK - 1) >= window) continue;

    __syncthreads();                   // Ps and the K/V buffer are free
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D;
      Ks[c][r] = k0 + r < S ? to_f(kb[(int64_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[TM][TNS];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TNS; ++j) s[i][j] = 0.f;
    tile_fma<float, BQ, BK, D>(Qs, Ks, s);

    // mask, then the online softmax update of each of this thread's rows;
    // the 16 threads of a half-warp (same ty) share the rows
    float corr[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = q0 + ty * TM + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < TNS; ++j) {
        const int kp = k0 + tx + j * TX;
        if (!visible(qp, kp, S, causal, window)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TNS; ++j) {
        const int kp = k0 + tx + j * TX;
        const float p =
            visible(qp, kp, S, causal, window) ? expf(s[i][j] - m_new) : 0.f;
        Ps[tx + j * TX][ty * TM + i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = fmaf(l[i], corr[i], sum);
      m[i] = m_new;
    }
    __syncthreads();                   // Ks is read, Ps is written

    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D;
      Vs[r][c] = k0 + r < S ? to_f(vb[(int64_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TNO; ++j) acc[i][j] *= corr[i];
    tile_fma<float, BQ, D, BK>(Ps, Vs, acc);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = q0 + ty * TM + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = out + ((int64_t)bh * S + qp) * D;
#pragma unroll
    for (int j = 0; j < TNO; ++j) row[tx + j * TX] = from_f<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * Hq));
  kernel<<<grid, NT, Smem<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, S, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int S, int D, int causal, int window,
               float scale, cudaStream_t s) {
  if (D == 32)
    return launch<T, 32>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale, s);
  if (D == 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale,
                          s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q, k, v and the output): 0 = float32, 1 = bfloat16. D in
// {32, 64, 128}; Hq a multiple of Hkv; scale already resolved (> 0).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int S, int D, int dtype,
                                      int causal, int window, double scale,
                                      int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = (float)scale;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, Hq, Hkv, S, D, causal, window,
                             sc, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, D, causal,
                                     window, sc, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
