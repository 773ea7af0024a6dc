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
// Two instances, one per dtype. Both keep the Pallas kernel's function: the
// running max m, normaliser l and accumulator in float32, key tiles that the
// causal and window tests mask entirely skipped (the Pallas kernel's
// pl.when), the normaliser floored at 1e-30, the output in q's dtype. The
// Pallas kernel carries m, l and acc across a sequential grid axis; Hopper
// blocks run in no order, so a block owns its query rows and walks the key
// tiles in a loop.
//
// bfloat16 (the LM's path): the bf16 tensor cores through wgmma. A block is
// three consumer warpgroups of 64 query rows each (192 rows) and one
// producer warp. The producer's lane 0 loads the query tile once and then K
// and V tiles of 64 keys into a ring of three shared-memory stages with TMA
// (cp.async.bulk.tensor), each stage tracked by a "full" mbarrier (bytes
// landed) and an "empty" one (the twelve consumer warps are done with it).
// TMA writes every tile with the 128-byte swizzle (64-byte at D = 32), the
// head dimension cut into boxes of 64 columns, which is the layout wgmma
// reads: Q (A) and K (B) K-major, V (B of P.V) MN-major. Per key tile a
// consumer warpgroup computes S = Q K^T with D/16 wgmma m64n64k16 (bf16
// operands, float32 sums: each bf16 x bf16 product is exact in float32, so
// S differs from the plain version only in summation order), scales S in
// float32 after the product with log2(e) folded in, runs the online softmax
// in registers (ex2.approx; the row max and sum over the four threads that
// share a row), sums l from the float32 P, rounds P to bf16 in registers as
// the A operand of O += P V (BK/16 wgmma m64nDk16), and releases the stage.
// The accumulator is 64 x D float32 per warpgroup in registers. The three
// warpgroups overlap one another's softmax and products on the SM. Causal
// grids launch the heaviest query tiles (the last ones) first, so the tail
// of the grid is not one long block. Rounding P to bf16 is the one change of
// arithmetic against the plain version: each weight moves by at most 2^-8 of
// itself (bf16's unit roundoff), so an output o_id by at most
// 2^-8 * sum_j p_ij |v_jd| / l_i.
// TMA fills rows past S with zeros; keys past S are masked and query rows
// past S are not stored, so any S works. A head dim that is not a multiple
// of 64 (zamba2's 112) runs the tiles of the next one (DP = 128) on the real
// rows: the tensor maps span the DR real columns (224-byte rows), so the
// box of columns 64-127 reads 112-127 as zeros. Q K^T then takes DR/16
// k-steps (the zero columns would add nothing), P V computes zeros in the
// padded columns, and the store writes the DR real ones. No operand is
// copied into a padded buffer.
//
// Measured on an H100 at the prefill's shape (chip_smoke.py, phase
// summary): about 0.80 ms, about 515 TFLOP/s. Edited copies measured on the
// same card were slower: the warp index without the shuffle below (ptxas
// cannot prove the role and warpgroup branches warp-uniform and
// serialises every wgmma, C7520), two consumer warpgroups, P packed inside
// the P.V loop (ptxas injects a warpgroup arrive before each wgmma), and a
// tile's P.V issued beside the next tile's Q K^T (FA3's intra-warpgroup
// overlap: out of registers at three warpgroups).
//
// float32 (tests only; its contract is IEEE float32 at atol 2e-5): SIMT.
// One block of 256 threads owns a 64-row query tile; S = Q K^T and
// acc += P V are 4 x 4 micro-tiles of fma from shared memory (tile.cuh), K
// and V sharing one buffer; the row max and sum are half-warp shuffles.
#include <cuda.h>
#include <cuda_bf16.h>

#include "tile.cuh"

namespace {

constexpr float NEG = -1e30f;          // the Pallas kernel's NEG_INF

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// ------------------------------------------------------- float32: SIMT

namespace simt {

using namespace repro_tile;

constexpr int BQ = 64, BK = 64;        // query rows, keys per tile
constexpr int TM = BQ / TY;            // query rows per thread
constexpr int TNS = BK / TX;           // keys per thread in S = Q K^T

// Shared memory in floats: Qs[D][BQ+PAD], one buffer that holds Ks[D][BK+PAD]
// and then Vs[BK][D+PAD], and Ps[BK][BQ+PAD].
template <int D> struct Smem {
  static constexpr int Q = D * (BQ + PAD);
  static constexpr int KT = D * (BK + PAD), VT = BK * (D + PAD);
  static constexpr int KV = KT > VT ? KT : VT;
  static constexpr int P = BK * (BQ + PAD);
  static constexpr int BYTES = (Q + KV + P) * (int)sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int Hq,
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
  const float* qb = q + (int64_t)bh * S * D;
  const float* kb = k + (int64_t)kvh * S * D;
  const float* vb = v + (int64_t)kvh * S * D;

  // the query tile, scaled before the product as the Pallas kernel does,
  // transposed: Qs[d][row]
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    Qs[c][r] = q0 + r < S ? qb[(int64_t)(q0 + r) * D + c] * scale : 0.f;
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
      Ks[c][r] = k0 + r < S ? kb[(int64_t)(k0 + r) * D + c] : 0.f;
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
      Vs[r][c] = k0 + r < S ? vb[(int64_t)(k0 + r) * D + c] : 0.f;
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
    float* row = out + ((int64_t)bh * S + qp) * D;
#pragma unroll
    for (int j = 0; j < TNO; ++j) row[tx + j * TX] = acc[i][j] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_f32<D>;
  cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * Hq));
  kernel<<<grid, NT, Smem<D>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, S,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------- bfloat16: wgmma and TMA

namespace tc {

constexpr int CONSUMERS = 3;                 // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;           // query rows per block
constexpr int BK = 64;                       // keys per tile
constexpr int STAGES = 3;                    // K/V ring depth
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// The tile layout of head dim D: boxes of CW columns (one 128-byte row of
// bf16, or 64 bytes at D = 32), NC of them, each [rows][CW] swizzled.
template <int D> struct Geo {
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NC = D / CW;
  static constexpr int ROW_BYTES = CW * 2;                 // 128 or 64
  static constexpr int SWZ = ROW_BYTES == 128 ? 1 : 2;     // wgmma layout
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;              // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait that
// never ends (a fault in the pipeline) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// one box of a 3-d tensor map (column, row, head) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma registers across
// the (asynchronous) wgmma instructions and their wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory) *
// B (64 x 16, K-major in shared memory), bf16 operands
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, float32) += A (64 x 16, bf16 in registers) * B (16 x 32,
// bf16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// bf16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// bf16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// is key tile [k0, k0 + BK) live for query rows [r0, r0 + rows)?
__device__ __forceinline__ bool tile_live(int k0, int r0, int rows, int causal,
                                          int window) {
  if (causal && k0 > r0 + rows - 1) return false;
  if (window > 0 && r0 - (k0 + BK - 1) >= window) return false;
  return true;
}

// D: the tiles' head dim (a multiple of 64, or 32); DR <= D: the operands'
template <int D, int DR>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int S,
               int causal, int window, float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + G::Q_BYTES,
                 sV = sK + STAGES * G::KV_BYTES;
  const uint32_t bar = base + G::BAR_OFF;   // full[STAGES], empty[STAGES], q
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (STAGES + s); };
  const uint32_t qbar = bar + 8u * (2 * STAGES);

  const int bh = blockIdx.x;                       // b * Hq + hq
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  // heaviest causal tiles first: blockIdx.y counts from the last tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  // the warp index through a shuffle is provably warp-uniform: branches on
  // it (the roles, a warpgroup's rows) do not make ptxas serialise wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: one lane issues every copy
    if (lane != 0) return;
    mbar_expect_tx(qbar, G::Q_BYTES);
    for (int c = 0; c < G::NC; ++c)
      tma_load(sQ + c * BQ * G::ROW_BYTES, &tq, qbar, c * G::CW, q0, bh);
    int stage = 0, phase = 0;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
      if (!tile_live(k0, q0, BQ, causal, window)) continue;
      mbar_wait(empty(stage), phase ^ 1);
      mbar_expect_tx(full(stage), 2 * G::KV_BYTES);
      for (int c = 0; c < G::NC; ++c) {
        const uint32_t off = stage * G::KV_BYTES + c * BK * G::ROW_BYTES;
        tma_load(sK + off, &tk, full(stage), c * G::CW, k0, kvh);
        tma_load(sV + off, &tv, full(stage), c * G::CW, k0, kvh);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [r0, r0 + 64); this thread the
  // rows row and row + 8, and of each 8-column block the columns 2c, 2c + 1
  const int wg = warp / 4;
  const int r0 = q0 + 64 * wg;
  const int row = r0 + 16 * (warp % 4) + lane / 4, c2 = 2 * (lane % 4);
  const bool rows_live = r0 < S;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  // A = this warpgroup's 64 query rows, K-major; k step kk is 16 columns
  const uint32_t sQw = sQ + 64 * wg * G::ROW_BYTES;
  auto q_desc = [&](int kk) {
    const int c = kk / (G::CW / 16), in = kk % (G::CW / 16);
    return desc(sQw + c * BQ * G::ROW_BYTES + 32 * in, 16,
                8 * G::ROW_BYTES, G::SWZ);
  };

  mbar_wait(qbar, 0);
  int stage = 0, phase = 0;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    if (!tile_live(k0, q0, BQ, causal, window)) continue;
    mbar_wait(full(stage), phase);
    if (rows_live && tile_live(k0, r0, 64, causal, window)) {
      const uint32_t kt = sK + stage * G::KV_BYTES;
      const uint32_t vt = sV + stage * G::KV_BYTES;
      // S = Q K^T: B = the 64 keys, K-major
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DR / 16; ++kk) {
        const int c = kk / (G::CW / 16), in = kk % (G::CW / 16);
        wgmma_ss(s, q_desc(kk),
                     desc(kt + c * BK * G::ROW_BYTES + 32 * in, 16,
                          8 * G::ROW_BYTES, G::SWZ),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks, then the online softmax in the log2 domain; s[4j + e] is
      // row row + 8 * (e / 2), key k0 + 8j + c2 + e % 2
      const bool mask = k0 + BK > S || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r0 + 63 - k0 >= window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (mask && !visible(row + 8 * (e / 2), k0 + 8 * j + c2 + e % 2, S,
                               causal, window))
            s[4 * j + e] = -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
        }
      float corr[2], mneg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        mneg[h] = -m_new;
        l[h] *= corr[h];
      }
      // P in float32 (a masked key gives ex2(-inf) = 0), l from it
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, mneg[e / 2]));
          s[4 * j + e] = p;
          l[e / 2] += p;
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      // O += P V: P rounded to bf16 as the A operand in registers (the
      // accumulator layout of keys 16t .. 16t + 15 is the A layout of k
      // step t), all of it before the fence; B = V, MN-major, its D
      // columns in boxes LBO apart
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        pa[t][0] = pack_bf16(s[8 * t], s[8 * t + 1]);
        pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
        pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
        pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        wgmma_rs(o, pa[t],
                 desc(vt + 16 * t * G::ROW_BYTES, BK * G::ROW_BYTES,
                      8 * G::ROW_BYTES, G::SWZ));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // l over the four threads of a row, then the normalised rows, their DR
  // real columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qp = row + 8 * h;
    if (qp >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = out + ((int64_t)bh * S + qp) * DR + c2;
#pragma unroll
    for (int j = 0; j < DR / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / den,
                                o[4 * j + 2 * h + 1] / den);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B*H, S, DR) bf16 as a 3-d map (column, row, head) with boxes of CW
// columns and `rows` rows; rows past S and columns past DR read as zeros
template <int D, int DR>
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int S,
                int heads, int rows) {
  using G = Geo<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)DR, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)DR * 2, (cuuint64_t)S * DR * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::CW, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DR>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  using G = Geo<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D, DR>(&tq, encode, q, S, B * Hq, BQ) ||
      !tensor_map<D, DR>(&tk, encode, k, S, B * Hkv, BK) ||
      !tensor_map<D, DR>(&tv, encode, v, S, B * Hkv, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16<D, DR>;
  cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + BQ - 1) / BQ));
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Hq, Hkv, S, causal,
      window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tc

// D: the operands' head dim; DP: the bf16 instance's tiles (D padded)
template <int D, int DP = D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int S, int dtype, int causal, int window,
             float scale, cudaStream_t s) {
  if (dtype == 0)
    return simt::launch<D>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale,
                           s);
  if (dtype == 1)
    return tc::launch<DP, D>(q, k, v, out, B, Hq, Hkv, S, causal, window,
                             scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q, k, v and the output): 0 = float32 (SIMT), 1 = bfloat16
// (tensor cores). D in {32, 64, 112, 128}; Hq a multiple of Hkv; scale already
// resolved (> 0). q, k, v 16-byte aligned and contiguous. Returns
// cudaGetLastError() after the launch.
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
  if (D == 32)
    return launch_d<32>(q, k, v, out, B, Hq, Hkv, S, dtype, causal, window, sc,
                        s);
  if (D == 64)
    return launch_d<64>(q, k, v, out, B, Hq, Hkv, S, dtype, causal, window, sc,
                        s);
  if (D == 112)   // zamba2-7b's shared attention: 3584 over 32 heads
    return launch_d<112, 128>(q, k, v, out, B, Hq, Hkv, S, dtype, causal,
                              window, sc, s);
  if (D == 128)
    return launch_d<128>(q, k, v, out, B, Hq, Hkv, S, dtype, causal, window,
                         sc, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
