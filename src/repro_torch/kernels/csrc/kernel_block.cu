// K1 kernel_block: C = k(X, Z) in R^{n x p} for row-major X (n, d), Z (p, d).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rbf_block.py::kernel_block
// (bodies _rbf_block_kernel, _linear_block_kernel, _poly_block_kernel over
// _cross_tile). Kinds: 0 rbf   exp(-max(|x|^2 + |z|^2 - 2 x.z, 0) / 2h^2)
//                      1 linear x.z
//                      2 poly   (x.z / scale + offset)^degree
//
// Three designs: one per accumulation type, and one for bf16 data. All
// walk d in k-slabs staged through shared memory, accumulate the squared
// norms |x|^2 and |z|^2 from the same staged slabs (no norm pass), mask the
// ragged n, p and d edges in the loads and the stores (no padding copies),
// and fuse the epilogue, so C is written once and never read back. The grid is one-dimensional with the
// column tiles fastest: consecutive blocks share an X row tile, which then
// comes from L2.
//
// float32 accumulation (the main path's build; float32 or float64 data):
// IEEE fma on the CUDA cores, never TF32. Bound on an H100 SXM at the main
// path's shape (n = 463,715, p = 2048, d = 90): 2*n*p*d = 1.71e11
// operations, 2.6 ms at the 67 TFLOP/s float32 rate, against 3.8 GB of
// output, 1.1 ms at 3.35 TB/s. Persistent blocks of 256 threads (two an
// SM) walk 128 x 128 output tiles (64 x 64 and 128 threads where the
// 128-wide tiles would leave SMs idle, as a predict batch of 256 rows
// does). Slabs of 16 k-values arrive by cp.async in a two-slot ring that
// runs across tile boundaries, so a tile's first slabs load during the
// previous tile's last slab and epilogue; thread t moves staged row t into
// k-major float buffers (adding its squares to |.|^2), one barrier a slab.
// Thread (ty, tx) owns 8 rows and 8 columns (4 + 4, 64 apart): its
// fragments are 16-byte shared-memory loads, its stores 16-byte vectors.
// 128 registers, no spills. Measured on an H100 its products run at about
// 60 % of the float32 rate (PERF.md), the output write sets the rest.
//
// float64 accumulation (float64 data, or float32 data accumulated in
// float64, which the sparse path's W = k(Z, Z) uses): the FP64 tensor
// cores, mma.sync.m16n8k8 with .f64 operands (DMMA: IEEE float64 fused
// multiply-adds, so the float64 tolerances are unchanged). Bound at the W
// shape (p = n = 2048, d = 47,236): 2*n*p*d = 3.96e11 operations, 5.92 ms
// at 67 TFLOP/s, for dense rows. A block of 16 warps owns a 128 x 128 tile,
// each warp a 32 x 32 part of it (2 x 4 m16n8 tiles), over 32-deep slabs
// that cp.async keeps five (float32) or three (float64) stages deep; the
// data stays in its own type in shared memory and float32 is converted to
// float64 as each fragment is loaded. While a slab is staged, thread t
// reads row t of it (summing the norms) and ballots mark the rows with a
// non-zero in each 8 k-values; a warp skips a k-step whose 32 rows of X or
// of Z are all zero there: those products add exact zeros (finite inputs),
// so the result is the same bit for bit, and the densified landmark rows of
// the sparse path, 99.8 % zeros, skip most of their products. The tile of
// accumulators leaves registers through shared memory before the epilogue
// (the float64 exp is a call; live accumulators across it spilled). bf16
// data accumulated in float64 runs this body too, widening bf16 as the
// fragments load (7 stages of 80-byte rows).
//
// bf16 data, float32 accumulation (the reference's rule for bf16 blocks):
// the bf16 tensor cores, mma.sync.m16n8k16 .bf16 with float32 accumulators.
// A bf16 product is exact in float32, so the tensor cores compute what the
// reference computes up to the order of the sum; the norms are summed from
// the staged values upcast to float32, the epilogue runs in float32 and the
// block is rounded to bf16 once (round-to-nearest-even). Bound on an H100
// SXM at the main path's shape (n = 463,715, p = 2048, d = 90): 1.9 GB of
// bf16 output, 0.57 ms at 3.35 TB/s, against 1.71e11 operations, 0.17 ms at
// 989 TFLOP/s: bytes. A block of 8 warps owns a 128 x 128 tile, each warp a
// 64 x 32 part of it (4 x 4 m16n8 tiles), over 32-deep slabs that cp.async
// keeps four stages deep (80 KB, two blocks an SM); fragments are 4-byte
// shared-memory loads of bf16 pairs, rows 80 bytes apart. As in the float64
// body, ballots mark each staged row's non-zero 16-value k-steps and a warp
// skips a step whose rows of X or of Z are all zero there (the sparse path's
// densified landmark rows). The accumulators leave registers through
// shared memory before the epilogue, which then takes a pair of
// neighbouring columns a thread, a warp along a row, stored as one 4-byte
// bf16 pair.
#include "tile.cuh"

using namespace repro_tile;

namespace {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// the fused epilogue: cross term v, squared norms xx and zz
template <typename Acc>
__device__ __forceinline__ Acc finish(Acc v, Acc xx, Acc zz, int kind,
                                      Acc two_h2, Acc scale, Acc offset,
                                      int degree) {
  if (kind == 0) {
    Acc d2 = xx + zz - Acc(2) * v;
    d2 = d2 > Acc(0) ? d2 : Acc(0);
    return exp_(-d2 / two_h2);
  }
  if (kind == 2) {
    const Acc base = v / scale + offset;
    Acc pw = Acc(1);
    for (int q = 0; q < degree; ++q) pw *= base;
    return pw;
  }
  return v;
}

// Copy the slab rows [row0, row0 + ROWS) x k [k0, k0 + BK) of the row-major
// (n_rows, d) matrix A into S[r * LD + k], BYTES per copy (BYTES / sizeof(T)
// divides d, so a copy never straddles the ragged edge), zeros outside A.
template <typename T, int ROWS, int BK, int LD, int BYTES, int THREADS>
__device__ __forceinline__ void stage_slab(T* S, const T* __restrict__ A,
                                           int64_t row0, int n_rows, int k0,
                                           int d) {
  constexpr int W = BYTES / (int)sizeof(T);
  constexpr int PER_ROW = BK / W;
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * W;
    const int64_t gr = row0 + r;
    const int gc = k0 + c;
    const bool ok = gr < n_rows && gc < d;
    cp_async<BYTES>(S + r * LD + c, ok ? A + gr * d + gc : A, ok);
  }
}

// ------------------------------------------ float32 accumulation: SIMT

namespace simt {

// BM x BM tiles (128, or 64 for grids under one wave) and 2 BM threads,
// one staged row each; thread (ty, tx) of a 16-wide grid owns 8 rows and
// BM / 16 columns
constexpr int BK = 16, PAD = 4, RAW = 2;
constexpr int RLD = BK + 4;  // raw rows 80 bytes apart: 16-byte reads of
                             // consecutive rows hit distinct banks

// Shared memory: RAW slots of the slabs as cp.async copies them (row-major,
// in the data type T: X's BM rows, then Z's BN rows), and two k-major float
// buffers for X ([BK][BM + PAD]) and for Z ([BK][BN + PAD]) that the
// products read.
template <typename T, int BM>
struct Smem {
  T raw[RAW][2 * BM * RLD];
  float kx[2][BK][BM + PAD];
  float kz[2][BK][BM + PAD];
  float xx[BM], zz[BM];
};

// Thread t moves staged row t of a landed slab into the k-major buffers as
// float, and adds its squares to its row's |.|^2
template <typename T, int BM>
__device__ __forceinline__ void transpose(Smem<T, BM>& sm, int slot, int buf,
                                          float& sq) {
  const int t = threadIdx.x;
  const T* r = sm.raw[slot] + t * RLD;
  float v[BK];
#pragma unroll
  for (int k = 0; k < BK; k += 16 / (int)sizeof(T)) {
    const uint4 q = *reinterpret_cast<const uint4*>(r + k);
    T w[16 / sizeof(T)];
    __builtin_memcpy(w, &q, 16);
#pragma unroll
    for (int e = 0; e < 16 / (int)sizeof(T); ++e) v[k + e] = float(w[e]);
  }
  float (*dst)[BM + PAD] = t < BM ? sm.kx[buf] : sm.kz[buf];
  const int c = t < BM ? t : t - BM;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    dst[k][c] = v[k];
    sq = fmaf(v[k], v[k], sq);
  }
}

template <typename T, int BM, int BYTES>
__global__ void __launch_bounds__(2 * BM, 2)
kernel(const T* __restrict__ X, const T* __restrict__ Z, T* __restrict__ out,
       int n, int p, int d, int kind, float two_h2, float scale,
       float offset, int degree, int col_tiles, int tiles) {
  constexpr int BN = BM, THREADS = 2 * BM;
  constexpr int TM = 8, TN = BN / 16;
  static_assert(TM * (THREADS / 16) == BM, "8 rows a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, BM>& sm = *reinterpret_cast<Smem<T, BM>*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int kt = max((d + BK - 1) / BK, 1);
  // this block's tiles are blockIdx.x + i gridDim.x; step it of the ring is
  // slab it % kt of its tile it / kt, so the copies of a tile's first slabs
  // overlap the previous tile's last slabs and epilogue
  const int steps = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * kt;
  auto tile_of = [&](int step) {
    return (int64_t)blockIdx.x + (int64_t)(step / kt) * gridDim.x;
  };
  auto stage = [&](int step) {
    const int64_t tile = tile_of(step);
    const int64_t row0 = tile / col_tiles * BM, col0 = tile % col_tiles * BN;
    const int k0 = (step % kt) * BK;
    T* r = sm.raw[step % RAW];
    stage_slab<T, BM, BK, RLD, BYTES, THREADS>(r, X, row0, n, k0, d);
    stage_slab<T, BN, BK, RLD, BYTES, THREADS>(r + BM * RLD, Z, col0, p, k0,
                                               d);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float sq = 0.f;  // |.|^2 of staged row tid (X rows, then Z rows)

  // one commit group a step (empty past the last): steps 0 .. RAW - 1 in
  // flight, then step 0 moved into buffer 0
#pragma unroll
  for (int s = 0; s < RAW; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }
  cp_async_wait<RAW - 1>();
  __syncthreads();
  transpose(sm, 0, 0, sq);

  for (int it = 0; it < steps; ++it) {
    const int cur = it & 1;
    // step it + 1 has landed (the barrier makes every thread's copies and
    // step it's buffer visible); every thread is done with buffer cur ^ 1
    // (step it - 1) and with raw slot it % RAW (moved one iteration ago)
    cp_async_wait<RAW - 2>();
    __syncthreads();
    const bool last = it % kt == kt - 1;  // the tile's last slab
    float sq_next = 0.f;
    if (it + 1 < steps) transpose(sm, (it + 1) % RAW, cur ^ 1, last ? sq_next : sq);
    if (it + RAW < steps) stage(it + RAW);
    cp_async_commit();

#pragma unroll 4  // with the column-outer products below: faster on an
                   // H100 than a full unroll, row-outer
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.kx[cur][k][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int jj = 0; jj < TN / 4; ++jj) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.kz[cur][k][jj * 64 + tx * 4]);
        b[4 * jj] = v.x; b[4 * jj + 1] = v.y; b[4 * jj + 2] = v.z;
        b[4 * jj + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (!last) continue;

    // the tile is done: norms to shared memory, then the fused epilogue
    const int64_t tile = tile_of(it);
    const int64_t row0 = tile / col_tiles * BM, col0 = tile % col_tiles * BN;
    if (tid < BM) {
      sm.xx[tid] = sq;
    } else {
      sm.zz[tid - BM] = sq;
    }
    sq = sq_next;
    __syncthreads();
    // thread (ty, tx) holds rows ty*TM + i and columns jj*64 + tx*4 + e:
    // 16-byte stores where a row's four columns lie inside p
    const bool vec = sizeof(T) == 4 && (p & 3) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int lr = ty * TM + i;
      const int64_t r = row0 + lr;
#pragma unroll
      for (int jj = 0; jj < TN / 4; ++jj) {
        const int lc = jj * 64 + tx * 4;
        const int64_t c = col0 + lc;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = finish(acc[i][4 * jj + e], sm.xx[lr], sm.zz[lc + e], kind,
                        two_h2, scale, offset, degree);
          acc[i][4 * jj + e] = 0.f;
        }
        if (r >= n) continue;
        if (vec && c + 3 < p) {
          *reinterpret_cast<float4*>(out + r * p + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < p) out[r * p + c + e] = T(v[e]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// persistent: one block an SM walks the tiles
template <typename T, int BM, int BYTES>
int launch_tile(const T* X, const T* Z, T* out, int n, int p, int d,
                int kind, double two_h2, double scale, double offset,
                int degree, int sms, cudaStream_t stream) {
  const int64_t row_tiles = (n + BM - 1) / BM;
  const int64_t col_tiles = (p + BM - 1) / BM;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int tiles = (int)(row_tiles * col_tiles);
  auto k = kernel<T, BM, BYTES>;
  constexpr int SMEM = (int)sizeof(Smem<T, BM>);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;
  k<<<grid, 2 * BM, SMEM, stream>>>(X, Z, out, n, p, d, kind, (float)two_h2,
                                    (float)scale, (float)offset, degree,
                                    (int)col_tiles, tiles);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles, or 64 x 64 where those would leave SMs idle (a predict
// batch of 256 rows: 32 tiles of 128, 128 of 64)
template <typename T, int BYTES>
int launch_bytes(const T* X, const T* Z, T* out, int n, int p, int d,
                 int kind, double two_h2, double scale, double offset,
                 int degree, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t big = ((n + 127) / 128) * (int64_t)((p + 127) / 128);
  if (big >= sms)
    return launch_tile<T, 128, BYTES>(X, Z, out, n, p, d, kind, two_h2,
                                      scale, offset, degree, sms, stream);
  return launch_tile<T, 64, BYTES>(X, Z, out, n, p, d, kind, two_h2, scale,
                                   offset, degree, sms, stream);
}

}  // namespace simt

// --------------------------- float64 accumulation: FP64 tensor cores

namespace dmma {

constexpr int BM = 128, BN = 128, BK = 32;
// staged rows padded to 144 (float32), 288 (float64) or 80 (bf16) bytes:
// 16-byte aligned, and the fragment loads hit distinct banks
template <typename T> constexpr int LDT = BK + (sizeof(T) == 2 ? 8 : 4);
constexpr int WARPS_M = 4, WARPS_N = 4, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 32 x 32 a warp
constexpr int MT = WM / 16, NT = WN / 8;             // m16 and n8 tiles
constexpr unsigned FULL = 0xffffffffu;
static_assert(WM == 32 && WN == 32, "a warp's rows are one 32-row mask word");

// slabs in flight: 180 KB (float32), 216 KB (float64) or 140 KB (bf16) of
// shared memory, one block an SM; the copies, not the products, set the
// pace on sparse rows
template <typename T>
constexpr int STAGES = sizeof(T) == 4 ? 5 : sizeof(T) == 8 ? 3 : 7;
// the tile of accumulators in shared memory for the epilogue, rows padded
constexpr int CT_LD = BN + 2;

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES<T> * (BM + BN) * LDT<T> * (int)sizeof(T);
}

// D = A B + D for one m16n8k8 tile; fragments as the PTX ISA lays them out
// for .f64 (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; c = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const T* __restrict__ X, const T* __restrict__ Z, T* __restrict__ out,
       int n, int p, int d, int kind, double two_h2, double scale,
       double offset, int degree, int col_tiles) {
  constexpr int LD = LDT<T>, STAGE = (BM + BN) * LD;
  static_assert(BM * CT_LD * (int)sizeof(double) <= smem_bytes<T>(),
                "the tile of accumulators fits the stages it reuses");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ double xx[BM], zz[BN];
  // bit r of live[h][w]: staged row 32 w + r (X rows, then Z rows) has a
  // non-zero among the slab's k-values 8 h .. 8 h + 7
  __shared__ unsigned live[BK / 8][(BM + BN) / 32];

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(FULL, tid / 32, 0), lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * BM;
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * BN;
  const int kt = (d + BK - 1) / BK;

  double acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
  double sq = 0.0;  // thread t < BM: |x_t|^2; BM <= t < BM + BN: |z_t|^2

  constexpr int S = STAGES<T>;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kt) {
      stage_slab<T, BM, BK, LD, BYTES, THREADS>(sm + s * STAGE, X, row0, n,
                                                s * BK, d);
      stage_slab<T, BN, BK, LD, BYTES, THREADS>(sm + s * STAGE + BM * LD, Z,
                                                col0, p, s * BK, d);
    }
    cp_async_commit();
  }

  for (int it = 0; it < kt; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // slab it visible; slot it - 1 and `live` free
    const int next = it + S - 1;
    if (next < kt) {
      T* st = sm + (next % S) * STAGE;
      stage_slab<T, BM, BK, LD, BYTES, THREADS>(st, X, row0, n, next * BK, d);
      stage_slab<T, BN, BK, LD, BYTES, THREADS>(st + BM * LD, Z, col0, p,
                                                next * BK, d);
    }
    cp_async_commit();

    const T* base = sm + (it % S) * STAGE;
    if (tid < BM + BN) {  // whole warps: thread t owns staged row t
      T v[BK];  // 16-byte loads: rows 144, 288 or 80 bytes apart, no conflicts
#pragma unroll
      for (int k = 0; k < BK; k += 16 / (int)sizeof(T)) {
        const uint4 raw = *reinterpret_cast<const uint4*>(base + tid * LD + k);
        __builtin_memcpy(&v[k], &raw, 16);
      }
      bool nz[BK / 8];
#pragma unroll
      for (int h = 0; h < BK / 8; ++h) nz[h] = false;
#pragma unroll
      for (int k = 0; k < BK; ++k) nz[k / 8] |= !is_zero(v[k]);
      bool any = false;
#pragma unroll
      for (int h = 0; h < BK / 8; ++h) any |= nz[h];
      if (any) {
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const double w = widen<double>(v[k]);
          sq = fma(w, w, sq);
        }
      }
#pragma unroll
      for (int h = 0; h < BK / 8; ++h) {
        const unsigned m = __ballot_sync(FULL, nz[h]);
        if (lane == 0) live[h][warp] = m;
      }
    }
    __syncthreads();  // the masks

    const T* As = base + wm * WM * LD;
    const T* Bs = base + (BM + wn * WN) * LD;
#pragma unroll
    for (int h = 0; h < BK / 8; ++h) {
      // a warp step whose rows of X or of Z are all zero in these 8
      // k-values adds exact zeros: skipped (warp-uniform masks)
      if (live[h][wm] == 0 || live[h][BM / 32 + wn] == 0) continue;
      const int kk = 8 * h;
      double b[NT][2];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const T* q = Bs + (ni * 8 + g) * LD + kk + t;
        b[ni][0] = widen<double>(q[0]);
        b[ni][1] = widen<double>(q[4]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const T* q = As + (mi * 16 + g) * LD + kk + t;
        double a[4];
        a[0] = widen<double>(q[0]);
        a[1] = widen<double>(q[8 * LD]);
        a[2] = widen<double>(q[4]);
        a[3] = widen<double>(q[8 * LD + 4]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma(acc[mi][ni], a, b[ni]);
      }
    }
  }
  cp_async_wait<0>();
  if (tid < BM) {
    xx[tid] = sq;
  } else if (tid < BM + BN) {
    zz[tid - BM] = sq;
  }
  __syncthreads();  // the stages are free: the tile goes through them
  // the accumulators leave registers before the epilogue, whose float64
  // exp is a call that would otherwise keep all 32 of them live across it
  double* ct = reinterpret_cast<double*>(smem_raw);  // [BM][CT_LD]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int lr = wm * WM + mi * 16 + g + 8 * hh;
        const int lc = wn * WN + ni * 8 + 2 * t;
        *reinterpret_cast<double2*>(ct + lr * CT_LD + lc) =
            make_double2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
  __syncthreads();
  // one row of the tile a warp at a time, 32 consecutive columns a step
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int lr = e / BN, lc = e % BN;
    const int64_t r = row0 + lr, c = col0 + lc;
    if (r < n && c < p)
      out[r * p + c] = narrow<T>(finish(ct[lr * CT_LD + lc], xx[lr], zz[lc],
                                        kind, two_h2, scale, offset, degree));
  }
}

template <typename T, int BYTES>
int launch_bytes(const T* X, const T* Z, T* out, int n, int p, int d,
                 int kind, double two_h2, double scale, double offset,
                 int degree, cudaStream_t stream) {
  const int64_t row_tiles = (n + BM - 1) / BM;
  const int64_t col_tiles = (p + BN - 1) / BN;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto k = kernel<T, BYTES>;
  constexpr int SMEM = smem_bytes<T>();
  cudaError_t set = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (set != cudaSuccess) return (int)set;
  k<<<(unsigned)(row_tiles * col_tiles), THREADS, SMEM, stream>>>(
      X, Z, out, n, p, d, kind, two_h2, scale, offset, degree,
      (int)col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace dmma

// -------------------------- bf16 data, float32 accumulation: bf16 tensor cores

namespace hmma {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LD = BK + 8;  // staged rows 80 bytes apart: 16-byte aligned,
                            // fragment words on distinct banks
constexpr int WARPS_M = 2, WARPS_N = 4, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 a warp
constexpr int MT = WM / 16, NT = WN / 8;             // m16 and n8 tiles
constexpr int KS = 16;                               // k of one mma
constexpr int STAGES = 4;
constexpr int STAGE = (BM + BN) * LD;                // bf16 values
constexpr int SMEM = STAGES * STAGE * (int)sizeof(bf16);  // 80 KB: two an SM
// the tile of accumulators in shared memory for the epilogue: rows 136
// floats apart, so a warp's float2 writes of its fragments hit distinct
// banks in each half
constexpr int CT_LD = BN + 8;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == BM + BN, "one thread per staged row");
static_assert(BM * CT_LD * (int)sizeof(float) <= SMEM,
              "the tile of accumulators fits the stages it reuses");
static_assert(WM == 64 && WN == 32, "a warp's rows are whole mask words");

// D = A B + D for one m16n8k16 tile with bf16 operands and float32
// accumulators; fragments as the PTX ISA lays them out (g = lane / 4,
// t = lane % 4, two bf16 a register, the lower k in the low half):
// a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..][g], B[2t+8..][g]; c = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const bf16* q) {
  return *reinterpret_cast<const uint32_t*>(q);
}

template <int BYTES>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const bf16* __restrict__ X, const bf16* __restrict__ Z,
       bf16* __restrict__ out, int n, int p, int d, int kind, float two_h2,
       float scale, float offset, int degree, int col_tiles, bool pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float xx[BM], zz[BN];
  // bit r of live[h][w]: staged row 32 w + r (X rows, then Z rows) has a
  // non-zero among the slab's k-values 16 h .. 16 h + 15
  __shared__ unsigned live[BK / KS][(BM + BN) / 32];

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(FULL, tid / 32, 0), lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * BM;
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * BN;
  const int kt = (d + BK - 1) / BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float sq = 0.f;  // thread t < BM: |x_t|^2; else |z_{t - BM}|^2

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt) {
      stage_slab<bf16, BM, BK, LD, BYTES, THREADS>(sm + s * STAGE, X, row0, n,
                                                   s * BK, d);
      stage_slab<bf16, BN, BK, LD, BYTES, THREADS>(sm + s * STAGE + BM * LD,
                                                   Z, col0, p, s * BK, d);
    }
    cp_async_commit();
  }

  for (int it = 0; it < kt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab it visible; slot it - 1 and `live` free
    const int next = it + STAGES - 1;
    if (next < kt) {
      bf16* st = sm + (next % STAGES) * STAGE;
      stage_slab<bf16, BM, BK, LD, BYTES, THREADS>(st, X, row0, n, next * BK,
                                                   d);
      stage_slab<bf16, BN, BK, LD, BYTES, THREADS>(st + BM * LD, Z, col0, p,
                                                   next * BK, d);
    }
    cp_async_commit();

    const bf16* base = sm + (it % STAGES) * STAGE;
    {  // thread t owns staged row t: its squares (from the upcast values,
       // two bf16 a 32-bit word, the lower k in the low half) and the
       // masks of its non-zero k-steps
      const uint4* row = reinterpret_cast<const uint4*>(base + tid * LD);
      bool nz[BK / KS];
#pragma unroll
      for (int h = 0; h < BK / KS; ++h) nz[h] = false;
#pragma unroll
      for (int q = 0; q < BK / 8; ++q) {
        const uint4 raw = row[q];
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = __uint_as_float(w[e] << 16);
          const float hi = __uint_as_float(w[e] & 0xffff0000u);
          nz[8 * q / KS] |= lo != 0.f || hi != 0.f;
          sq = fmaf(lo, lo, sq);
          sq = fmaf(hi, hi, sq);
        }
      }
#pragma unroll
      for (int h = 0; h < BK / KS; ++h) {
        const unsigned m = __ballot_sync(FULL, nz[h]);
        if (lane == 0) live[h][warp] = m;
      }
    }
    __syncthreads();  // the masks

    const bf16* As = base + wm * WM * LD;
    const bf16* Bs = base + (BM + wn * WN) * LD;
#pragma unroll
    for (int h = 0; h < BK / KS; ++h) {
      // a warp step whose rows of X or of Z are all zero in these 16
      // k-values adds exact zeros: skipped (warp-uniform masks)
      if ((live[h][2 * wm] | live[h][2 * wm + 1]) == 0 ||
          live[h][BM / 32 + wn] == 0)
        continue;
      const int kk = KS * h + 2 * t;
      uint32_t b[NT][2];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const bf16* q = Bs + (ni * 8 + g) * LD + kk;
        b[ni][0] = word(q);
        b[ni][1] = word(q + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const bf16* q = As + (mi * 16 + g) * LD + kk;
        const uint32_t a[4] = {word(q), word(q + 8 * LD), word(q + 8),
                               word(q + 8 * LD + 8)};
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma(acc[mi][ni], a, b[ni]);
      }
    }
  }
  cp_async_wait<0>();
  if (tid < BM) {
    xx[tid] = sq;
  } else {
    zz[tid - BM] = sq;
  }
  __syncthreads();  // every warp is done with the stages: the tile goes
                    // through them, so no accumulator is live in the epilogue
  float* ct = reinterpret_cast<float*>(smem_raw);  // [BM][CT_LD]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int lr = wm * WM + mi * 16 + g + 8 * hh;
        const int lc = wn * WN + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(ct + lr * CT_LD + lc) =
            make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
  __syncthreads();
  // two neighbouring columns a thread, a warp along a row: rounded to bf16
  // once and stored as one 4-byte pair where p is even
  for (int e = tid; e < BM * BN / 2; e += THREADS) {
    const int lr = e / (BN / 2), lc = 2 * (e % (BN / 2));
    const int64_t r = row0 + lr, c = col0 + lc;
    if (r >= n) continue;
    const float v0 = finish(ct[lr * CT_LD + lc], xx[lr], zz[lc], kind, two_h2,
                            scale, offset, degree);
    const float v1 = finish(ct[lr * CT_LD + lc + 1], xx[lr], zz[lc + 1], kind,
                            two_h2, scale, offset, degree);
    bf16* o = out + r * p + c;
    if (pairs && c + 1 < p) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (c < p) o[0] = __float2bfloat16_rn(v0);
      if (c + 1 < p) o[1] = __float2bfloat16_rn(v1);
    }
  }
}

template <int BYTES>
int launch_bytes(const bf16* X, const bf16* Z, bf16* out, int n, int p, int d,
                 int kind, double two_h2, double scale, double offset,
                 int degree, cudaStream_t stream) {
  const int64_t row_tiles = (n + BM - 1) / BM;
  const int64_t col_tiles = (p + BN - 1) / BN;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto k = kernel<BYTES>;
  cudaError_t set =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (set != cudaSuccess) return (int)set;
  const bool pairs =
      p % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  k<<<(unsigned)(row_tiles * col_tiles), THREADS, SMEM, stream>>>(
      X, Z, out, n, p, d, kind, (float)two_h2, (float)scale, (float)offset,
      degree, (int)col_tiles, pairs);
  return (int)cudaGetLastError();
}

}  // namespace hmma

// The widest copy (16, 8 or 4 bytes, at least one element, at most MAX)
// that divides a row of d values and both base addresses.
template <typename T>
int copy_bytes(const void* X, const void* Z, int d, int max_bytes) {
  for (int b = max_bytes; b >= (int)sizeof(T); b /= 2) {
    const bool rows = ((int64_t)d * (int64_t)sizeof(T)) % b == 0;
    const bool base = reinterpret_cast<uintptr_t>(X) % b == 0 &&
                      reinterpret_cast<uintptr_t>(Z) % b == 0;
    if (rows && base) return b;
  }
  return 0;
}

template <typename T>
int launch_simt(const void* X, const void* Z, void* out, int n, int p, int d,
                int kind, double two_h2, double scale, double offset,
                int degree, cudaStream_t s) {
  const T* x = static_cast<const T*>(X);
  const T* z = static_cast<const T*>(Z);
  T* o = static_cast<T*>(out);
  const int b = copy_bytes<T>(X, Z, d, 16);
  if (b == 16)
    return simt::launch_bytes<T, 16>(x, z, o, n, p, d, kind, two_h2, scale,
                                     offset, degree, s);
  if (b == 8)
    return simt::launch_bytes<T, 8>(x, z, o, n, p, d, kind, two_h2, scale,
                                    offset, degree, s);
  if constexpr (sizeof(T) == 4) {
    if (b == 4)
      return simt::launch_bytes<T, 4>(x, z, o, n, p, d, kind, two_h2, scale,
                                      offset, degree, s);
  }
  return (int)cudaErrorMisalignedAddress;
}

template <typename T>
int launch_dmma(const void* X, const void* Z, void* out, int n, int p, int d,
                int kind, double two_h2, double scale, double offset,
                int degree, cudaStream_t s) {
  const T* x = static_cast<const T*>(X);
  const T* z = static_cast<const T*>(Z);
  T* o = static_cast<T*>(out);
  const int b = copy_bytes<T>(X, Z, d, 16);
  if (b == 16)
    return dmma::launch_bytes<T, 16>(x, z, o, n, p, d, kind, two_h2, scale,
                                     offset, degree, s);
  if (b == 8)
    return dmma::launch_bytes<T, 8>(x, z, o, n, p, d, kind, two_h2, scale,
                                    offset, degree, s);
  if constexpr (sizeof(T) <= 4) {
    if (b == 4)
      return dmma::launch_bytes<T, 4>(x, z, o, n, p, d, kind, two_h2, scale,
                                      offset, degree, s);
  }
  if constexpr (sizeof(T) == 2) {
    if (b == 2)
      return dmma::launch_bytes<T, 2>(x, z, o, n, p, d, kind, two_h2, scale,
                                      offset, degree, s);
  }
  return (int)cudaErrorMisalignedAddress;
}

// bf16 rows of 90 values (180 bytes) take 4-byte copies, rows of odd length
// 2-byte ones
int launch_hmma(const void* X, const void* Z, void* out, int n, int p, int d,
                int kind, double two_h2, double scale, double offset,
                int degree, cudaStream_t s) {
  const bf16* x = static_cast<const bf16*>(X);
  const bf16* z = static_cast<const bf16*>(Z);
  bf16* o = static_cast<bf16*>(out);
  switch (copy_bytes<bf16>(X, Z, d, 16)) {
    case 16:
      return hmma::launch_bytes<16>(x, z, o, n, p, d, kind, two_h2, scale,
                                    offset, degree, s);
    case 8:
      return hmma::launch_bytes<8>(x, z, o, n, p, d, kind, two_h2, scale,
                                   offset, degree, s);
    case 4:
      return hmma::launch_bytes<4>(x, z, o, n, p, d, kind, two_h2, scale,
                                   offset, degree, s);
    case 2:
      return hmma::launch_bytes<2>(x, z, o, n, p, d, kind, two_h2, scale,
                                   offset, degree, s);
    default:
      return (int)cudaErrorMisalignedAddress;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = bf16; acc: 0 = float32, 1 =
// float64. Returns cudaGetLastError() after the launch (0 on success); the
// kernel runs on `stream` of device `device`.
extern "C" int kernel_block_launch(const void* X, const void* Z, void* out,
                                   int n, int p, int d, int dtype, int acc,
                                   int kind, double two_h2, double scale,
                                   double offset, int degree, int device,
                                   void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n <= 0 || p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc == 0 && dtype == 0)
    return launch_simt<float>(X, Z, out, n, p, d, kind, two_h2, scale,
                              offset, degree, s);
  if (acc == 0 && dtype == 1)
    return launch_simt<double>(X, Z, out, n, p, d, kind, two_h2, scale,
                               offset, degree, s);
  if (acc == 1 && dtype == 0)
    return launch_dmma<float>(X, Z, out, n, p, d, kind, two_h2, scale,
                              offset, degree, s);
  if (acc == 1 && dtype == 1)
    return launch_dmma<double>(X, Z, out, n, p, d, kind, two_h2, scale,
                               offset, degree, s);
  if (acc == 0 && dtype == 2)
    return launch_hmma(X, Z, out, n, p, d, kind, two_h2, scale, offset,
                       degree, s);
  if (acc == 1 && dtype == 2)
    return launch_dmma<bf16>(X, Z, out, n, p, d, kind, two_h2, scale,
                             offset, degree, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
