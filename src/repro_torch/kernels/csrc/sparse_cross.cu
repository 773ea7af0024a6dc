// K3 sparse_cross: k(X_csr, Z) in R^{n_rows x p} for a CSR row block X
// (data, indices, indptr) and a landmark block Z (p, d), given once per Z
// as a prepared set of landmarks (kernels/sparse_block.py, SparseLandmarks).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_block.py::
// _sparse_cross_pallas (body _pallas_tile_body; entry points sparse_cross
// and sparse_kernel_block, whose rbf/poly epilogue and row norms were XLA
// code around it). Kinds: 0 rbf    exp(-max(|x|^2 + |z|^2 - 2 x.z, 0) / 2h^2)
//                         1 linear x.z
//                         2 poly   (x.z / scale + offset)^degree
//
// What bounds it. A product x_i . z_j only needs the stored values of x_i
// whose column is non-zero in z_j. On the sparse path Z is itself a set of
// TF-IDF rows, densified: at the RCV1-shaped cell 0.16 % of its entries
// are non-zero, and the work that meets a non-zero of Z,
// 2 * sum_c nnz_X(c) * nnz_Z(c), is 13 % of the dense count 2 * nnz * p.
// Gathering a slab of Z^T for every stored value instead would move
// nnz * p * 4 bytes (80 GB a chunk) through L2, almost all of it zeros.
// Bound on an H100 SXM: the work above plus the epilogue, 5 * n_rows * p,
// at the 67 TFLOP/s float64 rate, or the CSR block, the prepared landmarks
// and the output at 3.35 TB/s, whichever is larger (at one chunk of the
// cell the output, 0.32 ms, sets it).
//
// Design. The landmarks are prepared once per Z (per fit), split by feature
// column c into
//  * hot columns, the ones with the most non-zeros in Z (80 in float64
//    accumulation, 127 in float32: the slab fits HOT_BYTES): a dense table
//    (H, ld) of Z^T rows in the accumulation type, whose slab a block stages
//    in shared memory once;
//  * the other columns: Z's non-zeros in compressed columns (CSC), one list
//    per (column, slab) of (landmark, value) pairs.
// A block of 32 warps owns one slab of SLAB = 256 landmark columns and
// ROWS_PER_BLOCK rows, one warp per row at a time (one block an SM). A warp
// walks its rows as one stream of batches of 32 stored values, loading the
// next batch's (column, value) pairs while it applies the current one, and
// looks up each value's hot slot or list. Then:
//  * the hot values, in CSR order, add v * table[slot] to the warp's
//    register accumulators (each lane owns 8 landmark columns, 16-byte loads
//    from shared memory);
//  * the other values' list entries, flattened in CSR order, are taken 32
//    at a time, one a lane (a lane finds its entry's value by a binary
//    search over the lists' prefix sums; the next 32 load while these
//    apply), and scatter v * z into a per-warp accumulator in shared memory
//    (SLAB values): lanes on the same landmark (__match_any_sync) add in
//    lane order, that is in CSR order, one a round.
// The two accumulators are summed at the end: each is summed in CSR order,
// but not the two together, so the result differs from a single CSR-order
// sum by float rounding; it depends only on the row and on Z (no atomics,
// a split chosen from Z alone), so chunked and in-memory fits agree
// exactly. Zeros of Z are skipped in the lists and multiplied in the hot
// table. |x|^2 comes from the row's values (a warp reduction), |z|^2 from
// the norm kernel at preparation; the epilogue is fused into the one store
// per output element. Empty rows give k(0, z); slots at or past
// indptr[n_rows] (padding) are never read. Float32 arithmetic is IEEE fma,
// never TF32.
//
// bf16 values (the reference's bf16 CSR chunks: values and landmarks in
// bf16, accumulated in the caller's acc_dtype, float32 by the bf16 rule):
// the same kernel on a bf16 values array. The prepared landmarks are in the
// accumulation type already, and bf16 values widen exactly, so the sums
// are the float32 build's; |x|^2 is summed from the upcast values. Where
// the block dtype is narrower than the accumulation, |x|^2 and the cross
// product are rounded to the block dtype before the epilogue, as the
// reference's sparse_row_sqnorms and sparse_kernel_block round them, and
// the epilogue's value is rounded again (to nearest even) as it is stored.
#include "tile.cuh"

namespace {

using repro_tile::bf16;
using repro_tile::narrow;
using repro_tile::widen;
using repro_tile::zero_of;

constexpr int LANES = 32;
constexpr int WARPS = 32;              // rows in flight per block
constexpr int SLAB = 256;              // landmark columns per block
constexpr int ROWS_PER_BLOCK = 2048;
// the hot table's slab in shared memory, one block an SM: 80 float64
// columns, or float32 ones up to MAX_HOT
constexpr int HOT_BYTES = 160 * 1024;
constexpr int MAX_HOT = 127;           // hot_slot is int8

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// 16 bytes of Acc per lane per load
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using V = float4;
  __device__ static void get(const V& v, float (&x)[4]) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Vec<double> {
  static constexpr int N = 2;
  using V = double2;
  __device__ static void get(const V& v, double (&x)[2]) {
    x[0] = v.x; x[1] = v.y;
  }
  __device__ static V zero() { return make_double2(0.0, 0.0); }
};

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc s) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// zz[j] = |z_j|^2 for the rows of Z (p, d), one warp per row.
template <typename T, typename Acc>
__global__ void __launch_bounds__(8 * LANES)
row_sqnorm_kernel(const T* __restrict__ Z, int p, int d,
                  Acc* __restrict__ zz) {
  const int lane = threadIdx.x % LANES;
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / LANES;
  if (row >= p) return;
  const T* z = Z + row * d;
  Acc s = Acc(0);
  for (int k = lane; k < d; k += LANES) {
    const Acc v = widen<Acc>(z[k]);
    s = fma_(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) zz[row] = s;
}

// hot_slot[c]: the column's row of the hot table, or -1; colptr[c * slabs +
// s] .. colptr[c * slabs + s + 1]: the (ent_j, ent_z) pairs of column c in
// slab s (ent_j local to the slab); hot: (n_hot, ld) table, zero past p.
template <typename T, typename Acc>
__global__ void __launch_bounds__(WARPS * LANES, 1)
sparse_cross_kernel(const T* __restrict__ data,
                    const int* __restrict__ indices,
                    const int* __restrict__ indptr,
                    const signed char* __restrict__ hot_slot,
                    const Acc* __restrict__ hot, int n_hot,
                    const int* __restrict__ colptr,
                    const int* __restrict__ ent_j,
                    const Acc* __restrict__ ent_z,
                    const Acc* __restrict__ zz, T* __restrict__ out,
                    int n_rows, int p, int ld, int slabs, int kind,
                    Acc two_h2, Acc scale, Acc offset, int degree) {
  using V = typename Vec<Acc>::V;
  constexpr int E = Vec<Acc>::N;               // columns per 16-byte load
  constexpr int R = SLAB / (LANES * E);        // loads per lane per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % LANES;
  const int warp = __shfl_sync(FULL, (int)threadIdx.x / LANES, 0);
  Acc* tab = reinterpret_cast<Acc*>(smem_raw);          // [n_hot][SLAB]
  Acc* other = tab + (n_hot + warp) * SLAB;             // [SLAB], this warp
  const int s = blockIdx.y;
  const int c0 = s * SLAB;

  for (int e = threadIdx.x; e < n_hot * (SLAB / E); e += WARPS * LANES) {
    const int h = e / (SLAB / E), c = (e % (SLAB / E)) * E;
    *reinterpret_cast<V*>(tab + h * SLAB + c) =
        *reinterpret_cast<const V*>(hot + (int64_t)h * ld + c0 + c);
  }
  __syncthreads();

  const int64_t first = (int64_t)blockIdx.x * ROWS_PER_BLOCK;
  const int64_t last = min((int64_t)n_rows, first + ROWS_PER_BLOCK);
  // the warp's rows first + warp, + WARPS, ... as one stream of batches of
  // 32 stored values; the next batch's (column, value) pairs are loaded
  // while this one is applied, across the rows' ends too
  int64_t row = first + warp;
  int lo = 0, hi = 0, base = 0, pcol = 0;
  T pval = zero_of<T>();
  if (row < last) {
    lo = indptr[row];
    hi = indptr[row + 1];
    base = lo;
    if (base + lane < hi) {
      pcol = __ldg(indices + base + lane);
      pval = __ldg(data + base + lane);
    }
  }
  Acc acc[R][E];
  Acc sq = Acc(0);
  bool fresh = true;  // the batch starts a row
  while (row < last) {
    if (fresh) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = Acc(0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<V*>(other + r * LANES * E + lane * E) =
            Vec<Acc>::zero();
      sq = Acc(0);
      __syncwarp();
    }
    const bool valid = base + lane < hi;
    const int col = pcol;
    const Acc v = valid ? widen<Acc>(pval) : Acc(0);
    // the next batch: the rest of this row, or the warp's next row
    int64_t nrow = row;
    int nlo = lo, nhi = hi, nbase = base + LANES;
    const bool row_done = nbase >= hi;
    if (row_done) {
      nrow = row + WARPS;
      if (nrow < last) {
        nlo = indptr[nrow];
        nhi = indptr[nrow + 1];
      }
      nbase = nlo;
    }
    if (nrow < last && nbase + lane < nhi) {
      pcol = __ldg(indices + nbase + lane);
      pval = __ldg(data + nbase + lane);
    }
    {
      // 32 values of the row, one a lane: info = ~slot for a hot column,
      // else the length of the column's list [a, a + info) in this slab
      int info = 0, a = 0;
      if (valid) {
        sq = fma_(v, v, sq);
        const int h = hot_slot[col];
        if (h >= 0) {
          info = ~h;
        } else {
          const int* cp = colptr + (int64_t)col * slabs + s;
          a = __ldg(cp);
          info = __ldg(cp + 1) - a;
        }
      }
      // hot values, in CSR order, into the register accumulators
      unsigned hot = __ballot_sync(FULL, info < 0);
      while (hot != 0) {
        const int j = __ffs(hot) - 1;
        hot &= hot - 1;
        const Acc vj = __shfl_sync(FULL, v, j);
        const Acc* zr = tab + (~__shfl_sync(FULL, info, j)) * SLAB + lane * E;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          Acc z[E];
          Vec<Acc>::get(*reinterpret_cast<const V*>(zr + r * LANES * E), z);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fma_(vj, z[e], acc[r][e]);
        }
      }
      // the other values' list entries, flattened in CSR order and taken
      // 32 at a time, one a lane; the next 32 are loaded while these are
      // applied
      const int cnt = info > 0 ? info : 0;
      int off = cnt;
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) {
        const int y = __shfl_up_sync(FULL, off, o);
        if (lane >= o) off += y;
      }
      const int total = __shfl_sync(FULL, off, LANES - 1);
      off -= cnt;  // exclusive: value t's entries are [off_t, off_t + cnt_t)
      // entry e of the batch: the last value t with off_t <= e holds it
      auto fetch = [&](int e, int& jl, Acc& z, Acc& vt) {
        int t = 0;
#pragma unroll
        for (int step = LANES / 2; step > 0; step >>= 1)
          if (__shfl_sync(FULL, off, t + step) <= e) t += step;
        const int src = __shfl_sync(FULL, a, t) + e - __shfl_sync(FULL, off, t);
        vt = __shfl_sync(FULL, v, t);
        jl = -1 - lane;  // matches no other lane
        z = Acc(0);
        if (e < total) {
          jl = __ldg(ent_j + src);
          z = __ldg(ent_z + src);
        }
      };
      int jl = 0;
      Acc z = Acc(0), vt = Acc(0);
      if (total > 0) fetch(lane, jl, z, vt);
      for (int e0 = 0; e0 < total; e0 += LANES) {
        int jn = 0;
        Acc zn = Acc(0), vn = Acc(0);
        if (e0 + LANES < total) fetch(e0 + LANES + lane, jn, zn, vn);
        // lanes on one landmark add in lane order (CSR order), one a round
        const unsigned grp = __match_any_sync(FULL, jl);
        const int rank = __popc(grp & ((1u << lane) - 1));
        const int rounds = __reduce_max_sync(FULL, (unsigned)rank) + 1;
        for (int q = 0; q < rounds; ++q) {
          if (jl >= 0 && rank == q) other[jl] = fma_(vt, z, other[jl]);
          __syncwarp();
        }
        jl = jn;
        z = zn;
        vt = vn;
      }
    }
    if (row_done) {
      // |x|^2 and the cross product rounded to the block dtype before the
      // epilogue, as the reference's sparse_row_sqnorms and
      // sparse_kernel_block round them
      Acc sqr = warp_sum(sq);
      if constexpr (!std::is_same_v<T, Acc>) sqr = widen<Acc>(narrow<T>(sqr));
      __syncwarp();
      T* orow = out + row * p;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int lc = r * LANES * E + lane * E + e;
          const int c = c0 + lc;
          if (c >= p) continue;
          Acc val = acc[r][e] + other[lc];
          if constexpr (!std::is_same_v<T, Acc>) {
            if (kind != 1) val = widen<Acc>(narrow<T>(val));
          }
          if (kind == 0) {
            Acc d2 = sqr + zz[c] - Acc(2) * val;
            d2 = d2 > Acc(0) ? d2 : Acc(0);
            val = exp_(-d2 / two_h2);
          } else if (kind == 2) {
            const Acc bb = val / scale + offset;
            Acc pw = Acc(1);
            for (int q = 0; q < degree; ++q) pw *= bb;
            val = pw;
          }
          orow[c] = narrow<T>(val);
        }
      }
      __syncwarp();  // this row's reads of `other` before the next row's
    }
    fresh = row_done;
    row = nrow;
    lo = nlo;
    hi = nhi;
    base = nbase;
  }
}

template <typename Acc>
constexpr int smem_bytes(int n_hot) {
  return (n_hot + WARPS) * SLAB * (int)sizeof(Acc);
}

template <typename T, typename Acc>
int launch(const void* data, const void* indices, const void* indptr,
           const void* hot_slot, const void* hot, int n_hot,
           const void* colptr, const void* ent_j, const void* ent_z,
           const void* zz, void* out, int n_rows, int p, int ld, int kind,
           double two_h2, double scale, double offset, int degree,
           cudaStream_t stream) {
  if (ld % SLAB != 0 || ld < p || n_hot < 0 || n_hot > MAX_HOT ||
      n_hot * SLAB * (int)sizeof(Acc) > HOT_BYTES)
    return (int)cudaErrorInvalidValue;
  const int64_t row_blocks =
      ((int64_t)n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int slabs = ld / SLAB;
  if (row_blocks > 2147483647LL || slabs > 65535)
    return (int)cudaErrorInvalidValue;
  auto k = sparse_cross_kernel<T, Acc>;
  const int smem = smem_bytes<Acc>(n_hot);
  cudaError_t set = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)row_blocks, (unsigned)slabs);
  k<<<grid, WARPS * LANES, smem, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(indices),
      static_cast<const int*>(indptr),
      static_cast<const signed char*>(hot_slot),
      static_cast<const Acc*>(hot), n_hot, static_cast<const int*>(colptr),
      static_cast<const int*>(ent_j), static_cast<const Acc*>(ent_z),
      static_cast<const Acc*>(zz), static_cast<T*>(out), n_rows, p, ld,
      slabs, kind, Acc(two_h2), Acc(scale), Acc(offset), degree);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int sqnorms(const void* Z, int p, int d, void* zz, cudaStream_t stream) {
  row_sqnorm_kernel<T, Acc><<<(unsigned)((p + 7) / 8), 8 * LANES, 0,
                              stream>>>(static_cast<const T*>(Z), p, d,
                                        static_cast<Acc*>(zz));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = bf16; acc: 0 = float32, 1 =
// float64. The landmark arrays are those of
// one prepared Z (sparse_block.SparseLandmarks); ld is p padded to whole slabs.
// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs on `stream` of device `device`.
extern "C" int sparse_cross_launch(
    const void* data, const void* indices, const void* indptr,
    const void* hot_slot, const void* hot, int n_hot, const void* colptr,
    const void* ent_j, const void* ent_z, const void* zz, void* out,
    int n_rows, int p, int ld, int dtype, int acc, int kind, double two_h2,
    double scale, double offset, int degree, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_rows <= 0 || p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_ARGS                                                            \
  data, indices, indptr, hot_slot, hot, n_hot, colptr, ent_j, ent_z, zz, \
      out, n_rows, p, ld, kind, two_h2, scale, offset, degree, s
  if (dtype == 0 && acc == 0) return launch<float, float>(K3_ARGS);
  if (dtype == 0 && acc == 1) return launch<float, double>(K3_ARGS);
  if (dtype == 1 && acc == 0) return launch<double, float>(K3_ARGS);
  if (dtype == 1 && acc == 1) return launch<double, double>(K3_ARGS);
  if (dtype == 2 && acc == 0) return launch<bf16, float>(K3_ARGS);
  if (dtype == 2 && acc == 1) return launch<bf16, double>(K3_ARGS);
#undef K3_ARGS
  return (int)cudaErrorInvalidValue;
}

// zz[j] = |z_j|^2 in the accumulation type, for the preparation of Z.
extern "C" int sparse_sqnorms_launch(const void* Z, int p, int d, int dtype,
                                     int acc, void* zz, int device,
                                     void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && acc == 0) return sqnorms<float, float>(Z, p, d, zz, s);
  if (dtype == 0 && acc == 1) return sqnorms<float, double>(Z, p, d, zz, s);
  if (dtype == 1 && acc == 0) return sqnorms<double, float>(Z, p, d, zz, s);
  if (dtype == 1 && acc == 1) return sqnorms<double, double>(Z, p, d, zz, s);
  if (dtype == 2 && acc == 0) return sqnorms<bf16, float>(Z, p, d, zz, s);
  if (dtype == 2 && acc == 1) return sqnorms<bf16, double>(Z, p, d, zz, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sparse_cross_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
