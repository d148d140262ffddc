// Streaming rank count for Hopper (sm_90a), f32 and its lowp branch.
//
// Replaces cmhse_tpu/ops/pallas_sim.py:_rankcount_kernel, both branches as a
// template flag: f32, and `lowp` (precision="bfloat16": both operands
// rounded to bf16, f32 accumulation). For each query q it counts the gallery
// rows n with
//
//   s = <queries[q], gallery[n]> > pos[q]  &&  valid[n]  &&  n != posidx[q]
//
// without ever writing the [Q, N] similarity block to device memory. The
// positive's own column is excluded by index, so a last-bit difference
// between this product and the caller's separately reduced pos[q] can never
// count the positive against itself. pos + 1 and the NaN-positive rule stay
// in the wrapper.
//
// Design. The grid is (query tiles) x (gallery splits). A block owns BM
// queries and walks over every BN-row gallery tile of its split. Each tile's
// BM x BN scores come from a shared-memory-tiled f32 FFMA product over D:
// BK-deep slabs of both operands are staged k-major in shared memory (double
// buffered; the next slab is fetched into registers with 16-byte loads while
// the current one is multiplied), and each thread keeps an 8 x 8 block of
// scores in registers, fed by two 16-byte shared loads per operand per k —
// one shared load per 16 FMAs. The epilogue compares, masks and adds to
// per-thread counts kept in registers across tiles. At the end the block
// sums its counts per query in shared memory and issues one integer
// atomicAdd per query into counts[Q] (zeroed by the wrapper). Integer
// addition is order-free, so the result does not depend on scheduling.
// Ragged Q and N are masked in the kernel; D must be a multiple of 4 and the
// operands 16-byte aligned (the wrapper checks).
//
// lowp rounds each operand to bf16 (nearest even) where its slab is staged
// into shared memory, once per element per tile, and keeps the f32 FMAs: a
// product of two bf16 values is exact in f32, so this is the TPU branch's
// "bf16 multiplies, f32 accumulate" up to summation order. The inputs stay
// f32 in memory, as the TPU kernel takes them. On this card the branch
// saves nothing (same FMAs, same bytes; the rounding costs ~17% more time,
// PERF.md); it exists for the TPU's counts.
//
// What bounds it on an H100: the 2*Q*N*D FLOPs (2.1e11 at Q=1024, N=100k,
// D=1024; 3.1 ms at the 67 TFLOP/s f32 peak). The gallery is read once per
// query tile (Q/BM times), mostly from L2, far below the compute time at
// these shapes. Plain FFMA tiling stops short of the peak (issue slots for
// shared loads and address math); tensor cores would need tf32 or bf16
// inputs, which changes the counts, so they are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // queries per block
constexpr int BN = 128;  // gallery rows per tile
constexpr int BK = 8;    // depth of one shared-memory slab
constexpr int NT = 256;  // threads: a 16 x 16 grid, 8 x 8 scores each
static_assert(BM * BK == 4 * NT && BN * BK == 4 * NT, "one float4 per thread");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Fetch one BK-deep slab of 128 rows starting at row0 / depth k0: thread t
// loads row t / 2, depths k0 + 4 * (t % 2) .. + 3. Rows past `rows` and
// depths past D read as 0. kLowp rounds the values to bf16.
template <bool kLowp>
__device__ __forceinline__ float4 load_slab(const float* __restrict__ src,
                                            int row0, int rows, int k0, int D,
                                            int tid) {
  const int r = row0 + tid / 2;
  const int k = k0 + 4 * (tid % 2);
  if (r < rows && k < D) {
    float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D + k));
    if constexpr (kLowp)
      v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                      round_bf16(v.w));
    return v;
  }
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void store_slab(float (*dst)[BM], float4 v,
                                           int tid) {
  const int r = tid / 2;
  const int k = 4 * (tid % 2);
  dst[k + 0][r] = v.x;
  dst[k + 1][r] = v.y;
  dst[k + 2][r] = v.z;
  dst[k + 3][r] = v.w;
}

template <bool kLowp>
__global__ void __launch_bounds__(NT, 2)
rankcount_kernel(const float* __restrict__ q,         // [Q, D]
                 const float* __restrict__ g,         // [N, D]
                 const float* __restrict__ pos,       // [Q]
                 const int32_t* __restrict__ posidx,  // [Q] or null
                 const uint8_t* __restrict__ gvalid,  // [N] or null
                 int32_t* __restrict__ counts,        // [Q], zeroed
                 int Q, int N, int D) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ int block_counts[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // gallery columns 4*tx + {0..3} and 64 + 4*tx + ..
  const int ty = tid / 16;  // query rows 4*ty + {0..3} and 64 + 4*ty + ..
  const int q0 = blockIdx.x * BM;

  // a query row past Q gets pos = +inf: no score is greater, it counts 0
  float my_pos[8];
  int my_posidx[8];
  int my_counts[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + (i / 4) * 64 + 4 * ty + (i % 4);
    my_pos[i] = qi < Q ? pos[qi] : INFINITY;
    my_posidx[i] = (qi < Q && posidx != nullptr) ? posidx[qi] : -1;
    my_counts[i] = 0;
  }

  const int n_tiles = (N + BN - 1) / BN;
  const int n_slabs = (D + BK - 1) / BK;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int n0 = tile * BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float4 a_next = load_slab<kLowp>(q, q0, Q, 0, D, tid);
    float4 b_next = load_slab<kLowp>(g, n0, N, 0, D, tid);
    __syncthreads();  // the previous tile's last reads of buffer 0 are done
    store_slab(As[0], a_next, tid);
    store_slab(Bs[0], b_next, tid);
    __syncthreads();
    for (int s = 0; s < n_slabs; ++s) {
      const int cur = s % 2;
      if (s + 1 < n_slabs) {
        a_next = load_slab<kLowp>(q, q0, Q, (s + 1) * BK, D, tid);
        b_next = load_slab<kLowp>(g, n0, N, (s + 1) * BK, D, tid);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][4 * ty]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[cur][k][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[cur][k][64 + 4 * tx]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (s + 1 < n_slabs) {
        // the other buffer was last read in slab s - 1, before the barrier
        // that ended it
        store_slab(As[cur ^ 1], a_next, tid);
        store_slab(Bs[cur ^ 1], b_next, tid);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ni = n0 + (j / 4) * 64 + 4 * tx + (j % 4);
      const bool n_ok = ni < N && (gvalid == nullptr || gvalid[ni] != 0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (n_ok && ni != my_posidx[i] && acc[i][j] > my_pos[i])
          ++my_counts[i];
      }
    }
  }

  if (tid < BM) block_counts[tid] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (my_counts[i])
      atomicAdd(&block_counts[(i / 4) * 64 + 4 * ty + (i % 4)], my_counts[i]);
  __syncthreads();
  if (tid < BM) {
    const int qi = q0 + tid;
    if (qi < Q && block_counts[tid]) atomicAdd(&counts[qi], block_counts[tid]);
  }
}

}  // namespace

// splits: how many blocks share one query tile's gallery (grid.y); lowp:
// the bf16-multiply branch.
extern "C" int cmhse_rankcount(const float* q, const float* g, const float* pos,
                               const int32_t* posidx, const uint8_t* gvalid,
                               int32_t* counts, int Q, int N, int D,
                               int splits, int lowp, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || D % 4 != 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + BM - 1) / BM, splits);
  if (lowp)
    rankcount_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        q, g, pos, posidx, gvalid, counts, Q, N, D);
  else
    rankcount_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        q, g, pos, posidx, gvalid, counts, Q, N, D);
  return (int)cudaGetLastError();
}

extern "C" int cmhse_rankcount_tile_rows() { return BN; }
extern "C" int cmhse_rankcount_tile_queries() { return BM; }
