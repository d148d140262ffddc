// Hardest negatives of the max-of-hinges loss for Hopper (sm_90a), f32, both
// directions in one launch.
//
// Replaces cmhse_tpu/ops/pallas_sim.py:_simhinge_row_kernel, which the JAX
// package runs twice (_simhinge_forward: (A, B, neg) and (B, A, neg^T)). With
// S = A B^T for A [M, D] and B [N, D]:
//
//   row logit[i, j] = neg[i, j] ? margin + S[i, j] - row_diag[i] : -1e30
//   col logit[i, j] = neg[i, j] ? margin + S[i, j] - col_diag[j] : -1e30
//   row_max[i] = max_j row logit   row_arg[i] = its earliest j
//   col_max[j] = max_i col logit   col_arg[j] = its earliest i
//
// The second JAX pass is the column view of the same S, so one tile of S
// serves both directions and the mask is read once, never transposed. A row
// or column with no negative gets -1e30 and index 0, as the JAX kernel's
// _NEG_INF and argmax do. S never leaves the chip.
//
// Design. A 2-D grid of 32 x 32 output tiles (256 blocks at 512 x 512, 4 at
// 64 x 64). Each block stages 32-deep slabs of its 32 rows of A and 32 rows
// of B k-major in shared memory, double-buffered (the next slab's loads are
// in flight while the current one is multiplied), and each of its 64 threads
// accumulates a 4 x 4 block of S with f32 FFMAs: two 16-byte shared loads
// per 16 FMAs, broadcast across the warp. No depth limit: only slabs are
// staged. The epilogue forms both logits and folds the tile into a
// (max, earliest index) per row (warp shuffles: a tile row lies in one
// warp) and per column (shuffles, then the two warps through shared
// memory), and merges each into the global result with one 64-bit atomicMax
// per row and per column of the tile. The key holds the float's
// order-preserving bits in its high word and 0xFFFFFFFF - index in its low
// word, so the larger value wins and, on equal values, the lower index:
// jnp.argmax's rule. The merge commutes, so the result does not depend on
// the order blocks finish in. The wrapper zero-fills the keys (every real
// key is above 0); finishing is a second tiny kernel in this file that
// decodes them into f32 maxima and int32 indices.
//
// What bounds it on an H100: at the training shapes (M = N = 64 or 512,
// D = 1024) the 2*M*N*D FLOPs take 0.13-8 us at the f32 peak and the bytes
// (A, B, the byte mask, the outputs) 0.2-1.4 us, so the bound is the FLOPs.
// At 512 x 512 the 256 blocks put two 2-warp blocks on each SM, one warp per
// scheduler, so the FFMA chains' latency is hidden only by each thread's 16
// independent accumulators; at 64 x 64 the 4 blocks leave most SMs idle and
// the launch dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // rows of A and of B (columns of S) per block
constexpr int kBK = 32;       // depth of a staged slab
constexpr int kThreads = 64;  // 8 x 8 threads, each a 4 x 4 block of S
constexpr float kNegInf = -1e30f;

typedef unsigned long long Key;

__device__ __forceinline__ Key make_key(float v, int idx) {
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (Key)(0xFFFFFFFFu - (unsigned int)idx);
}

__device__ __forceinline__ Key key_max(Key a, Key b) { return a > b ? a : b; }

// One slab of 32 rows x 32 depths as 4 float4 a thread: thread t loads row
// (t + 64 p) % 32 at depths 4 * ((t + 64 p) / 32) .. + 3. Rows past `rows`
// and depths past D read as 0 (D is a multiple of 4).
__device__ __forceinline__ void load_slab(float4 (&v)[4],
                                          const float* __restrict__ src,
                                          int row0, int rows, int k0, int D,
                                          int tid) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int f = tid + kThreads * p;
    const int r = row0 + f % kTile;
    const int k = k0 + 4 * (f / kTile);
    v[p] = (r < rows && k < D)
               ? __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D +
                                                      k))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ void store_slab(float (*dst)[kTile],
                                           const float4 (&v)[4], int tid) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int f = tid + kThreads * p;
    const int r = f % kTile;
    const int k = 4 * (f / kTile);
    dst[k + 0][r] = v[p].x;
    dst[k + 1][r] = v[p].y;
    dst[k + 2][r] = v[p].z;
    dst[k + 3][r] = v[p].w;
  }
}

__global__ void __launch_bounds__(kThreads)
simhinge_pair_kernel(const float* __restrict__ a,         // [M, D]
                     const float* __restrict__ b,         // [N, D]
                     const uint8_t* __restrict__ mask,    // [M, N]
                     const float* __restrict__ row_diag,  // [M]
                     const float* __restrict__ col_diag,  // [N]
                     Key* __restrict__ keys,              // [M + N], zeroed
                     int M, int N, int D, float margin) {
  __shared__ __align__(16) float As[2][kBK][kTile];
  __shared__ __align__(16) float Bs[2][kBK][kTile];
  __shared__ Key col_part[kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // columns 4 tx .. 4 tx + 3 of the tile
  const int ty = tid / 8;  // rows 4 ty .. 4 ty + 3
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  const int n_slabs = (D + kBK - 1) / kBK;
  float4 a_next[4], b_next[4];
  load_slab(a_next, a, i0, M, 0, D, tid);
  load_slab(b_next, b, j0, N, 0, D, tid);
  store_slab(As[0], a_next, tid);
  store_slab(Bs[0], b_next, tid);
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int cur = s % 2;
    if (s + 1 < n_slabs) {
      load_slab(a_next, a, i0, M, (s + 1) * kBK, D, tid);
      load_slab(b_next, b, j0, N, (s + 1) * kBK, D, tid);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[cur][k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[cur][k][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], bc[c], acc[r][c]);
    }
    if (s + 1 < n_slabs) {
      // the other buffer was last read in slab s - 1, before the barrier
      // that ended it
      store_slab(As[cur ^ 1], a_next, tid);
      store_slab(Bs[cur ^ 1], b_next, tid);
    }
    __syncthreads();
  }

  // epilogue: both logits, folded per row and per column of the tile
  Key rkey[4] = {0, 0, 0, 0}, ckey[4] = {0, 0, 0, 0};
  float rd[4], cd[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    rd[r] = i < M ? row_diag[i] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 4 * tx + c;
    cd[c] = j < N ? col_diag[j] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tx + c;
      if (i < M && j < N) {
        const bool neg = mask[(size_t)i * N + j] != 0;
        const float rl = neg ? margin + acc[r][c] - rd[r] : kNegInf;
        const float cl = neg ? margin + acc[r][c] - cd[c] : kNegInf;
        rkey[r] = key_max(rkey[r], make_key(rl, j));
        ckey[c] = key_max(ckey[c], make_key(cl, i));
      }
    }
  }
  // a tile row's 8 threads are lanes 8 q .. 8 q + 7 of one warp
#pragma unroll
  for (int off = 1; off < 8; off *= 2)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rkey[r] = key_max(rkey[r], __shfl_xor_sync(0xffffffffu, rkey[r], off));
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (rkey[r] != 0) atomicMax(&keys[i0 + 4 * ty + r], rkey[r]);
  }
  // a tile column's threads: lanes tx, tx + 8, tx + 16, tx + 24 of both warps
#pragma unroll
  for (int off = 8; off < 32; off *= 2)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ckey[c] = key_max(ckey[c], __shfl_xor_sync(0xffffffffu, ckey[c], off));
  const int lane = tid % 32;
  if (tid >= 32 && lane < 8) {
#pragma unroll
    for (int c = 0; c < 4; ++c) col_part[4 * lane + c] = ckey[c];
  }
  __syncthreads();
  if (tid < 8) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Key k = key_max(ckey[c], col_part[4 * tid + c]);
      if (k != 0) atomicMax(&keys[M + j0 + 4 * tid + c], k);
    }
  }
}

// The finishing step: keys -> (max, index) for the M rows, then the N
// columns.
__global__ void simhinge_decode_kernel(const Key* __restrict__ keys,
                                       float* __restrict__ row_max,
                                       int32_t* __restrict__ row_arg,
                                       float* __restrict__ col_max,
                                       int32_t* __restrict__ col_arg, int M,
                                       int N) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M + N) return;
  const Key key = keys[idx];
  const unsigned int hi = (unsigned int)(key >> 32);
  const unsigned int u = (hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi;
  const float v = __uint_as_float(u);
  const int32_t arg = (int32_t)(0xFFFFFFFFu - (unsigned int)key);
  if (idx < M) {
    row_max[idx] = v;
    row_arg[idx] = arg;
  } else {
    col_max[idx - M] = v;
    col_arg[idx - M] = arg;
  }
}

}  // namespace

// Both directions of the loss. D must be a multiple of 4 and a, b 16-byte
// aligned (the wrapper pads and copies); keys [M + N] (64-bit) must be
// zero-filled. Launches the tile kernel, then the decode kernel, on `stream`.
extern "C" int cmhse_simhinge_pair(const float* a, const float* b,
                                   const uint8_t* mask, const float* row_diag,
                                   const float* col_diag, void* keys,
                                   float* row_max, int32_t* row_arg,
                                   float* col_max, int32_t* col_arg, int M,
                                   int N, int D, float margin, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % 4 != 0 ||
      (M + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  simhinge_pair_kernel<<<grid, kThreads, 0, s>>>(
      a, b, mask, row_diag, col_diag, static_cast<Key*>(keys), M, N, D,
      margin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  simhinge_decode_kernel<<<(M + N + 255) / 256, 256, 0, s>>>(
      static_cast<const Key*>(keys), row_max, row_arg, col_max, col_arg, M,
      N);
  return (int)cudaGetLastError();
}
