// Hardest negative of the max-of-hinges loss for Hopper (sm_90a), f32.
//
// Replaces cmhse_tpu/ops/pallas_sim.py:_simhinge_row_kernel. For every query
// row i of A [M, D] against the rows j of B [N, D]:
//
//   logit[i, j] = neg(i, j) ? margin + <A_i, B_j> - diag[i] : -1e30
//   row_max[i]  = max_j logit[i, j]     row_arg[i] = its earliest j
//
// neg(i, j) is mask[i * ld + j], or mask[j * ld + i] with `transposed` (the
// loss's second direction reads the same [B, B] mask as its transpose, so no
// transposed copy is made). A row with no negative gets -1e30 and index 0,
// as the JAX kernel's _NEG_INF and argmax do. The similarity block never
// leaves the chip.
//
// Design. One block owns kTM query rows, keeps them in shared memory, and
// walks every column tile of B itself: this loop takes the place of the TPU
// kernel's sequential j grid axis, so there is no cross-block reduction and
// no atomic. A tile is kTN columns of B staged kKC deep, k-major, in shared
// memory; each thread owns one query row and kTN / 16 columns (c, c + 16,
// ...), visits its columns in increasing j, and keeps (max, argmax) with a
// strict '>' so the earliest index wins ties. The 16 threads of a row then
// merge their pairs with shuffles (larger value, or the smaller index on
// equal values), which gives the earliest index overall. Columns past N and
// rows past M are masked here; nothing is padded.
//
// What bounds it on an H100: at the training shapes (M = N = 64 or 512,
// D = 1024) the 2*M*N*D FLOPs take 0.13-8 us at the f32 peak and the bytes
// (A, B, the byte mask) 0.2-1.4 us, so the bound is the FLOPs at the low
// level; in practice the launch and a short grid (M / kTM blocks: 32 at
// M = 512, 4 at M = 64) dominate. Each thread does one shared load of A and
// kTN / 16 of B per kTN / 16 FMAs: simple and right first, register-blocked
// tiles are the later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 16;       // query rows per block
constexpr int kTN = 64;       // columns of B per tile
constexpr int kKC = 32;       // depth of a staged B tile
constexpr int kLanes = 16;    // threads per query row
constexpr int kCols = kTN / kLanes;
constexpr int kThreads = kTM * kLanes;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
simhinge_kernel(const float* __restrict__ a,        // [M, D]
                const float* __restrict__ b,        // [N, D]
                const uint8_t* __restrict__ mask,   // [M, N] or [N, M]
                const float* __restrict__ diag,     // [M]
                float* __restrict__ row_max,        // [M]
                int32_t* __restrict__ row_arg,      // [M]
                int M, int N, int D, int ld, int transposed, float margin) {
  extern __shared__ float smem[];
  const int ds = D + 1;              // padded row stride of the A tile
  float* as = smem;                  // [kTM][D + 1]
  float* bs = as + kTM * ds;         // [kKC][kTN + 1]
  const int row0 = blockIdx.x * kTM;
  const int tr = threadIdx.x / kLanes;  // this thread's query row in the tile
  const int tc = threadIdx.x % kLanes;  // its first column in a tile
  const int i = row0 + tr;

  for (int idx = threadIdx.x; idx < kTM * D; idx += kThreads) {
    const int r = idx / D, k = idx % D;
    as[r * ds + k] = row0 + r < M ? a[(size_t)(row0 + r) * D + k] : 0.0f;
  }
  const float di = i < M ? diag[i] : 0.0f;
  float best = -INFINITY;
  int best_j = 0;
  __syncthreads();

  for (int j0 = 0; j0 < N; j0 += kTN) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += kKC) {
      // stage B[j0 : j0 + kTN, k0 : k0 + kKC] k-major
      for (int idx = threadIdx.x; idx < kTN * kKC; idx += kThreads) {
        const int jj = idx / kKC, kk = idx % kKC;
        const int j = j0 + jj, k = k0 + kk;
        bs[kk * (kTN + 1) + jj] = (j < N && k < D) ? b[(size_t)j * D + k]
                                                   : 0.0f;
      }
      __syncthreads();
      const int kend = min(kKC, D - k0);
      const float* arow = as + tr * ds + k0;
      for (int kk = 0; kk < kend; ++kk) {
        const float av = arow[kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c] = fmaf(av, bs[kk * (kTN + 1) + tc + c * kLanes], acc[c]);
      }
      __syncthreads();
    }
    if (i < M) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + tc + c * kLanes;
        if (j >= N) continue;
        const uint8_t m = transposed ? mask[(size_t)j * ld + i]
                                     : mask[(size_t)i * ld + j];
        const float logit = m ? margin + acc[c] - di : kNegInf;
        if (logit > best) {
          best = logit;
          best_j = j;
        }
      }
    }
  }

  // merge the 16 lanes of a row: larger value, or the earlier index on ties
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ob > best || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
  }
  if (tc == 0 && i < M) {
    row_max[i] = best;
    row_arg[i] = best_j;
  }
}

}  // namespace

// One direction of the loss: row_max / row_arg of every row of A. D must be
// at most (227 KB - the B tile) / (kTM * 4 bytes); the wrapper checks it.
extern "C" int cmhse_simhinge(const float* a, const float* b,
                              const uint8_t* mask, const float* diag,
                              float* row_max, int32_t* row_arg, int M, int N,
                              int D, int ld, int transposed, float margin,
                              void* stream) {
  if (M <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kTM * (D + 1) + (size_t)kKC * (kTN + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      simhinge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kTM - 1) / kTM);
  simhinge_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      a, b, mask, diag, row_max, row_arg, M, N, D, ld, transposed, margin);
  return (int)cudaGetLastError();
}

// Largest D the kernel takes (its query rows live in shared memory).
extern "C" int cmhse_simhinge_max_depth() {
  return (int)((232448 / sizeof(float) - kKC * (kTN + 1)) / kTM) - 1;
}
