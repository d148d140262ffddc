// Device helpers shared by the cooperative GRU kernels (gru_fwd.cu,
// gru_fwd_streamed.cu, gru_bwd.cu, gru_bwd_streamed.cu): the unit split,
// element conversions, the gates' sigmoid, the shared-memory row stride of
// a W_h slice, staging by cp.async, the bf16 tensor-core product
// (ldmatrix, mma.sync), K2's gate gradients and bias sums, and the
// cooperative launch with its co-residency check.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gru {

constexpr int kThreads = 256;
constexpr int kPassUnits = 8;  // units a pass of a product computes

// Units a block owns: every block gets at least a pass of 8, and the grid is
// at most one block per SM.
inline int units_per_block(int H, int sms) {
  const int u = (H + sms - 1) / sms;
  return u > kPassUnits ? u : kPassUnits;
}

// Row stride of a W_h slice in shared memory, in elements, for rows of
// `depth` elements: rounded up to 128 bytes, plus 16 bytes, so that 8
// consecutive rows start in 8 different 16-byte bank groups (the f32 float4
// loads and the bf16 ldmatrix rows).
template <typename E>
__host__ __device__ inline int w_stride(int depth) {
  const int k = 128 / (int)sizeof(E);
  return (depth + k - 1) / k * k + 16 / (int)sizeof(E);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round to nearest even, as astype(jnp.bfloat16) does
template <typename E>
__device__ __forceinline__ E from_f(float x) {
  if constexpr (std::is_same<E, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only (coherent after a grid
// barrier); `in` false zero-fills the 16 bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// kBytes (4, 8 or 16) global -> shared through L1: only for what is
// read-only for the call (W_h); `in` false zero-fills and reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(kBytes), "r"(in ? kBytes : 0));
}

__device__ __forceinline__ void commit_staged() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) b (16 x 8, column-major): bf16 operands, f32
// accumulation; a product of two bf16 values is exact in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- K2 (gru_bwd.cu, gru_bwd_streamed.cu): the parts outside the product

constexpr int kBwdBatch = 8;  // rows a phase-1 thread has in flight

// Where depth k of batch row b's product operand lies at step t: dxw
// [B, T, 3H] for k < 2H, dhn [B, T, H] past it.
template <typename E>
__device__ __forceinline__ const E* operand_at(const E* __restrict__ dxw,
                                               const E* __restrict__ dhn,
                                               int b, int t, int T, int H,
                                               int k) {
  const size_t bt = (size_t)b * T + t;
  return k < 2 * H ? dxw + bt * 3 * H + k : dhn + bt * H + (k - 2 * H);
}

// Phase 1 of K2 at step t for one thread: unit u of rows r1, r1 + sweep,
// ... below B. Writes the gate gradients to dxw[:, t] and dhn[:, t]
// (zeros on a masked step), the unit's f32 carry (dh z live; dh, passed
// through, masked), and adds [dr', dz', dn', dhn] to the thread's bias
// sums db in the order of its rows. The rows go kBwdBatch at a time, each
// stage's loads issued for the whole batch before any is used, so that
// their latencies overlap (the batch changes no sum's order). 1 - n^2 is
// spelled as the fmaf it compiles to, so that both kernels round it alike
// wherever it is inlined.
template <typename E>
__device__ __forceinline__ void bwd_gate_grads(
    int t, int r1, int sweep, int u, int B, int T, int H,
    const E* __restrict__ gates, const E* __restrict__ outs,
    const E* __restrict__ h_init, const E* __restrict__ douts,
    const int32_t* __restrict__ lengths, E* __restrict__ dxw,
    E* __restrict__ dhn_out, float* __restrict__ carry, float (&db)[4]) {
  for (int b0 = r1; b0 < B; b0 += kBwdBatch * sweep) {
    float d[kBwdBatch], g[kBwdBatch][4], hp[kBwdBatch];
    bool live[kBwdBatch];
#pragma unroll
    for (int q = 0; q < kBwdBatch; ++q) {
      const int b = b0 + q * sweep;
      d[q] = 0.0f;
      live[q] = false;
      if (b < B) {
        const size_t bt = (size_t)b * T + t;
        d[q] = carry[(size_t)b * H + u];
        if (douts != nullptr) d[q] += to_f(douts[bt * H + u]);
        live[q] = t < lengths[b];
      }
    }
#pragma unroll
    for (int q = 0; q < kBwdBatch; ++q) {
      if (!live[q]) continue;
      const int b = b0 + q * sweep;
      const size_t bt = (size_t)b * T + t;
      const E* gp = gates + bt * 4 * H + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) g[q][k] = to_f(gp[k * H]);
      hp[q] = t > 0 ? to_f(outs[(bt - 1) * H + u])
              : h_init != nullptr ? to_f(h_init[(size_t)b * H + u])
                                  : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBwdBatch; ++q) {
      const int b = b0 + q * sweep;
      if (b >= B) break;
      const size_t bt = (size_t)b * T + t;
      float c = d[q], drp = 0.0f, dzp = 0.0f, dnp = 0.0f, dhn = 0.0f;
      if (live[q]) {
        const float r = g[q][0], z = g[q][1], n = g[q][2], hn = g[q][3];
        const float dn = d[q] * (1.0f - z);
        const float dz = d[q] * (hp[q] - n);
        dnp = dn * fmaf(-n, n, 1.0f);
        dhn = dnp * r;
        dzp = dz * z * (1.0f - z);
        drp = dnp * hn * r * (1.0f - r);
        c = d[q] * z;
      }
      E* dx = dxw + bt * 3 * H + u;
      dx[0] = from_f<E>(drp);
      dx[H] = from_f<E>(dzp);
      dx[2 * H] = from_f<E>(dnp);
      dhn_out[bt * H + u] = from_f<E>(dhn);
      carry[(size_t)b * H + u] = c;
      db[0] += drp;
      db[1] += dzp;
      db[2] += dnp;
      db[3] += dhn;
    }
  }
}

// The end of K2, after the time loop, for a block of n_units units from u0
// whose phase-1 thread tid took unit u of rows r1, r1 + sweep, ...: dh0
// rounded from the f32 carry (bf16; in f32 the carry is dh0 itself), and
// the bias sums, each unit's phase-1 partials summed in the order of their
// rows and written once (no atomics). part: kThreads x 4 free floats of
// shared memory.
template <typename E>
__device__ __forceinline__ void bwd_finish(const float (&db_part)[4],
                                           float* part, bool in_p1, int r1,
                                           int sweep, int u, int u0,
                                           int n_units, int B, int H,
                                           const float* __restrict__ carry,
                                           E* __restrict__ dh0,
                                           float* __restrict__ db, int tid) {
  __syncthreads();
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    if (in_p1)
      for (int b = r1; b < B; b += sweep)
        dh0[(size_t)b * H + u] = from_f<E>(carry[(size_t)b * H + u]);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) part[4 * tid + g] = db_part[g];
  __syncthreads();
  if (tid < n_units) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < sweep; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) s[g] += part[4 * (i * n_units + tid) + g];
#pragma unroll
    for (int g = 0; g < 4; ++g) db[g * H + u0 + tid] = s[g];
  }
}

// Number of SMs of the current device, or 0 on error.
inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// Largest opt-in shared memory of one block on the current device, or 0.
inline int device_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

// Launch `kernel` as one cooperative grid of `grid` blocks of kThreads.
// Every block must be resident at once for the grid barrier, so a grid the
// card cannot hold is refused (cudaErrorCooperativeLaunchTooLarge), never
// run in part.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int grid, size_t smem, void** args,
                       cudaStream_t stream) {
  int sms = device_sms(), per_sm = 0;
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Largest H (a multiple of 4) whose shared memory, smem_bytes(H, U) with
// U = units_per_block(H, SMs), fits one block on the current device; the
// bytes grow with H (U and the row stride never shrink).
template <typename SmemBytes>
int max_hidden(SmemBytes smem_bytes) {
  const int sms = device_sms(), optin = device_smem_optin();
  if (sms == 0 || optin == 0) return 0;
  int h = 0;
  while (smem_bytes(h + 4, units_per_block(h + 4, sms)) <= (size_t)optin)
    h += 4;
  return h;
}

}  // namespace gru
