// Device helpers shared by the two cooperative GRU kernels (gru_fwd.cu,
// gru_bwd.cu): the unit split, element conversions, the shared-memory row
// stride of a W_h slice, L2-only staging by cp.async, the bf16 tensor-core
// product (ldmatrix, mma.sync), and the cooperative launch with its
// co-residency check.

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
