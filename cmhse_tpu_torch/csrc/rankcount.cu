// Streaming rank count for Hopper (sm_90a), f32 and its lowp branch.
//
// Replaces cmhse_tpu/ops/pallas_sim.py:_rankcount_kernel, both branches:
// f32, and `lowp` (precision="bfloat16": both operands rounded to bf16, f32
// accumulation). For each query q it counts the gallery rows n with
//
//   s = <queries[q], gallery[n]> > pos[q]  &&  valid[n]  &&  n != posidx[q]
//
// without ever writing the [Q, N] similarity block to device memory. The
// positive's own column is excluded by index, so a last-bit difference
// between this product and the caller's separately reduced pos[q] can never
// count the positive against itself. pos + 1 and the NaN-positive rule stay
// in the wrapper. Counts go into counts[Q] (zeroed by the wrapper) by
// integer atomicAdd: integer addition is order-free, so the result does not
// depend on scheduling. Ragged Q and N are masked in the kernels.
//
// What bounds both on an H100: the 2*Q*N*D operations (2.1e11 at Q=1024,
// N=100k, D=1024): 3.1 ms at the 67 TFLOP/s f32 FFMA peak, 0.21 ms at the
// 989 TFLOP/s bf16 tensor-core peak. The gallery's bytes from HBM (0.41 GB
// f32, 0.2 GB bf16) take a fifth of that or less, if each gallery tile is
// read from HBM once and then from L2 by every query tile: both grids walk
// (gallery tile, query tile) gallery-major, so the blocks resident at once
// share a few gallery tiles, and the query block stays in L2.
//
// f32 branch: FFMA, since the contract is f32-exact (TF32, or a 3 x TF32
// split, would change counts). One block per tile of BM = 128 queries x
// BN = 256 gallery rows (128 where 256-row tiles would not give every SM
// a block), numbered gallery-major (block b: query tile b % q_tiles,
// gallery tile b / q_tiles). Eight warps of 64 x BN / 4 scores; each
// thread keeps 8 query rows x BN / 16 gallery rows of scores in registers
// (~255 registers: one block an SM). 32-deep slabs of both operands go
// row-major by 16-byte cp.async (L2 only, no register staging) into a
// 3-stage shared-memory ring, one barrier per slab. A thread reads four
// depths of a row with one 16-byte shared load (rows 36 floats apart, so
// the 8 rows a quarter-warp reads lie in 8 different bank groups): 24
// loads per 512 FMAs. The epilogue compares, masks and counts in
// registers, sums a row's count over its 4 lanes (shuffles) and its 4
// warps (shared atomics), one atomicAdd per query per tile. D must be a
// multiple of 4 and the operands 16-byte aligned (the wrapper checks).
//
// lowp branch: bf16 tensor cores (wgmma). The operands arrive as bf16 rows
// ([Q, D] and [N, D], D a multiple of 8 so that a row is a whole number of
// 16-byte units; the wrapper rounds f32 inputs to bf16 and pads D with zero
// columns, which is exact). A product of two bf16 values is exact in f32
// and the sums are f32, as on the TPU's matrix unit. One persistent block
// per SM walks output tiles of BM = 128 queries x BN = 256 gallery rows,
// gallery-major (tile t: query tile t % q_tiles, gallery tile t / q_tiles;
// block b takes t = b, b + grid, ...), in three warpgroups:
//   - a producer (one thread) streams BK = 64-deep slabs of both operands
//     by TMA (128-byte swizzle) into a ring of STAGES shared-memory stages,
//     each guarded by a "full" and an "empty" mbarrier; the ring runs on
//     across tiles, so the next tile's slabs arrive during an epilogue;
//   - two consumers, 64 queries each, issue wgmma.m64n256k16 (both
//     operands K-major in shared memory, f32 accumulators in registers:
//     each thread holds two query rows x 64 gallery columns) and release a
//     stage as soon as the wgmma after it has been issued and waited for;
//   - the epilogue works on the accumulator registers: compare with the
//     row's pos, mask by a 256-bit validity word set of the tile (gvalid
//     and n < N, one ballot per 32 columns) and by the positive's column,
//     sum a row's count in the thread and over its 4 lanes, one atomicAdd
//     per query row per tile. No score is ever stored.
// The query block (2 MB of bf16 at Q=1024) stays in L2; TMA zero-fills rows
// past Q or N and depths past D, and the epilogue drops those rows/columns.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is
                   // looked up at run time, so nothing links -lcuda)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Number of SMs of the current device, or 0 on error.
int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// ---------------------------------------------------------------- f32 ----

namespace f32 {

constexpr int BM = 128;        // queries per tile
constexpr int BK = 32;         // depth of one stage
constexpr int LD = BK + 4;     // row stride in shared memory (floats): 8
                               // consecutive rows start in 8 different
                               // 16-byte bank groups
constexpr int STAGES = 3;
constexpr int NT = 256;        // 8 warps of 64 queries x BN / 4 gallery rows
// gallery rows per tile: 256 where such tiles fill every SM at least once,
// else 128 (twice the blocks, for small Q x N)
constexpr int BN_WIDE = 256;
constexpr int BN_NARROW = 128;

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * LD * 4;
}

// 16 bytes global -> shared through L2 only; `in` false zero-fills them and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Stage the BK-deep slab at depth k0 of rows row0 .. row0 + ROWS - 1 of src
// ([rows, D], row-major) into dst ([ROWS][LD] floats), 16 bytes a copy:
// BK / 4 consecutive threads copy one row. Rows past `rows` and depths past
// D (D is a multiple of 4) read as zero.
template <int ROWS>
__device__ __forceinline__ void stage_slab(uint32_t dst,
                                           const float* __restrict__ src,
                                           int row0, int rows, int k0, int D,
                                           int tid) {
  constexpr int kPerRow = BK / 4;
  const int k = 4 * (tid % kPerRow);
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / NT; ++i) {
    const int r = tid / kPerRow + (NT / kPerRow) * i;
    const bool in = row0 + r < rows && k0 + k < D;
    const float* p = in ? src + (size_t)(row0 + r) * D + k0 + k : src;
    cp_async16(dst + (r * LD + k) * 4, p, in);
  }
}

// One block an SM: the 8 x TN scores and their operands need ~255 registers.
template <int BN>
__global__ void __launch_bounds__(NT, 1)
rankcount_kernel(const float* __restrict__ q,         // [Q, D]
                 const float* __restrict__ g,         // [N, D]
                 const float* __restrict__ pos,       // [Q]
                 const int32_t* __restrict__ posidx,  // [Q] or null
                 const uint8_t* __restrict__ gvalid,  // [N] or null
                 int32_t* __restrict__ counts,        // [Q], zeroed
                 int Q, int N, int D, int q_tiles) {
  constexpr int TN = BN / 16;  // gallery rows a thread (8 query rows)
  constexpr int STAGE_FLOATS = (BM + BN) * LD;
  extern __shared__ __align__(16) float smem[];  // STAGES x {A, B}
  __shared__ int tile_counts[BM];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // gallery-major: the blocks resident at once share a few gallery tiles
  const int q0 = (int)(blockIdx.x % q_tiles) * BM;
  const int n0 = (int)(blockIdx.x / q_tiles) * BN;
  // this thread's scores: query rows qr + 8 * i, gallery rows nr + 4 * j
  const int qr = 64 * (warp / 4) + lane / 4;
  const int nr = (BN / 4) * (warp % 4) + lane % 4;
  const uint32_t base = smem_u32(smem);
  const int slabs = (D + BK - 1) / BK;

  auto stage = [&](int s) {
    if (s < slabs) {
      const uint32_t a = base + (s % STAGES) * STAGE_FLOATS * 4;
      stage_slab<BM>(a, q, q0, Q, s * BK, D, tid);
      stage_slab<BN>(a + BM * LD * 4, g, n0, N, s * BK, D, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (tid < BM) tile_counts[tid] = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage(s);

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < slabs; ++s) {
    // slab s has landed (for every thread, after the barrier), and every
    // thread is done with slab s - 1, whose stage the next copy reuses
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    stage(s + STAGES - 1);
    const float* A = smem + (s % STAGES) * STAGE_FLOATS;
    const float* B = A + BM * LD;
#pragma unroll
    for (int c = 0; c < BK; c += 4) {
      float4 a[8];  // depths c .. c + 3 of the thread's 8 query rows
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (qr + 8 * i) * LD + c);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + (nr + 4 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }

  // epilogue: compare, mask and count from the registers; a row's count
  // summed over its 4 lanes, then over the 4 warps that share its rows
  int cnt[8];
  float p[8];
  int pi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + qr + 8 * i;
    p[i] = r < Q ? pos[r] : INFINITY;  // a row past Q counts 0
    pi[i] = (r < Q && posidx != nullptr) ? posidx[r] : -1;
    cnt[i] = 0;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + nr + 4 * j;
    const bool n_ok = n < N && (gvalid == nullptr || gvalid[n] != 0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cnt[i] += (n_ok && n != pi[i] && acc[i][j] > p[i]) ? 1 : 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], 1);
    cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], 2);
    if (lane % 4 == 0 && cnt[i] != 0)
      atomicAdd(&tile_counts[qr + 8 * i], cnt[i]);
  }
  __syncthreads();
  if (tid < BM && q0 + tid < Q && tile_counts[tid] != 0)
    atomicAdd(&counts[q0 + tid], tile_counts[tid]);
}

template <int BN>
int launch_tiles(const float* q, const float* g, const float* pos,
                 const int32_t* posidx, const uint8_t* gvalid,
                 int32_t* counts, int Q, int N, int D, int q_tiles,
                 cudaStream_t stream) {
  const long long blocks = (long long)q_tiles * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rankcount_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<BN>());
  if (err != cudaSuccess) return (int)err;
  rankcount_kernel<BN><<<(unsigned)blocks, NT, smem_bytes<BN>(), stream>>>(
      q, g, pos, posidx, gvalid, counts, Q, N, D, q_tiles);
  return (int)cudaGetLastError();
}

int launch(const float* q, const float* g, const float* pos,
           const int32_t* posidx, const uint8_t* gvalid, int32_t* counts,
           int Q, int N, int D, cudaStream_t stream) {
  // 16-byte copies: rows of a whole number of 16-byte units, aligned bases
  if (D % 4 != 0 || (uintptr_t)q % 16 != 0 || (uintptr_t)g % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int sms = device_sms();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int q_tiles = (Q + BM - 1) / BM;
  const bool wide = (long long)q_tiles * ((N + BN_WIDE - 1) / BN_WIDE) >= sms;
  return wide ? launch_tiles<BN_WIDE>(q, g, pos, posidx, gvalid, counts, Q,
                                      N, D, q_tiles, stream)
              : launch_tiles<BN_NARROW>(q, g, pos, posidx, gvalid, counts, Q,
                                        N, D, q_tiles, stream);
}

}  // namespace f32

// --------------------------------------------------------------- lowp ----

namespace lowp {

constexpr int BM = 128;  // queries per tile: two consumer warpgroups x 64
constexpr int BN = 256;  // gallery rows per tile: the n of one wgmma
constexpr int BK = 64;   // depth of a stage: 128 bytes of bf16 per row, the
                         // span of the 128-byte swizzle
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BN * BK * 2;  // 32 KB
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 128 + 32 * CONSUMER_WARPS;  // producer + 2 consumers
// stages (1024-byte aligned for the swizzle), then 2 * STAGES mbarriers;
// +1024 to align the dynamic base
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES) + 16 * STAGES + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of `map` at (depth c0, row c1) into shared memory at dst;
// completion (its bytes) is reported to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle (what TMA's SWIZZLE_128B writes): start address,
// leading offset 16 B (unused by this layout), stride 1024 B between
// 8-row groups, layout type 1 (128B swizzle). The tile base must be
// 1024-byte aligned; a k step of 16 values adds 32 bytes to the start.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CMHSE_D8(i)                                                    \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),     \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 per warpgroup, f32) += A (64 x 16, bf16, K-major) *
// B (256 x 16, bf16, K-major)^T; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : CMHSE_D8(0), CMHSE_D8(8), CMHSE_D8(16), CMHSE_D8(24), CMHSE_D8(32),
        CMHSE_D8(40), CMHSE_D8(48), CMHSE_D8(56), CMHSE_D8(64), CMHSE_D8(72),
        CMHSE_D8(80), CMHSE_D8(88), CMHSE_D8(96), CMHSE_D8(104),
        CMHSE_D8(112), CMHSE_D8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef CMHSE_D8

__global__ void __launch_bounds__(THREADS, 1)
rankcount_kernel(const __grid_constant__ CUtensorMap qmap,  // [Q, D] bf16
                 const __grid_constant__ CUtensorMap gmap,  // [N, D] bf16
                 const float* __restrict__ pos,             // [Q]
                 const int32_t* __restrict__ posidx,        // [Q] or null
                 const uint8_t* __restrict__ gvalid,        // [N] or null
                 int32_t* __restrict__ counts,              // [Q], zeroed
                 int Q, int N, int D) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sa = base;                    // STAGES x [BM][BK] bf16
  const uint32_t sb = sa + STAGES * A_BYTES;   // STAGES x [BN][BK] bf16
  const uint32_t full = sb + STAGES * B_BYTES;  // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;     // STAGES mbarriers
  const int q_tiles = (Q + BM - 1) / BM;
  const long long tiles = (long long)q_tiles * ((N + BN - 1) / BN);
  const int slabs = (D + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMER_WARPS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int q0 = (int)(t % q_tiles) * BM;
        const int n0 = (int)(t / q_tiles) * BN;
        for (int s = 0; s < slabs; ++s) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
          mbar_expect_tx(full + 8 * stage, A_BYTES + B_BYTES);
          tma_load(sa + stage * A_BYTES, &qmap, full + 8 * stage, s * BK, q0);
          tma_load(sb + stage * B_BYTES, &gmap, full + 8 * stage, s * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the count epilogue --------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;  // query rows 64 * half .. + 63 of the tile
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    // accumulator element r of this thread: query row 16 * warp + lane / 4
    // + 8 * ((r >> 1) & 1) of the warpgroup's 64, gallery column
    // 8 * (r >> 2) + 2 * (lane % 4) + (r & 1) of the tile's 256
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int q0 = (int)(t % q_tiles) * BM;
      const int n0 = (int)(t / q_tiles) * BN;
      const int row = q0 + 64 * half + 16 * warp + lane / 4;  // and row + 8

      // the epilogue's inputs, loaded while the product runs: a row past Q
      // gets pos = +inf (no score is greater); its positive's column in
      // this tile, or -1
      float p[2];
      int pcol[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        p[h] = r < Q ? pos[r] : INFINITY;
        const int c = (r < Q && posidx != nullptr) ? posidx[r] - n0 : -1;
        pcol[h] = (c >= 0 && c < BN) ? c : -1;
      }
      // bit c of word c / 32: gallery row n0 + c is in range and valid
      uint32_t vw[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + 32 * i + lane;
        vw[i] = __ballot_sync(0xffffffffu,
                              n < N && (gvalid == nullptr || gvalid[n] != 0));
      }

      int prev = 0;
      for (int s = 0; s < slabs; ++s) {
        mbar_wait(full + 8 * stage, phase);
        wgmma_fence();
        const uint32_t a = sa + stage * A_BYTES + half * (A_BYTES / 2);
        const uint32_t b = sb + stage * B_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16(d, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk),
                           (s > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        // the previous slab's products are done: release its stage
        wgmma_wait<1>();
        if (s > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // ---- epilogue: compare, mask and count from the registers -------
      // this thread's column 8 * j + 2 * (lane % 4) + e sits at bit
      // 8 * (j % 4) + e of vs[j / 4]; px[h]: the row's positive as 8 * j + e
      // if it is one of this thread's columns, else -1
      uint32_t vs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) vs[i] = vw[i] >> (2 * (lane % 4));
      int px[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        px[h] = (pcol[h] >= 0 && ((pcol[h] >> 1) & 3) == lane % 4)
                    ? (pcol[h] & ~6)
                    : -1;
      int cnt[2] = {0, 0};
#pragma unroll
      for (int r = 0; r < 128; ++r) {
        const int j = r >> 2, h = (r >> 1) & 1, e = r & 1;
        const bool ok =
            ((vs[j / 4] >> (8 * (j % 4) + e)) & 1u) && 8 * j + e != px[h];
        cnt[h] += (ok && d[r] > p[h]) ? 1 : 0;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 1);
        cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 2);
        const int r = row + 8 * h;
        if (lane % 4 == 0 && r < Q && cnt[h] != 0) atomicAdd(&counts[r], cnt[h]);
      }
      fence_acc(d);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (cudaGetDriverEntryPoint).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// TMA map of a row-major [rows, D] bf16 matrix, boxes of box_rows x BK,
// 128-byte swizzle; out-of-bounds rows and depths read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int D,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* q, const void* g, const float* pos,
           const int32_t* posidx, const uint8_t* gvalid, int32_t* counts,
           int Q, int N, int D, cudaStream_t stream) {
  // TMA: 16-byte row strides and bases
  if (D % 8 != 0 || (uintptr_t)q % 16 != 0 || (uintptr_t)g % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, gmap;
  if (!make_map(&qmap, q, Q, D, BM) || !make_map(&gmap, g, N, D, BN))
    return (int)cudaErrorInvalidValue;
  const int sms = device_sms();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaFuncSetAttribute(
      rankcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((Q + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms ? (int)tiles : sms;  // one block an SM
  rankcount_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      qmap, gmap, pos, posidx, gvalid, counts, Q, N, D);
  return (int)cudaGetLastError();
}

}  // namespace lowp

}  // namespace

// q, g: [Q, D] and [N, D] row-major, f32 (lowp = 0; D a multiple of 4) or
// bf16 (lowp = 1; D a multiple of 8), 16-byte aligned.
extern "C" int cmhse_rankcount(const void* q, const void* g, const float* pos,
                               const int32_t* posidx, const uint8_t* gvalid,
                               int32_t* counts, int Q, int N, int D, int lowp,
                               void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (lowp)
    return lowp::launch(q, g, pos, posidx, gvalid, counts, Q, N, D, s);
  return f32::launch((const float*)q, (const float*)g, pos, posidx, gvalid,
                     counts, Q, N, D, s);
}

// Dynamic shared memory a block of the branch asks for (f32: with its
// 256-row tiles), in bytes; the build log shows only the static part.
extern "C" int cmhse_rankcount_smem_bytes(int lowp) {
  return lowp ? lowp::SMEM_BYTES : f32::smem_bytes<f32::BN_WIDE>();
}
