// Masked GRU forward time loop for Hopper (sm_90a), f32 and bf16.
//
// Replaces cmhse_tpu/ops/pallas_gru.py:_gru_kernel, all three of its
// variants as template flags of one kernel: the encode path's (no flag), the
// training path's save_gates (also streams the gates [r, z, n, hn] that the
// backward kernel, gru_bwd.cu, reads) and with_h0 (the carry starts at the
// caller's h0, the reconstruction decoder's), each in both of its element
// types (the template parameter E). The input projection x @ W_i + b_i is
// one large matrix product outside this kernel; the kernel runs the
// sequential part:
//
//   hw = h @ W_h + b_h                         (gate order r, z, n)
//   r = sigmoid(xw_r + hw_r)   z = sigmoid(xw_z + hw_z)
//   n = tanh(xw_n + r * hw_n)  h' = (1 - z) * n + z * h
//   h = t < len ? h' : h       outs[b, t] = h      final[b] = h
//   gates[b, t] = [r, z, n, hw_n]                  (save_gates, t < len only)
//
// bf16 (E = __nv_bfloat16) keeps the TPU kernel's rounding points: xw, W_h,
// h0, outs, final and gates are bf16 in memory; the carry h stays f32 and is
// never rounded; the product takes the carry rounded to bf16 (h.astype(bf16)
// @ W_h with f32 accumulation); b_h and the gate math are f32; outs, final
// and the gates are rounded to nearest even on store.
//
// The gates of a step at or past a row's length are NOT written (the buffer
// holds whatever it held): the backward selects on t < len and never reads
// them, so no zeros are streamed for padding.
//
// Design. One persistent cooperative grid, at most one block per SM
// (cudaLaunchCooperativeKernel; the grid barrier is cooperative_groups'
// this_grid().sync()). The hidden units are split across the blocks: block
// k owns U consecutive units (U = max(8, ceil(H / SMs)): 8 at H = 1024, so
// 128 blocks) and keeps their three gate columns of W_h, 3U x H, in shared
// memory for the whole time loop (96 KB in f32, 48 KB in bf16 at
// H = 1024), loaded once. Each step, the block computes its columns of
// h_{t-1} @ W_h for ALL B rows of the call, runs the gate math of its
// units, and writes its units of outs[:, t] (and gates, final); then one
// grid barrier. There is no exchange buffer: outs[:, t - 1] already holds
// every row's whole state h_{t-1}, frozen rows included, and in bf16 it is
// already the rounded operand of the product. The state is read with
// L2-coherent loads (ld.global.cg), never through the read-only or L1
// path, which the grid barrier does not make coherent. The f32 carry of
// the block's own units is read back by the thread that wrote it: from
// outs in f32 (the f32 output is the carry), from a private f32 scratch
// [B, H] in bf16 (the carry is not the rounded output). No atomics: the
// sums run in a fixed order, so the result is bitwise the same run to run.
//
// The product walks the batch in chunks of rows and its units in passes of
// 8; for each, slabs of the state rows are staged in shared memory,
// double-buffered (the next slab is in flight while the current one is
// multiplied). A chunk in which no row runs at step t skips the product and
// only copies the frozen state.
//   f32: chunks of 512 rows, 16-depth slabs staged by cp.async.cg. FFMA on
//   the CUDA cores (TF32 would break the 1e-5 parity). A thread owns two
//   units and 8 rows (r, r + 64, ...): per 4 depths six 16-byte loads of
//   W_h and 8 of the state feed 192 FMAs.
//   bf16: chunks of 256 rows, 64-depth slabs; when H is a multiple of 8
//   (every row 16-byte aligned) a three-stage ring of 16-byte cp.async.cg
//   copies, two slabs in flight, otherwise 8-byte ld.global.cg loads
//   through registers into two buffers. mma.sync.m16n8k16 (bf16 operands,
//   f32 accumulation) on the tensor cores, fragments by ldmatrix from
//   shared memory. A warp owns 32 rows (two m-tiles) and the pass's 8 units
//   in each of the three gates (three n-tiles). A product of two bf16
//   values is exact in f32, so the result is the plain version's up to
//   summation order.
//
// Past fwd_max_hidden a block's slice of W_h no longer fits in shared
// memory: gru_fwd_streamed.cu's kernel takes that H (W_h staged slab by
// slab beside the state, one sweep of the state a step, live rows only),
// with this kernel's arithmetic in its order.
//
// What bounds it on an H100 (video_low, 512 rows x 64 steps, H = 1024;
// PERF.md): the product. In f32, 512 x 1024 x 24 FMAs a block a step run
// well below the SM's FFMA rate: two warps a scheduler and all 255
// registers in use, so the shared-memory loads are not hidden. In bf16 the
// tensor cores leave the L2 reads of the state (1 MB a block a step) in
// front, hidden by the three-stage ring only as far as two slabs in flight
// cover L2 latency. Each step also pays the gate pass, the stores and one
// grid barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using gru::commit_staged;
using gru::cp_async16;
using gru::from_f;
using gru::kPassUnits;
using gru::kThreads;
using gru::ldmatrix_x2;
using gru::ldmatrix_x4;
using gru::mma_bf16;
using gru::sigmoid_f;
using gru::to_f;
using gru::units_per_block;
using gru::w_stride;
using gru::wait_staged;

// How each element type stages the state and splits the product. A chunk
// is the batch rows one pass covers; a staged row holds one slab of depths
// plus 16 bytes of padding (so that rows start in different bank groups).
template <typename E>
struct Layout;
template <>
struct Layout<float> {  // a thread: 8 rows (r, r + 64, ...) x 2 units
  static constexpr int kChunkRows = 512;
  static constexpr int kSlabBytes = 64;  // 16 depths
  static constexpr int kRowBytes = 80;
  static constexpr int kPadRows = 0;
  static constexpr int kPairs = 16;  // (row, unit) pairs a thread owns
  static constexpr int kStages = 2;  // staging buffers
};
template <>
struct Layout<__nv_bfloat16> {  // a warp: 32 rows x 8 units (mma tiles)
  static constexpr int kChunkRows = 256;
  static constexpr int kSlabBytes = 128;  // 64 depths
  static constexpr int kRowBytes = 144;
  static constexpr int kPadRows = 8;  // zero W_h rows past the last gate
  static constexpr int kPairs = 8;
  static constexpr int kStages = 3;
};

template <typename E>
__host__ __device__ constexpr int slab_depth() {
  return Layout<E>::kSlabBytes / (int)sizeof(E);
}

template <typename E>
__host__ __device__ constexpr int stage_bytes() {
  return Layout<E>::kChunkRows * Layout<E>::kRowBytes;
}

// elements of one block's W_h slice, [3U + pad][WS]
template <typename E>
__host__ __device__ size_t slice_elems(int H, int U) {
  return (size_t)(3 * U + Layout<E>::kPadRows) * w_stride<E>(H);
}

// the staging buffers and the W_h slice
template <typename E>
size_t smem_bytes(int H, int U) {
  return Layout<E>::kStages * (size_t)stage_bytes<E>() +
         slice_elems<E>(H, U) * sizeof(E);
}

// bf16: one slab of the chunk's state rows into registers: thread t loads
// the 8-byte piece (t + 256 q) % 16 of row (t + 256 q) / 16, so 16 threads
// read one row's 128 contiguous bytes. Rows past `rows` and depths past H
// read as 0 (H is a multiple of 4, so a piece is whole or absent). A row of
// bf16 is 8-byte aligned only (H = 1100 is not a multiple of 8), so these
// are 8-byte L2-coherent loads through registers rather than cp.async.
using BL = Layout<__nv_bfloat16>;
constexpr int kLoads = BL::kChunkRows * BL::kSlabBytes / 8 / kThreads;

__device__ __forceinline__ void load_state(
    uint2 (&v)[kLoads], const __nv_bfloat16* __restrict__ src,
    size_t row_stride, int rows, int k0, int H, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 16;
    const int k = k0 + (f % 16) * 4;
    v[q] = (r < rows && k < H)
               ? __ldcg(reinterpret_cast<const uint2*>(src + r * row_stride +
                                                       k))
               : make_uint2(0u, 0u);
  }
}

__device__ __forceinline__ void store_state(unsigned char* buf,
                                            const uint2 (&v)[kLoads],
                                            int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    *reinterpret_cast<uint2*>(buf + (f / 16) * BL::kRowBytes + (f % 16) * 8) =
        v[q];
  }
}

// f32: one slab (16 depths) of the chunk's 512 state rows straight into
// shared memory with 16-byte cp.async.cg (L2 only: coherent after the grid
// barrier), 4 pieces a row, 8 a thread; rows past `rows` and depths past H
// are zero-filled (src-size 0).
using FL = Layout<float>;

__device__ __forceinline__ void stage_f32(unsigned char* buf,
                                          const float* __restrict__ src,
                                          size_t row_stride, int rows, int k0,
                                          int H, int tid) {
#pragma unroll
  for (int q = 0; q < FL::kChunkRows * FL::kSlabBytes / 16 / kThreads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 4;
    const int k = k0 + (f % 4) * 4;
    const bool in = r < rows && k < H;
    cp_async16(buf + r * FL::kRowBytes + (f % 4) * 16,
               in ? src + r * row_stride + k : src, in);
  }
  commit_staged();
}

// acc[2 i + e][g] += h[row rg + 64 i] . W_h[:, gate g of unit j0 + e] over
// the chunk's rows, for i < kIters (16 f32 depths a slab). Per 4 depths a
// thread makes six 16-byte loads of W_h and kIters of the state for
// 24 kIters FMAs. kIters is a template parameter so that no branch stands
// between a state load and its FMAs.
template <int kIters>
__device__ __forceinline__ void product_f32(
    float (&acc)[16][3], unsigned char* stage, const float* ws, int WS, int U,
    int ja, int jb, int rg, const float* __restrict__ src,
    size_t row_stride, int rows, int H, int tid) {
  constexpr int kK = slab_depth<float>();
  const float* w[2][3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    w[0][g] = ws + (size_t)(g * U + ja) * WS;
    w[1][g] = ws + (size_t)(g * U + jb) * WS;
  }
  const int n_slabs = (H + kK - 1) / kK;
  // the previous product ended at a barrier: both buffers are free
  stage_f32(stage, src, row_stride, rows, 0, H, tid);
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      // its buffer was last read in slab s - 1, which ended at a barrier
      stage_f32(stage + ((s + 1) % 2) * stage_bytes<float>(), src,
                row_stride, rows, (s + 1) * kK, H, tid);
      wait_staged<1>();
    } else {
      wait_staged<0>();
    }
    __syncthreads();  // slab s is in shared memory for every thread
    const float* hs =
        reinterpret_cast<const float*>(stage + (s % 2) * stage_bytes<float>());
#pragma unroll
    for (int kq = 0; kq < kK / 4; ++kq) {
      const int k = s * kK + 4 * kq;
      float4 wv[2][3];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          wv[e][g] = *reinterpret_cast<const float4*>(w[e][g] + k);
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(
            hs + (rg + 64 * i) * (FL::kRowBytes / 4) + 4 * kq);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float& a = acc[2 * i + e][g];
            a = fmaf(h.x, wv[e][g].x, a);
            a = fmaf(h.y, wv[e][g].y, a);
            a = fmaf(h.z, wv[e][g].z, a);
            a = fmaf(h.w, wv[e][g].w, a);
          }
      }
    }
    __syncthreads();  // every thread is done with slab s
  }
}

// c[mt][g] += the warp's 16-row m-tile mt (rows warp * 32 + 16 mt ..) of
// the staged slab s times the n-tile of gate g (the pass's 8 units), 64
// bf16 depths in four k16 steps. a_row / a_k and b_base are the lane's
// ldmatrix addresses: A (x4) row lane % 16 of the m-tile at depth
// 8 (lane / 16); B (x2) unit lane % 8 at depth 8 ((lane / 8) % 2).
__device__ __forceinline__ void mma_slab(float (&c)[2][3][4],
                                         const unsigned char* buf, int a_row,
                                         int a_k,
                                         const __nv_bfloat16* b_base,
                                         size_t gate_stride, int k0) {
  constexpr int kRowElems = BL::kRowBytes / 2;
  const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(buf);
#pragma unroll
  for (int kk = 0; kk < slab_depth<__nv_bfloat16>() / 16; ++kk) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], hs + (a_row + 16 * mt) * kRowElems + 16 * kk + a_k);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      unsigned b[2];
      ldmatrix_x2(b, b_base + g * gate_stride + k0 + 16 * kk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(c[mt][g], a[mt], b);
    }
  }
}

// bf16: one slab (64 depths) of the chunk's 256 state rows straight into
// shared memory with 16-byte cp.async.cg, 8 pieces a row and a thread;
// only when H is a multiple of 8 (every row 16-byte aligned).
__device__ __forceinline__ void stage_bf16(unsigned char* buf,
                                           const __nv_bfloat16* __restrict__ src,
                                           size_t row_stride, int rows, int k0,
                                           int H, int tid) {
#pragma unroll
  for (int q = 0; q < BL::kChunkRows * BL::kSlabBytes / 16 / kThreads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 8;
    const int k = k0 + (f % 8) * 8;
    const bool in = r < rows && k < H;
    cp_async16(buf + r * BL::kRowBytes + (f % 8) * 16,
               in ? src + r * row_stride + k : src, in);
  }
  commit_staged();
}

// The bf16 product over a chunk: c[mt][g] as mma_slab says, over all
// slabs. With kAsync (H a multiple of 8) the slabs come by cp.async
// through a ring of three buffers, two slabs in flight and one barrier a
// slab; otherwise through registers and two buffers.
template <bool kAsync>
__device__ __forceinline__ void product_bf16(
    float (&c)[2][3][4], unsigned char* stage, const __nv_bfloat16* ws,
    int WS, int U, int p0, const __nv_bfloat16* __restrict__ src,
    size_t row_stride, int rows, int H, int tid) {
  constexpr int kK = slab_depth<__nv_bfloat16>();
  constexpr int kStage = stage_bytes<__nv_bfloat16>();
  const int lane = tid % 32, warp = tid / 32;
  const bool active = warp * 32 < rows;  // the same in the whole warp
  const int n_slabs = (H + kK - 1) / kK;
  const int a_row = warp * 32 + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 8 * (lane / 16);
  const __nv_bfloat16* b_base =
      ws + (size_t)(p0 + lane % 8) * WS + 8 * ((lane / 8) % 2);
  const size_t gate_stride = (size_t)U * WS;
  if constexpr (kAsync) {
    // the previous product ended at a barrier: every buffer is free
    stage_bf16(stage, src, row_stride, rows, 0, H, tid);
    if (n_slabs > 1)
      stage_bf16(stage + kStage, src, row_stride, rows, kK, H, tid);
    for (int s = 0; s < n_slabs; ++s) {
      if (s + 1 < n_slabs)
        wait_staged<1>();
      else
        wait_staged<0>();
      // slab s is visible to all, and every thread is done with slab
      // s - 1, whose buffer takes slab s + 2
      __syncthreads();
      if (s + 2 < n_slabs)
        stage_bf16(stage + ((s + 2) % 3) * kStage, src, row_stride, rows,
                   (s + 2) * kK, H, tid);
      if (active)
        mma_slab(c, stage + (s % 3) * kStage, a_row, a_k, b_base,
                 gate_stride, s * kK);
    }
    __syncthreads();  // every thread is done with the last slabs
  } else {
    uint2 next[kLoads];
    load_state(next, src, row_stride, rows, 0, H, tid);
    __syncthreads();
    store_state(stage, next, tid);
    __syncthreads();
    for (int s = 0; s < n_slabs; ++s) {
      if (s + 1 < n_slabs)
        load_state(next, src, row_stride, rows, (s + 1) * kK, H, tid);
      if (active)
        mma_slab(c, stage + (s % 2) * kStage, a_row, a_k, b_base,
                 gate_stride, s * kK);
      if (s + 1 < n_slabs)  // the other buffer's last reads ended at a barrier
        store_state(stage + ((s + 1) % 2) * kStage, next, tid);
      __syncthreads();
    }
  }
}

template <typename E, bool kSaveGates, bool kWithH0>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const E* __restrict__ xw,            // [B, T, 3H]
               const E* __restrict__ w_h,           // [H, 3H]
               const float* __restrict__ b_h,       // [3H]
               const int32_t* __restrict__ lengths, // [B]
               const E* __restrict__ h_init,        // [B, H] (kWithH0)
               E* __restrict__ outs,                // [B, T, H]
               E* __restrict__ final_h,             // [B, H]
               E* __restrict__ gates,               // [B, T, 4H] (kSaveGates)
               float* __restrict__ carry,           // [B, H] f32 (bf16 only)
               int B, int T, int H, int U) {
  constexpr bool kLowp = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Layout<E>;
  unsigned char* stage = smem;  // [kStages][L::kChunkRows][L::kRowBytes]
  // the block's [3U + pad][WS] slice, after the staging buffers
  E* ws = reinterpret_cast<E*>(smem + L::kStages * stage_bytes<E>());
  const int WS = w_stride<E>(H);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int u0 = blockIdx.x * U;
  const int n_units = min(U, H - u0);  // > 0: the grid is ceil(H / U)
  const int H3 = 3 * H;

  // the block's slice of W_h, once: ws[g * U + j][k] = W_h[k][g H + u0 + j],
  // zero past H, past the block's units and in the pad rows
  {
    uint4* z = reinterpret_cast<uint4*>(ws);
    const int n16 =
        (int)((size_t)(3 * U + L::kPadRows) * WS * sizeof(E) / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int per_k = 3 * n_units;
    for (int i = tid; i < per_k * H; i += kThreads) {
      const int j = i % n_units, g = (i / n_units) % 3, k = i / per_k;
      ws[(size_t)(g * U + j) * WS + k] = w_h[(size_t)k * H3 + g * H + u0 + j];
    }
    __syncthreads();
  }

  for (int t = 0; t < T; ++t) {
    // the product's operand h_{t-1}: outs[:, t - 1], or h0 at t = 0
    const E* src = t > 0 ? outs + (size_t)(t - 1) * H : h_init;
    const size_t src_stride = t > 0 ? (size_t)T * H : (size_t)H;
    for (int c0 = 0; c0 < B; c0 += L::kChunkRows) {
      const int rows = min(L::kChunkRows, B - c0);
      bool mine = false;
      for (int r = tid; r < rows; r += kThreads) mine |= t < lengths[c0 + r];
      const bool product = __syncthreads_or(mine) && (t > 0 || kWithH0);
      for (int p0 = 0; p0 < n_units; p0 += kPassUnits) {
        // the thread's (row, unit) pairs and their (r, z, n) products
        constexpr int kPairs = L::kPairs;
        float acc[16][3];  // the first kPairs are used
        int prow[kPairs], plu[kPairs];
        if constexpr (!kLowp) {
          const int rg = warp * 8 + lane / 4;  // rows rg, rg + 64, ...
          const int j0 = p0 + 2 * (lane % 4);  // units j0, j0 + 1
#pragma unroll
          for (int q = 0; q < kPairs; ++q) {
            prow[q] = rg + 64 * (q / 2);
            plu[q] = j0 + q % 2;
            acc[q][0] = acc[q][1] = acc[q][2] = 0.0f;
          }
          if (product) {
            // W_h rows of units past the block's read unit 0 (discarded)
            const int ja = j0 < n_units ? j0 : 0;
            const int jb = j0 + 1 < n_units ? j0 + 1 : 0;
            const float* s0 = src + (size_t)c0 * src_stride;
            // the thread's rows that can hold a batch row: 8, 4, 2 or 1
            if (rows > 256)
              product_f32<8>(acc, stage, ws, WS, U, ja, jb, rg, s0,
                             src_stride, rows, H, tid);
            else if (rows > 128)
              product_f32<4>(acc, stage, ws, WS, U, ja, jb, rg, s0,
                             src_stride, rows, H, tid);
            else if (rows > 64)
              product_f32<2>(acc, stage, ws, WS, U, ja, jb, rg, s0,
                             src_stride, rows, H, tid);
            else
              product_f32<1>(acc, stage, ws, WS, U, ja, jb, rg, s0,
                             src_stride, rows, H, tid);
          }
        } else {
          float c[2][3][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[mt][g][e] = 0.0f;
          if (product) {
            const __nv_bfloat16* s0 = src + (size_t)c0 * src_stride;
            if (H % 8 == 0)
              product_bf16<true>(c, stage, ws, WS, U, p0, s0, src_stride,
                                 rows, H, tid);
            else
              product_bf16<false>(c, stage, ws, WS, U, p0, s0, src_stride,
                                  rows, H, tid);
          }
          // C fragment: c[.][.][2 h + e] is row lane / 4 + 8 h, column
          // 2 (lane % 4) + e of the 16 x 8 tile
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int q = mt * 4 + h * 2 + e;
                prow[q] = warp * 32 + mt * 16 + lane / 4 + 8 * h;
                plu[q] = p0 + 2 * (lane % 4) + e;
#pragma unroll
                for (int g = 0; g < 3; ++g) acc[q][g] = c[mt][g][2 * h + e];
              }
        }

        // gate math of the pairs; frozen rows copy the carried state
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          if (prow[q] >= rows || plu[q] >= n_units) continue;
          const int b = c0 + prow[q];
          const int u = u0 + plu[q];
          const size_t bu = (size_t)b * H + u;
          const size_t bt = (size_t)b * T + t;
          float h_prev;
          if (t == 0)
            h_prev = kWithH0 ? to_f(h_init[bu]) : 0.0f;
          else if constexpr (kLowp)
            h_prev = carry[bu];  // written by this thread at step t - 1
          else
            h_prev = outs[(bt - 1) * H + u];  // the f32 carry
          float h_new = h_prev;
          if (t < lengths[b]) {
            const E* x = xw + bt * H3;
            const float xr = to_f(x[u]), xz = to_f(x[H + u]),
                        xn = to_f(x[2 * H + u]);
            const float ghn = acc[q][2] + b_h[2 * H + u];
            const float r = sigmoid_f(xr + (acc[q][0] + b_h[u]));
            const float z = sigmoid_f(xz + (acc[q][1] + b_h[H + u]));
            const float n = tanhf(xn + r * ghn);
            h_new = (1.0f - z) * n + z * h_prev;
            if constexpr (kSaveGates) {
              E* gt = gates + bt * 4 * H + u;
              gt[0] = from_f<E>(r);
              gt[H] = from_f<E>(z);
              gt[2 * H] = from_f<E>(n);
              gt[3 * H] = from_f<E>(ghn);
            }
          }
          outs[bt * H + u] = from_f<E>(h_new);
          if constexpr (kLowp) carry[bu] = h_new;
          if (t == T - 1) final_h[bu] = from_f<E>(h_new);
        }
      }
    }
    if (t + 1 < T) cg::this_grid().sync();  // outs[:, t] is complete
  }
}

template <typename E, bool kSaveGates, bool kWithH0>
int launch_gru_fwd(const void* xw, const void* w_h, const float* b_h,
                   const int32_t* lengths, const void* h0, void* outs,
                   void* final_h, void* gates, float* carry, int B, int T,
                   int H, cudaStream_t stream) {
  const int sms = gru::device_sms();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  int U = units_per_block(H, sms);
  const int grid = (H + U - 1) / U;
  const E* xw_e = static_cast<const E*>(xw);
  const E* w_e = static_cast<const E*>(w_h);
  const E* h0_e = static_cast<const E*>(h0);
  E* outs_e = static_cast<E*>(outs);
  E* final_e = static_cast<E*>(final_h);
  E* gates_e = static_cast<E*>(gates);
  void* args[] = {(void*)&xw_e,    (void*)&w_e,     (void*)&b_h,
                  (void*)&lengths, (void*)&h0_e,    (void*)&outs_e,
                  (void*)&final_e, (void*)&gates_e, (void*)&carry,
                  (void*)&B,       (void*)&T,       (void*)&H,
                  (void*)&U};
  return gru::launch_cooperative(gru_fwd_kernel<E, kSaveGates, kWithH0>,
                                 grid, smem_bytes<E>(H, U), args, stream);
}

template <typename E>
int dispatch_gru_fwd(const void* xw, const void* w_h, const float* b_h,
                     const int32_t* lengths, const void* h0, void* outs,
                     void* final_h, void* gates, float* carry, int B, int T,
                     int H, cudaStream_t s) {
  if (gates != nullptr && h0 != nullptr)
    return launch_gru_fwd<E, true, true>(xw, w_h, b_h, lengths, h0, outs,
                                         final_h, gates, carry, B, T, H, s);
  if (gates != nullptr)
    return launch_gru_fwd<E, true, false>(xw, w_h, b_h, lengths, h0, outs,
                                          final_h, gates, carry, B, T, H, s);
  if (h0 != nullptr)
    return launch_gru_fwd<E, false, true>(xw, w_h, b_h, lengths, h0, outs,
                                          final_h, gates, carry, B, T, H, s);
  return launch_gru_fwd<E, false, false>(xw, w_h, b_h, lengths, h0, outs,
                                         final_h, gates, carry, B, T, H, s);
}

}  // namespace

// H must be a multiple of 4, at most cmhse_gru_fwd_max_hidden(bf16) (past
// it, gru_fwd_streamed.cu's cmhse_gru_fwd_streamed), and every pointer
// 8-byte aligned (the wrapper checks both). xw, w_h, h0, outs, final and
// gates are f32, or bf16 when bf16 != 0; b_h is f32 either way; carry is
// an f32 [B, H] scratch in bf16 (null in f32). h0 (the seeded variant) and
// gates (the gate-saving variant) may each be null; the instantiation is
// chosen by the element type and by which are given.
extern "C" int cmhse_gru_fwd(const void* xw, const void* w_h,
                             const float* b_h, const int32_t* lengths,
                             const void* h0, void* outs, void* final_h,
                             void* gates, void* carry, int B, int T, int H,
                             int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % 4 != 0 ||
      (bf16 != 0) != (carry != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* c = static_cast<float*>(carry);
  if (bf16)
    return dispatch_gru_fwd<__nv_bfloat16>(xw, w_h, b_h, lengths, h0, outs,
                                           final_h, gates, c, B, T, H, s);
  return dispatch_gru_fwd<float>(xw, w_h, b_h, lengths, h0, outs, final_h,
                                 gates, c, B, T, H, s);
}

// Largest H the resident variant takes on the current device: the block's
// W_h slice and the staging buffers must fit in one block's shared memory.
extern "C" int cmhse_gru_fwd_max_hidden(int bf16) {
  return bf16 ? gru::max_hidden(smem_bytes<__nv_bfloat16>)
              : gru::max_hidden(smem_bytes<float>);
}

// Message for an error code returned by any launcher of this library.
extern "C" const char* cmhse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
