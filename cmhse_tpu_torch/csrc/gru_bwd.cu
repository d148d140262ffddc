// Masked GRU backward time loop (BPTT) for Hopper (sm_90a), f32 and bf16.
//
// Replaces cmhse_tpu/ops/pallas_gru_grad.py:_gru_bwd_kernel, with and
// without the seeded h0, in both of its element types (the template
// parameter E). It reads the gates [r, z, n, hn] that the gate-saving
// forward (gru_fwd.cu) wrote and walks time backwards:
//
//   dh  = dh_carry + douts[t]             (dfinal seeds dh_carry at t = T-1)
//   live (t < len):
//     dn = dh (1 - z)    dz = dh (h_prev - n)    dn' = dn (1 - n^2)
//     dr = dn' hn        dhn = dn' r   dz' = dz z (1 - z)   dr' = dr r (1 - r)
//     dxw[t] = [dr', dz', dn']        dhn[t] = dhn
//     dh_carry = dh z + [dr', dz', dhn] @ W_h^T
//   masked (t >= len): dxw[t] = dhn[t] = 0, dh_carry = dh (passed through)
//   dh0 = dh_carry after the t = 0 step;  db = sums of [dr', dz', dn', dhn]
//
// with h_prev = outs[t - 1], or h0 (zeros unseeded) at t = 0. douts[t] is
// added at every step, padded ones too. A masked step selects on t < len
// and never reads its gates (the forward leaves them unwritten), so garbage
// there cannot leak in as NaN * 0.
//
// bf16 (E = __nv_bfloat16) keeps the TPU kernel's rounding points: gates,
// outs (h_prev is the bf16 output, not the forward's f32 carry), douts,
// dfinal, h0 and W_h are bf16 in memory; the carried dh, the gate gradients
// and the bias sums are f32; [dr', dz', dhn] enters the W_h^T product
// rounded to bf16 (f32 accumulation: exact products, f32 sums); dxw, dhn
// and dh0 are rounded to nearest even on store.
//
// Design. K1's split (gru_fwd.cu): one persistent cooperative grid, at most
// one block per SM. Block k owns U = max(8, ceil(H / SMs)) consecutive
// units j (8 at H = 1024: 128 blocks) and keeps their rows W_h[j, 0:3H] in
// shared memory for the whole loop (96 KB f32, 48 KB bf16 at H = 1024):
// unit j of the carried gradient needs exactly row j of W_h, K-contiguous,
// so nothing is transposed. Each step t, from T - 1 down:
//   1. for every row of the call, the gate gradients of the block's units,
//      written to dxw[:, t, units] and dhn[:, t, units] (zeros on a masked
//      step), and the f32 carry of those units: dh z live, dh masked;
//   2. one grid barrier, then, for the LIVE rows only, carry[:, units] +=
//      [dxw[:, t, 0:2H], dhn[:, t, :]] @ W_h[units, :]^T.
// There is no exchange buffer: dxw and dhn already hold the product's
// operand (in bf16 already rounded), read with L2-only loads (cp.async.cg,
// ld.global.cg), never through L1, which the grid barrier does not make
// coherent. The operand spans two arrays (dxw: stride 3H, depths 0..2H;
// dhn: stride H, depths 2H..3H); 2H is a multiple of 4, so every staged
// piece lies wholly in one of them, however a slab straddles 2H.
//
// Only live rows enter the product. It takes gru_fwd.cu's plan of the live
// rows, made once a recurrence by the wrapper on the device and handed from
// the forward to the backward: `order` sorts the rows by length, longest
// first, and counts[t] is the number live at step t, so the rows live at
// step t are the prefix order[0 : counts[t]], which the product walks in
// chunks. All four GRU kernels take this plan and walk this prefix. Each
// row's arithmetic is its own and every sum runs in a fixed order, so the
// order changes no result. A step with no live row needs neither the
// product nor the barrier, on every block alike.
//
// The f32 carry never leaves f32: it lives in dh0 itself in f32 and in a
// private f32 scratch [B, H] in bf16 (dh0 is its rounding at the end); only
// this block's threads touch its units, with a block barrier between the
// two phases' thread maps. Each phase-1 thread keeps the bias sums of its
// unit over its rows in registers; the block sums them at the end in a
// fixed order: db is written once, with no atomics, so the result is
// bitwise the same run to run. Phase 1 is elementwise and latency-bound (a
// thread walks B / 32 rows at 8 units a block), so each thread issues the
// loads of several rows before it uses any of them. Phase 1 and the bias
// sums are gru_common.cuh's, shared with gru_bwd_streamed.cu (the variant
// past cmhse_gru_bwd_max_hidden, where a block's W_h rows no longer fit).
//
// Products, per chunk of live rows and per pass of 8 units (a second pass
// when U > 8), over slabs of depth staged in shared memory:
//   f32: chunks of 128 rows, 32-depth slabs by a three-stage cp.async.cg
//   ring (two slabs in flight). FFMA on the CUDA cores (TF32 would break the
//   1e-4 parity). A thread owns 2 rows (r, r + 64) x 2 units of each pass:
//   per 4 depths two 16-byte loads of W_h and two of the rows feed 16 FMAs.
//   bf16: chunks of 256 rows, 64-depth slabs, K1's staging (a three-stage
//   cp.async ring when H % 8 == 0, every row 16-byte aligned; 8-byte
//   ld.global.cg through registers and two buffers otherwise).
//   mma.sync.m16n8k16 (bf16, f32 accumulation) with ldmatrix: a warp owns
//   32 rows (two m-tiles) x the pass's 8 units (one n-tile); the W_h slice,
//   K-contiguous per unit, is the column-major B as it stands.
//
// What bounds it on an H100 (video_low, 512 rows x 64 steps, H = 1024,
// about 27% of the row-steps live; PERF.md): the product, about 85% of a
// block's clock in f32 and 65% in bf16. Every block reads the live rows'
// whole operand, n_t x 3H, from L2 each step: about 14 GB a call in f32
// and 7 GB in bf16 over 128 blocks. They arrive at under 2 TB/s in both
// types, and the FMAs (f32) and the tensor cores (bf16) wait on them. All
// blocks walk the depth in the same order, so they read the same lines at
// about the same time; starting each block at its own slab measured
// slower, and a fourth staging buffer gained nothing. Sharing a slab among
// the blocks of a cluster (DSMEM, TMA multicast) would cut those reads.
// Phase 1 takes most of the rest; the grid barriers take under 4%.

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
using gru::kPassUnits;
using gru::kThreads;
using gru::ldmatrix_x2;
using gru::ldmatrix_x4;
using gru::mma_bf16;
using gru::operand_at;
using gru::to_f;
using gru::units_per_block;
using gru::w_stride;
using gru::wait_staged;

constexpr int kMaxPasses = 2;  // U <= 16 units a block

// How each element type stages the live rows' operand. A chunk is the rows
// one product covers; a staged row holds one slab of depths plus 16 bytes
// of padding (so that rows start in different bank groups).
template <typename E>
struct Layout;
template <>
struct Layout<float> {  // a thread: 2 rows (r, r + 64) x 2 units a pass
  static constexpr int kChunkRows = 128;
  static constexpr int kSlabBytes = 128;  // 32 depths
  static constexpr int kRowBytes = 144;
};
template <>
struct Layout<__nv_bfloat16> {  // a warp: 32 rows x 8 units (mma tiles)
  static constexpr int kChunkRows = 256;
  static constexpr int kSlabBytes = 128;  // 64 depths
  static constexpr int kRowBytes = 144;
};
constexpr int kStages = 3;  // staging buffers

template <typename E>
__host__ __device__ constexpr int slab_depth() {
  return Layout<E>::kSlabBytes / (int)sizeof(E);
}

template <typename E>
__host__ __device__ constexpr int stage_bytes() {
  return Layout<E>::kChunkRows * Layout<E>::kRowBytes;
}

// staging ring, the W_h slice [U][3H] and the chunk's batch rows
template <typename E>
size_t smem_bytes(int H, int U) {
  if (U > kMaxPasses * kPassUnits) return ~(size_t)0;
  return kStages * (size_t)stage_bytes<E>() +
         (size_t)U * w_stride<E>(3 * H) * sizeof(E) +
         Layout<E>::kChunkRows * sizeof(int);
}

// f32: slab s (32 depths) of the chunk's first `rows` rows into shared
// memory, 16-byte cp.async.cg pieces, 4 a thread; depths past 3H
// zero-filled. Rows past `rows` are not staged (their sums are discarded).
__device__ __forceinline__ void stage_f32(unsigned char* buf,
                                          const float* __restrict__ dxw,
                                          const float* __restrict__ dhn,
                                          const int* rows_s, int rows, int s,
                                          int t, int T, int H, int tid) {
  using FL = Layout<float>;
  constexpr int kPieces = FL::kSlabBytes / 16;  // a row's pieces in a slab
#pragma unroll
  for (int q = 0; q < FL::kChunkRows * kPieces / kThreads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / kPieces;
    if (r >= rows) continue;
    const int k = s * slab_depth<float>() + (f % kPieces) * 4;
    const bool in = k < 3 * H;
    cp_async16(buf + r * FL::kRowBytes + (f % kPieces) * 16,
               in ? operand_at(dxw, dhn, rows_s[r], t, T, H, k) : dxw, in);
  }
  commit_staged();
}

// acc[p][i][e] = operand row (rg + 64 i) . W_h row (8 p + ju + e) of the
// block over all 3H depths. kRows (1 or 2) and kPasses are template
// parameters, so that no branch stands between a load and its FMAs. W_h
// rows past the block's units read row 0 (their sums are discarded).
template <int kRows, int kPasses>
__device__ __forceinline__ void product_f32(
    float (&acc)[kMaxPasses][2][2], unsigned char* stage, const float* ws,
    int WS, int n_units, int rg, int ju, const float* __restrict__ dxw,
    const float* __restrict__ dhn, const int* rows_s, int rows, int t, int T,
    int H, int tid) {
  using FL = Layout<float>;
  constexpr int kK = slab_depth<float>();
  constexpr int kStage = stage_bytes<float>();
  const float* w[kPasses][2];
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = kPassUnits * p + ju + e;
      w[p][e] = ws + (size_t)(j < n_units ? j : 0) * WS;
    }
  const int n_slabs = (3 * H + kK - 1) / kK;
  // turn s into its buffer; past the last slab an empty group, so that
  // every turn commits one and the wait below keeps one count
  auto stage_turn = [&](int s) {
    if (s < n_slabs)
      stage_f32(stage + (s % kStages) * kStage, dxw, dhn, rows_s, rows,
                s, t, T, H, tid);
    else
      commit_staged();
  };
  // the previous product ended at a barrier: every buffer is free
  for (int s = 0; s < kStages - 1; ++s) stage_turn(s);
  for (int s = 0; s < n_slabs; ++s) {
    wait_staged<kStages - 2>();
    // slab s is visible to all, and every thread is done with slab s - 1,
    // whose buffer takes turn s + kStages - 1
    __syncthreads();
    stage_turn(s + kStages - 1);
    const float* hs =
        reinterpret_cast<const float*>(stage + (s % kStages) * kStage);
#pragma unroll
    for (int kq = 0; kq < kK / 4; ++kq) {
      const int k = s * kK + 4 * kq;
      float4 wv[kPasses][2];
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wv[p][e] = *reinterpret_cast<const float4*>(w[p][e] + k);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(
            hs + (rg + 64 * i) * (FL::kRowBytes / 4) + 4 * kq);
#pragma unroll
        for (int p = 0; p < kPasses; ++p)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& a = acc[p][i][e];
            a = fmaf(h.x, wv[p][e].x, a);
            a = fmaf(h.y, wv[p][e].y, a);
            a = fmaf(h.z, wv[p][e].z, a);
            a = fmaf(h.w, wv[p][e].w, a);
          }
      }
    }
  }
  __syncthreads();  // every thread is done with the last slabs
}

// bf16: slab s (64 depths) of the chunk's first `rows` rows, 16-byte
// cp.async.cg pieces, 8 a thread; only when H is a multiple of 8.
__device__ __forceinline__ void stage_bf16(
    unsigned char* buf, const __nv_bfloat16* __restrict__ dxw,
    const __nv_bfloat16* __restrict__ dhn, const int* rows_s, int rows, int s,
    int t, int T, int H, int tid) {
  using BL = Layout<__nv_bfloat16>;
#pragma unroll
  for (int q = 0; q < BL::kChunkRows * BL::kSlabBytes / 16 / kThreads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 8;
    if (r >= rows) continue;
    const int k = s * slab_depth<__nv_bfloat16>() + (f % 8) * 8;
    const bool in = k < 3 * H;
    cp_async16(buf + r * BL::kRowBytes + (f % 8) * 16,
               in ? operand_at(dxw, dhn, rows_s[r], t, T, H, k) : dxw, in);
  }
  commit_staged();
}

// bf16 for any H % 4 == 0: a slab as 8-byte L2-coherent loads into
// registers (16 a thread: 16 threads read a row's 128 bytes), then stored
// to shared memory. Depths past 3H read as 0.
constexpr int kLoads = Layout<__nv_bfloat16>::kChunkRows *
                       Layout<__nv_bfloat16>::kSlabBytes / 8 / kThreads;

__device__ __forceinline__ void load_slab(
    uint2 (&v)[kLoads], const __nv_bfloat16* __restrict__ dxw,
    const __nv_bfloat16* __restrict__ dhn, const int* rows_s, int rows, int s,
    int t, int T, int H, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 16;
    const int k = s * slab_depth<__nv_bfloat16>() + (f % 16) * 4;
    v[q] = (r < rows && k < 3 * H)
               ? __ldcg(reinterpret_cast<const uint2*>(
                     operand_at(dxw, dhn, rows_s[r], t, T, H, k)))
               : make_uint2(0u, 0u);
  }
}

__device__ __forceinline__ void store_slab(unsigned char* buf,
                                           const uint2 (&v)[kLoads], int tid) {
  using BL = Layout<__nv_bfloat16>;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    *reinterpret_cast<uint2*>(buf + (f / 16) * BL::kRowBytes + (f % 16) * 8) =
        v[q];
  }
}

// c[mt][p] += the warp's m-tile mt (rows warp * 32 + 16 mt ..) of staged
// slab s times the n-tile of pass p (8 units), 64 depths in four k16
// steps. a_row / a_k and b_base[p] are the lane's ldmatrix addresses: A
// (x4) row lane % 16 of the m-tile at depth 8 (lane / 16); B (x2) unit
// lane % 8 at depth 8 ((lane / 8) % 2).
template <int kPasses>
__device__ __forceinline__ void mma_slab(
    float (&c)[2][kMaxPasses][4], const unsigned char* buf, int a_row,
    int a_k, const __nv_bfloat16* const (&b_base)[kMaxPasses], int k0) {
  constexpr int kRowElems = Layout<__nv_bfloat16>::kRowBytes / 2;
  const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(buf);
#pragma unroll
  for (int kk = 0; kk < slab_depth<__nv_bfloat16>() / 16; ++kk) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], hs + (a_row + 16 * mt) * kRowElems + 16 * kk + a_k);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      unsigned b[2];
      ldmatrix_x2(b, b_base[p] + k0 + 16 * kk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(c[mt][p], a[mt], b);
    }
  }
}

// The bf16 product over a chunk: c as mma_slab says, over all slabs. With
// kAsync (H a multiple of 8) the slabs come by cp.async through a ring of
// three buffers, two slabs in flight and one barrier a slab; otherwise
// through registers and two buffers.
template <bool kAsync, int kPasses>
__device__ __forceinline__ void product_bf16(
    float (&c)[2][kMaxPasses][4], unsigned char* stage,
    const __nv_bfloat16* ws, int WS, int n_units,
    const __nv_bfloat16* __restrict__ dxw,
    const __nv_bfloat16* __restrict__ dhn, const int* rows_s, int rows,
    int t, int T, int H, int tid) {
  constexpr int kK = slab_depth<__nv_bfloat16>();
  constexpr int kStage = stage_bytes<__nv_bfloat16>();
  const int lane = tid % 32, warp = tid / 32;
  const bool active = warp * 32 < rows;  // the same in the whole warp
  const int n_slabs = (3 * H + kK - 1) / kK;
  const int a_row = warp * 32 + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 8 * (lane / 16);
  const __nv_bfloat16* b_base[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int j = kPassUnits * p + lane % 8;  // past the units: row 0
    b_base[p] = ws + (size_t)(j < n_units ? j : 0) * WS + 8 * ((lane / 8) % 2);
  }
  if constexpr (kAsync) {
    auto stage_turn = [&](int s) {  // as in product_f32
      if (s < n_slabs)
        stage_bf16(stage + (s % kStages) * kStage, dxw, dhn, rows_s, rows,
                   s, t, T, H, tid);
      else
        commit_staged();
    };
    for (int s = 0; s < kStages - 1; ++s) stage_turn(s);
    for (int s = 0; s < n_slabs; ++s) {
      wait_staged<kStages - 2>();
      __syncthreads();  // as in product_f32
      stage_turn(s + kStages - 1);
      if (active)
        mma_slab<kPasses>(c, stage + (s % kStages) * kStage, a_row, a_k,
                          b_base, s * kK);
    }
    __syncthreads();  // every thread is done with the last slabs
  } else {
    uint2 next[kLoads];
    load_slab(next, dxw, dhn, rows_s, rows, 0, t, T, H, tid);
    store_slab(stage, next, tid);
    __syncthreads();
    for (int s = 0; s < n_slabs; ++s) {
      if (s + 1 < n_slabs)
        load_slab(next, dxw, dhn, rows_s, rows, s + 1, t, T, H, tid);
      if (active)
        mma_slab<kPasses>(c, stage + (s % 2) * kStage, a_row, a_k, b_base,
                          s * kK);
      if (s + 1 < n_slabs)  // the other buffer's last reads ended at a barrier
        store_slab(stage + ((s + 1) % 2) * kStage, next, tid);
      __syncthreads();
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const E* __restrict__ gates,          // [B, T, 4H]
               const E* __restrict__ outs,           // [B, T, H]
               const E* __restrict__ h_init,         // [B, H] or null
               const E* __restrict__ douts,          // [B, T, H] or null
               const E* __restrict__ dfinal,         // [B, H] or null
               const int32_t* __restrict__ lengths,  // [B]
               const int32_t* __restrict__ order,    // [B] by length, desc.
               const int32_t* __restrict__ counts,   // [T] live rows a step
               const E* __restrict__ w_h,            // [H, 3H]
               E* __restrict__ dxw,                  // [B, T, 3H]
               E* __restrict__ dhn_out,              // [B, T, H]
               float* __restrict__ db,               // [4H]
               E* __restrict__ dh0,                  // [B, H]
               float* __restrict__ carry,            // [B, H] f32
               int B, int T, int H, int U) {
  constexpr bool kLowp = std::is_same<E, __nv_bfloat16>::value;
  using L = Layout<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // [kStages][L::kChunkRows][L::kRowBytes]
  E* ws = reinterpret_cast<E*>(smem + kStages * stage_bytes<E>());
  const int WS = w_stride<E>(3 * H);
  int* rows_s = reinterpret_cast<int*>(ws + (size_t)U * WS);  // chunk's rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int u0 = blockIdx.x * U;
  const int n_units = min(U, H - u0);  // > 0: the grid is ceil(H / U)
  const int H3 = 3 * H;
  const int passes = (n_units + kPassUnits - 1) / kPassUnits;

  // the block's rows of W_h, once: ws[j][k] = W_h[u0 + j][k], zero past 3H
  {
    uint4* z = reinterpret_cast<uint4*>(ws);
    const int n16 = (int)((size_t)U * WS * sizeof(E) / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int i = tid; i < n_units * H3; i += kThreads)
      ws[(size_t)(i / H3) * WS + i % H3] = w_h[(size_t)u0 * H3 + i];
    __syncthreads();
  }

  // Phase 1's map: thread (r1, j) takes unit u0 + j of rows r1, r1 + sweep,
  // ... at every step, and keeps that unit's bias sums over them.
  const int sweep = kThreads / n_units;
  const int j1 = tid % n_units, r1 = tid / n_units;
  const bool in_p1 = r1 < sweep;
  const int u1 = u0 + j1;
  float db_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the unit's bias sums
  if (in_p1)
    for (int b = r1; b < B; b += sweep)
      carry[(size_t)b * H + u1] =
          dfinal != nullptr ? to_f(dfinal[(size_t)b * H + u1]) : 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase 1: gate gradients of the block's units, every row --------
    if (in_p1)
      gru::bwd_gate_grads<E>(t, r1, sweep, u1, B, T, H, gates, outs, h_init,
                             douts, lengths, dxw, dhn_out, carry, db_part);

    const int n_t = counts[t];  // live rows: the prefix order[0 : n_t]
    if (n_t == 0) continue;  // the same on every block: no barrier needed

    // ---- phase 2: carry[live, units] += operand[live] @ W_h[units]^T ----
    cg::this_grid().sync();  // dxw[:, t] and dhn[:, t] are complete
    for (int c0 = 0; c0 < n_t; c0 += L::kChunkRows) {
      const int rows = min(L::kChunkRows, n_t - c0);
      for (int r = tid; r < rows; r += kThreads) rows_s[r] = order[c0 + r];
      __syncthreads();
      if constexpr (!kLowp) {
        const int rg = warp * 8 + lane / 4;  // rows rg, rg + 64
        const int ju = 2 * (lane % 4);       // units ju, ju + 1 of a pass
        const int b_row[2] = {rg < rows ? rows_s[rg] : 0,
                              rg + 64 < rows ? rows_s[rg + 64] : 0};
        float acc[kMaxPasses][2][2] = {};
        const bool two = rows > 64;
        if (passes == 1 && !two)
          product_f32<1, 1>(acc, stage, ws, WS, n_units, rg, ju, dxw,
                            dhn_out, rows_s, rows, t, T, H, tid);
        else if (passes == 1)
          product_f32<2, 1>(acc, stage, ws, WS, n_units, rg, ju, dxw,
                            dhn_out, rows_s, rows, t, T, H, tid);
        else if (!two)
          product_f32<1, 2>(acc, stage, ws, WS, n_units, rg, ju, dxw,
                            dhn_out, rows_s, rows, t, T, H, tid);
        else
          product_f32<2, 2>(acc, stage, ws, WS, n_units, rg, ju, dxw,
                            dhn_out, rows_s, rows, t, T, H, tid);
#pragma unroll
        for (int p = 0; p < kMaxPasses; ++p)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = kPassUnits * p + ju + e;
              if (rg + 64 * i < rows && j < n_units)
                carry[(size_t)b_row[i] * H + u0 + j] += acc[p][i][e];
            }
      } else {
        // C fragment: c[mt][p][2 h + e] is row lane / 4 + 8 h of m-tile mt,
        // unit 2 (lane % 4) + e of pass p
        int b_row[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 32 + mt * 16 + lane / 4 + 8 * h;
            b_row[mt][h] = r < rows ? rows_s[r] : 0;
          }
        float c[2][kMaxPasses][4] = {};
        if (H % 8 == 0 && passes == 1)
          product_bf16<true, 1>(c, stage, ws, WS, n_units, dxw, dhn_out,
                                rows_s, rows, t, T, H, tid);
        else if (H % 8 == 0)
          product_bf16<true, 2>(c, stage, ws, WS, n_units, dxw, dhn_out,
                                rows_s, rows, t, T, H, tid);
        else if (passes == 1)
          product_bf16<false, 1>(c, stage, ws, WS, n_units, dxw, dhn_out,
                                 rows_s, rows, t, T, H, tid);
        else
          product_bf16<false, 2>(c, stage, ws, WS, n_units, dxw, dhn_out,
                                 rows_s, rows, t, T, H, tid);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < kMaxPasses; ++p)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = warp * 32 + mt * 16 + lane / 4 + 8 * h;
                const int j = kPassUnits * p + 2 * (lane % 4) + e;
                if (r < rows && j < n_units)
                  carry[(size_t)b_row[mt][h] * H + u0 + j] +=
                      c[mt][p][2 * h + e];
              }
      }
      // the next chunk's rows_s is written after the product's last
      // barrier, once every thread holds its rows in registers
    }
    __syncthreads();  // the carry is complete for the next step's phase 1
  }

  // the staging buffers are free for the bias sums' partials
  gru::bwd_finish<E>(db_part, reinterpret_cast<float*>(stage), in_p1, r1,
                     sweep, u1, u0, n_units, B, H, carry, dh0, db, tid);
}

template <typename E>
int launch_gru_bwd(const void* gates, const void* outs, const void* h0,
                   const void* douts, const void* dfinal,
                   const int32_t* lengths, const int32_t* order,
                   const int32_t* counts, const void* w_h, void* dxw,
                   void* dhn, float* db, void* dh0, float* carry, int B,
                   int T, int H, cudaStream_t stream) {
  const int sms = gru::device_sms();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  int U = units_per_block(H, sms);
  const size_t smem = smem_bytes<E>(H, U);
  if (smem == ~(size_t)0) return (int)cudaErrorInvalidValue;
  const int grid = (H + U - 1) / U;
  const E* gates_e = static_cast<const E*>(gates);
  const E* outs_e = static_cast<const E*>(outs);
  const E* h0_e = static_cast<const E*>(h0);
  const E* douts_e = static_cast<const E*>(douts);
  const E* dfinal_e = static_cast<const E*>(dfinal);
  const E* w_e = static_cast<const E*>(w_h);
  E* dxw_e = static_cast<E*>(dxw);
  E* dhn_e = static_cast<E*>(dhn);
  E* dh0_e = static_cast<E*>(dh0);
  void* args[] = {(void*)&gates_e, (void*)&outs_e,   (void*)&h0_e,
                  (void*)&douts_e, (void*)&dfinal_e, (void*)&lengths,
                  (void*)&order,   (void*)&counts,   (void*)&w_e,
                  (void*)&dxw_e,   (void*)&dhn_e,    (void*)&db,
                  (void*)&dh0_e,   (void*)&carry,    (void*)&B,
                  (void*)&T,       (void*)&H,        (void*)&U};
  return gru::launch_cooperative(gru_bwd_kernel<E>, grid, smem, args,
                                 stream);
}

}  // namespace

// H must be a multiple of 4, at most cmhse_gru_bwd_max_hidden(bf16), and
// every pointer 16-byte aligned (the wrapper checks all three). gates, outs,
// h0, douts, dfinal, w_h, dxw, dhn and dh0 are f32, or bf16 when bf16 != 0;
// db [4H] is f32 either way. order [B] (int32) is the rows sorted by
// length, longest first (any order of equal lengths), and counts [T] (int32)
// the live rows of each step (the rows with t < length), both on the device:
// gru_fwd's plan. carry is an f32 [B, H] scratch in bf16 and null in f32
// (dh0 carries). h0, douts and dfinal may each be null.
extern "C" int cmhse_gru_bwd(const void* gates, const void* outs,
                             const void* h0, const void* douts,
                             const void* dfinal, const int32_t* lengths,
                             const int32_t* order, const int32_t* counts,
                             const void* w_h, void* dxw, void* dhn, float* db,
                             void* dh0, void* carry, int B, int T, int H,
                             int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % 4 != 0 || dh0 == nullptr ||
      (bf16 != 0) != (carry != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_gru_bwd<__nv_bfloat16>(
        gates, outs, h0, douts, dfinal, lengths, order, counts, w_h, dxw, dhn,
        db, dh0, static_cast<float*>(carry), B, T, H, s);
  return launch_gru_bwd<float>(gates, outs, h0, douts, dfinal, lengths,
                               order, counts, w_h, dxw, dhn, db, dh0,
                               static_cast<float*>(dh0), B, T, H, s);
}

// Largest H the kernel takes on the current device: the block's W_h rows
// and the staging ring must fit in one block's shared memory.
extern "C" int cmhse_gru_bwd_max_hidden(int bf16) {
  return bf16 ? gru::max_hidden(smem_bytes<__nv_bfloat16>)
              : gru::max_hidden(smem_bytes<float>);
}
