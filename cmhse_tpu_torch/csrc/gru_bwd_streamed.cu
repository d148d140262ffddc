// Masked GRU backward time loop (BPTT) for Hopper (sm_90a), f32 and bf16:
// the streamed-W_h variant of gru_bwd.cu, for H past
// cmhse_gru_bwd_max_hidden, where a block's rows of W_h no longer fit in
// shared memory beside its staging buffers.
//
// Replaces cmhse_tpu/ops/pallas_gru_grad.py:_gru_bwd_kernel as gru_bwd.cu
// does, with and without the seeded h0, in both element types, with
// gru_bwd.cu's contract and rounding points (see the header there). Every
// output is the same sum in the same order as in gru_bwd.cu's kernel: phase
// 1 and the bias sums are the same code (gru_common.cuh) on the same unit
// split; each (row, unit) of the product is one fmaf chain over depth
// 0 .. 3H - 1, 4 depths at a time, from zero, then one carry += (f32), or
// the same mma.sync k16 steps in the same depth order from zero, then one
// carry += (bf16). So the two variants agree bit for bit where both run.
//
// Design. gru_bwd.cu's split: one persistent cooperative grid, at most one
// block per SM, block k owning U = max(8, ceil(H / SMs)) consecutive units
// (16 at H = 2,048: 128 blocks). Each step t, from T - 1 down: phase 1, the
// gate gradients of the block's units for every row; then one grid barrier
// and carry[live, units] += [dxw[:, t, 0:2H], dhn[:, t]] @ W_h[units]^T
// over the live rows, the operand read from dxw and dhn with L2-only
// copies (cp.async.cg, ld.global.cg), never through L1, which the grid
// barrier does not make coherent. What differs:
//
// - W_h through shared memory. Each depth slab of the block's W_h rows is
//   staged together with the operand slab, in one ring of cp.async stages
//   (f32: 32-depth slabs, 4 stages; bf16: 64-depth slabs, 3 stages), so the
//   product reads shared memory only. Row u0 + j of W_h [H, 3H] is unit j's
//   K-contiguous row, so the pieces come straight from W_h (no scratch, no
//   transpose): 16 bytes each (cp.async.cg) when W_h's rows are 16-byte
//   aligned (always in f32; H % 8 == 0 in bf16), else kNarrowBytes each
//   (cp.async.ca: W_h is read-only for the call). A staged row, of the
//   operand or of W_h, is a slab plus 16 bytes, so that 8 rows start in 8
//   different bank groups (the f32 float4 loads, the bf16 ldmatrix rows).
// - One sweep of the operand a step. The block's units are split across
//   its warps in slots: 8 units a slot in f32 (a thread owns 8 rows x 2
//   units: per 4 depths 8 + 2 shared float4 loads feed 64 FMAs), 16 in bf16
//   (a warp owns 32 rows, two m-tiles, x 16 units, two n-tiles; B by
//   ldmatrix). With S slots a chunk is 512 / S rows in f32 (S >= 2: 256 at
//   U = 16) and 256 / S in bf16 (S >= 1), and each operand slab is read
//   from L2 once for all of the block's units, up to 64 (H = 8,448 on 132
//   SMs); past that the units go in groups of 64, each re-reading the chunk.
// - Live rows from the wrapper: `order` sorts the rows by length, longest
//   first, and counts[t] is the number live at step t, so the product walks
//   the prefix order[0 : counts[t]] in chunks. A step with no live row
//   needs no product and no grid barrier, on every block alike.
// - bf16 with H not a multiple of 8 (the operand's rows 8-byte aligned
//   only): the operand slab comes by 8-byte ld.global.cg through registers
//   into two buffers, the W_h slab by cp.async beside it, as in gru_bwd.cu.
// - Phase 1 keeps one unit a thread of a row sweep, so U is at most
//   kThreads: H up to 256 x the SM count (the wrapper refuses more).
//
// What bounds it on an H100 (video_low, 512 rows x 64 steps, H = 2,048,
// 27% of the row-steps live; PERF.md, scripts/gru_bwd_streamed_variants.py's
// clock split): the product, 89% of block 0's clock in f32 and 68% in bf16.
// Every block still reads the live rows' whole operand, n_t x 3H, from L2
// each step (about 28 GB a call in f32, 14 GB in bf16, over 128 blocks),
// and it arrives at about 1.8 TB/s (f32) and 2.7 TB/s (bf16) in all: the
// FMAs run at about a fifth of their peak. Phase 1 takes 8% (f32) and 25%
// (bf16), the grid barriers 1-3%. W_h in 4-byte pieces, the parent's 2 x 2
// f32 tile and 3 f32 stages measured slower; 4 bf16 stages gained nothing.
// Sharing each operand slab among the blocks of a cluster would cut the L2
// reads.

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
using gru::kThreads;
using gru::ldmatrix_x4;
using gru::mma_bf16;
using gru::operand_at;
using gru::to_f;
using gru::wait_staged;

// How each element type stages a slab and splits the product.
template <typename E>
struct Plan;
template <>
struct Plan<float> {
  static constexpr int kThreadRows = 8;  // a thread: 8 rows x 2 units
  static constexpr int kDepth = 32;      // depths a slab
  static constexpr int kRowBytes = 144;  // a staged row of a slab
  static constexpr int kSlotUnits = 8;   // units a slot: 4 lanes x 2
  static constexpr int kSlotRows = 512;  // chunk rows x slots
  static constexpr int kMinSlots = 2;    // the smem ring's size caps chunks
  static constexpr int kMaxSlots = 8;
  static constexpr int kStages = 4;
};
template <>
struct Plan<__nv_bfloat16> {
  static constexpr int kDepth = 64;
  static constexpr int kRowBytes = 144;
  static constexpr int kSlotUnits = 16;  // a warp's two n-tiles
  static constexpr int kSlotRows = 256;
  static constexpr int kMinSlots = 1;
  static constexpr int kMaxSlots = 4;
  static constexpr int kStages = 3;
};

// W_h pieces when its rows are not 16-byte aligned (bf16, H % 8 != 0)
constexpr int kNarrowBytes = 8;

// Slots of a block of U units: enough to cover them, a power of two.
template <typename E>
__host__ __device__ int slots(int U) {
  using P = Plan<E>;
  int s = P::kMinSlots;
  while (s < P::kMaxSlots && s * P::kSlotUnits < U) s *= 2;
  return s;
}

template <typename E>
__host__ __device__ int chunk_rows(int S) {
  return Plan<E>::kSlotRows / S;
}

// bytes of a stage's operand part, then of the whole stage (W_h after it)
template <typename E>
__host__ __device__ int operand_bytes(int S) {
  return chunk_rows<E>(S) * Plan<E>::kRowBytes;
}

template <typename E>
__host__ __device__ int stage_bytes(int S) {
  return operand_bytes<E>(S) + S * Plan<E>::kSlotUnits * Plan<E>::kRowBytes;
}

// the ring, then the chunk's batch rows
template <typename E>
size_t smem_bytes(int U) {
  const int S = slots<E>(U);
  return (size_t)Plan<E>::kStages * stage_bytes<E>(S) +
         chunk_rows<E>(S) * sizeof(int);
}

// What a product needs to stage its slabs: the chunk's operand rows at
// step t and the group's W_h rows.
template <typename E>
struct Slabs {
  unsigned char* ring;
  int stage, operand;  // bytes: a stage, its operand part
  const E* dxw;
  const E* dhn;
  int t, T, H;
  const int* rows_s;  // the chunk's batch rows
  int rows;
  const E* w_h;
  int u0g, nug, Ug;  // the group's first unit, its units, units staged
  bool wide;         // W_h in 16-byte pieces
};

// Operand slab s of the chunk's first `rows` rows, 16-byte cp.async.cg
// pieces; depths past 3H are zero. Rows past `rows` are not staged (their
// sums are discarded).
template <typename E>
__device__ __forceinline__ void stage_operand(unsigned char* buf,
                                              const Slabs<E>& sl, int s,
                                              int tid) {
  using P = Plan<E>;
  constexpr int kPieces = P::kDepth * (int)sizeof(E) / 16;  // a row's
  constexpr int kElems = 16 / (int)sizeof(E);
  for (int f = tid; f < sl.rows * kPieces; f += kThreads) {
    const int r = f / kPieces, p = f % kPieces;
    const int k = s * P::kDepth + p * kElems;
    const bool in = k < 3 * sl.H;
    cp_async16(buf + r * P::kRowBytes + p * 16,
               in ? operand_at(sl.dxw, sl.dhn, sl.rows_s[r], sl.t, sl.T,
                               sl.H, k)
                  : sl.dxw,
               in);
  }
}

// W_h slab s of the group's units: wbuf + j * kRowBytes holds unit u0g + j
// at depths s kDepth ..; units past the group's and depths past 3H are
// zero. Pieces of kBytes: 16 by cp.async.cg, fewer by cp.async.ca.
template <typename E, int kBytes>
__device__ __forceinline__ void stage_w_pieces(unsigned char* wbuf,
                                               const Slabs<E>& sl, int s,
                                               int tid) {
  using P = Plan<E>;
  constexpr int kPer = kBytes / (int)sizeof(E);  // depths a piece
  constexpr int kPieces = P::kDepth / kPer;      // a unit row's
  const int H3 = 3 * sl.H;
  for (int f = tid; f < sl.Ug * kPieces; f += kThreads) {
    const int j = f / kPieces, p = f % kPieces;
    const int k = s * P::kDepth + p * kPer;
    const bool in = j < sl.nug && k < H3;
    unsigned char* dst = wbuf + j * P::kRowBytes + p * kBytes;
    const E* src = in ? sl.w_h + (size_t)(sl.u0g + j) * H3 + k : sl.w_h;
    if constexpr (kBytes == 16)
      cp_async16(dst, src, in);
    else
      gru::cp_async_ca<kBytes>(dst, src, in);
  }
}

template <typename E>
__device__ __forceinline__ void stage_w(unsigned char* wbuf,
                                        const Slabs<E>& sl, int s, int tid) {
  if (sl.wide)
    stage_w_pieces<E, 16>(wbuf, sl, s, tid);
  else
    stage_w_pieces<E, kNarrowBytes>(wbuf, sl, s, tid);
}

// The cp.async ring over all slabs: kStages - 1 slabs in flight, one block
// barrier a slab; compute(buf) multiplies the slab in buf. Every turn
// commits one group (an empty one past the last slab), so one wait count
// serves all.
template <typename E, typename Compute>
__device__ __forceinline__ void over_slabs(const Slabs<E>& sl, int tid,
                                           Compute compute) {
  constexpr int kStages = Plan<E>::kStages;
  const int n_slabs = (3 * sl.H + Plan<E>::kDepth - 1) / Plan<E>::kDepth;
  auto turn = [&](int s) {
    if (s < n_slabs) {
      unsigned char* buf = sl.ring + (s % kStages) * sl.stage;
      stage_operand<E>(buf, sl, s, tid);
      stage_w<E>(buf + sl.operand, sl, s, tid);
    }
    commit_staged();
  };
  // the previous product ended at a barrier: every buffer is free
  for (int s = 0; s < kStages - 1; ++s) turn(s);
  for (int s = 0; s < n_slabs; ++s) {
    wait_staged<kStages - 2>();
    // slab s is visible to all, and every thread is done with slab s - 1,
    // whose buffer takes turn s + kStages - 1
    __syncthreads();
    turn(s + kStages - 1);
    compute(sl.ring + (s % kStages) * sl.stage);
  }
  __syncthreads();  // every thread is done with the last slabs
}

using FP = Plan<float>;

// f32: acc[i][e] = operand row (rg + rstride i) of the chunk . W_h row
// (unit jw + e of the group), over every depth, for i < kIters: per 4
// depths two 16-byte loads of W_h and kIters of the rows feed 8 kIters
// FMAs, in gru_bwd.cu's order. kIters is a template parameter so that no
// branch stands between a load and its FMAs.
template <int kIters>
__device__ __forceinline__ void product_f32(
    float (&acc)[FP::kThreadRows][2], const Slabs<float>& sl, int rg,
    int rstride, int jw, int tid) {
  constexpr int kRowFloats = FP::kRowBytes / 4;
  over_slabs<float>(sl, tid, [&](const unsigned char* buf) {
    const float* hs = reinterpret_cast<const float*>(buf);
    const float* ws =
        reinterpret_cast<const float*>(buf + sl.operand) + jw * kRowFloats;
#pragma unroll
    for (int kq = 0; kq < FP::kDepth / 4; ++kq) {
      float4 wv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wv[e] = *reinterpret_cast<const float4*>(ws + e * kRowFloats +
                                                 4 * kq);
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(
            hs + (rg + rstride * i) * kRowFloats + 4 * kq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& a = acc[i][e];
          a = fmaf(h.x, wv[e].x, a);
          a = fmaf(h.y, wv[e].y, a);
          a = fmaf(h.z, wv[e].z, a);
          a = fmaf(h.w, wv[e].w, a);
        }
      }
    }
  });
}

// product_f32 at the least kIters that covers the chunk's rows.
template <int kIters = 1>
__device__ __forceinline__ void product_f32_rows(
    int iters, float (&acc)[FP::kThreadRows][2], const Slabs<float>& sl,
    int rg, int rstride, int jw, int tid) {
  if constexpr (kIters < FP::kThreadRows) {
    if (iters > kIters) {
      product_f32_rows<kIters + 1>(iters, acc, sl, rg, rstride, jw, tid);
      return;
    }
  }
  product_f32<kIters>(acc, sl, rg, rstride, jw, tid);
}

using BP = Plan<__nv_bfloat16>;

// bf16: c[mt][nt] += the warp's m-tile mt (chunk rows a_base + 16 mt ..) of
// the staged operand slab times n-tile nt (units n_base + 8 nt of the
// group), 64 depths in four k16 steps. A by ldmatrix (x4: row lane % 16 of
// the m-tile at depth 8 (lane / 16)); B by ldmatrix from the W_h rows, the
// column-major B as they stand (x4: unit lane % 8 + 8 (lane / 16) at depth
// 8 ((lane / 8) % 2): both n-tiles).
__device__ __forceinline__ void mma_slab(float (&c)[2][2][4],
                                         const unsigned char* buf,
                                         const Slabs<__nv_bfloat16>& sl,
                                         int a_base, int n_base, int lane) {
  constexpr int kRowElems = BP::kRowBytes / 2;
  const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(buf);
  const int a_row = a_base + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 8 * (lane / 16);
  const __nv_bfloat16* ws =
      reinterpret_cast<const __nv_bfloat16*>(buf + sl.operand) +
      (n_base + 8 * (lane / 16) + lane % 8) * kRowElems + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < BP::kDepth / 16; ++kk) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], hs + (a_row + 16 * mt) * kRowElems + 16 * kk + a_k);
    unsigned b[4];
    ldmatrix_x4(b, ws + 16 * kk);
    const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(c[mt][0], a[mt], b0);
      mma_bf16(c[mt][1], a[mt], b1);
    }
  }
}

// bf16, H not a multiple of 8: one operand slab of the chunk's rows into
// registers, 8-byte L2-coherent loads (16 threads a row's 128 bytes), then
// into shared memory. Depths past 3H read as 0 (3H is a multiple of 4).
constexpr int kLoads = BP::kSlotRows * BP::kDepth * 2 / 8 / kThreads;

__device__ __forceinline__ void load_operand(
    uint2 (&v)[kLoads], const Slabs<__nv_bfloat16>& sl, int s, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 16;
    const int k = s * BP::kDepth + (f % 16) * 4;
    v[q] = (r < sl.rows && k < 3 * sl.H)
               ? __ldcg(reinterpret_cast<const uint2*>(operand_at(
                     sl.dxw, sl.dhn, sl.rows_s[r], sl.t, sl.T, sl.H, k)))
               : make_uint2(0u, 0u);
  }
}

__device__ __forceinline__ void store_operand(unsigned char* buf,
                                              const uint2 (&v)[kLoads],
                                              int rows, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    if (f / 16 < rows)
      *reinterpret_cast<uint2*>(buf + (f / 16) * BP::kRowBytes +
                                (f % 16) * 8) = v[q];
  }
}

// The bf16 product of a chunk and a unit group over every slab: through
// the ring when H is a multiple of 8, else through registers and two of
// its buffers (the W_h slab by cp.async beside the loads).
__device__ __forceinline__ void product_bf16(float (&c)[2][2][4],
                                             const Slabs<__nv_bfloat16>& sl,
                                             bool active, int a_base,
                                             int n_base, int tid) {
  const int lane = tid % 32;
  if (sl.H % 8 == 0) {
    over_slabs<__nv_bfloat16>(sl, tid, [&](const unsigned char* buf) {
      if (active) mma_slab(c, buf, sl, a_base, n_base, lane);
    });
    return;
  }
  const int n_slabs = (3 * sl.H + BP::kDepth - 1) / BP::kDepth;
  uint2 next[kLoads];
  load_operand(next, sl, 0, tid);
  stage_w<__nv_bfloat16>(sl.ring + sl.operand, sl, 0, tid);
  commit_staged();
  store_operand(sl.ring, next, sl.rows, tid);
  wait_staged<0>();
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    // the other buffer's last reads (slab s - 1) ended at a barrier
    unsigned char* other = sl.ring + ((s + 1) % 2) * sl.stage;
    if (s + 1 < n_slabs) {
      load_operand(next, sl, s + 1, tid);
      stage_w<__nv_bfloat16>(other + sl.operand, sl, s + 1, tid);
      commit_staged();
    }
    if (active)
      mma_slab(c, sl.ring + (s % 2) * sl.stage, sl, a_base, n_base, lane);
    if (s + 1 < n_slabs) {
      store_operand(other, next, sl.rows, tid);
      wait_staged<0>();
    }
    __syncthreads();
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_streamed_kernel(const E* __restrict__ gates,          // [B, T, 4H]
                        const E* __restrict__ outs,           // [B, T, H]
                        const E* __restrict__ h_init,   // [B, H] or null
                        const E* __restrict__ douts,    // [B, T, H] or null
                        const E* __restrict__ dfinal,   // [B, H] or null
                        const int32_t* __restrict__ lengths,  // [B]
                        const int32_t* __restrict__ order,    // [B]
                        const int32_t* __restrict__ counts,   // [T]
                        const E* __restrict__ w_h,            // [H, 3H]
                        E* __restrict__ dxw,                  // [B, T, 3H]
                        E* __restrict__ dhn_out,              // [B, T, H]
                        float* __restrict__ db,               // [4H]
                        E* __restrict__ dh0,                  // [B, H]
                        float* __restrict__ carry,            // [B, H] f32
                        int B, int T, int H, int U) {
  using P = Plan<E>;
  constexpr bool kLowp = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = slots<E>(U);
  const int chunk = chunk_rows<E>(S);
  Slabs<E> sl;
  sl.ring = smem;
  sl.stage = stage_bytes<E>(S);
  sl.operand = operand_bytes<E>(S);
  sl.dxw = dxw;
  sl.dhn = dhn_out;
  sl.T = T;
  sl.H = H;
  sl.w_h = w_h;
  sl.Ug = S * P::kSlotUnits;
  sl.wide = !kLowp || H % 8 == 0;
  int* rows_s = reinterpret_cast<int*>(smem + P::kStages * sl.stage);
  sl.rows_s = rows_s;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per_slot = kThreads / 32 / S;  // warps a slot
  const int slot = warp / per_slot, wi = warp % per_slot;
  const int u0 = blockIdx.x * U;
  const int n_units = min(U, H - u0);  // > 0: the grid is ceil(H / U)

  // Phase 1's map, gru_bwd.cu's: thread (r1, j) takes unit u0 + j of rows
  // r1, r1 + sweep, ... at every step, and keeps its bias sums over them.
  const int sweep = kThreads / n_units;
  const int j1 = tid % n_units, r1 = tid / n_units;
  const bool in_p1 = r1 < sweep;
  const int u1 = u0 + j1;
  float db_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
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
    sl.t = t;
    for (int c0 = 0; c0 < n_t; c0 += chunk) {
      sl.rows = min(chunk, n_t - c0);
      __syncthreads();  // the previous chunk's carry update is done
      for (int r = tid; r < sl.rows; r += kThreads) rows_s[r] = order[c0 + r];
      __syncthreads();
      for (int g0 = 0; g0 < n_units; g0 += sl.Ug) {
        sl.u0g = u0 + g0;
        sl.nug = min(sl.Ug, n_units - g0);
        if constexpr (!kLowp) {
          const int rstride = 8 * per_slot;  // a slot's row groups
          const int rg = wi * 8 + lane / 4;  // rows rg, rg + rstride, ...
          const int jw = slot * P::kSlotUnits + 2 * (lane % 4);
          float acc[P::kThreadRows][2] = {};
          product_f32_rows(sl.rows / rstride + (sl.rows % rstride != 0), acc,
                           sl, rg, rstride, jw, tid);
#pragma unroll
          for (int i = 0; i < P::kThreadRows; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = rg + rstride * i, j = jw + e;
              if (r < sl.rows && j < sl.nug)
                carry[(size_t)rows_s[r] * H + sl.u0g + j] += acc[i][e];
            }
        } else {
          const int a_base = wi * 32;  // the warp's rows of the chunk
          const int n_base = slot * P::kSlotUnits;
          float c[2][2][4] = {};
          product_bf16(c, sl, a_base < sl.rows, a_base, n_base, tid);
          // C fragment: c[mt][nt][2 h + e] is row lane / 4 + 8 h of m-tile
          // mt, unit 2 (lane % 4) + e of n-tile nt
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int r = a_base + 16 * mt + lane / 4 + 8 * h;
                  const int j = n_base + 8 * nt + 2 * (lane % 4) + e;
                  if (r < sl.rows && j < sl.nug)
                    carry[(size_t)rows_s[r] * H + sl.u0g + j] +=
                        c[mt][nt][2 * h + e];
                }
        }
      }
    }
    __syncthreads();  // the carry is complete for the next step's phase 1
  }

  // the ring is free for the bias sums' partials
  gru::bwd_finish<E>(db_part, reinterpret_cast<float*>(smem), in_p1, r1,
                     sweep, u1, u0, n_units, B, H, carry, dh0, db, tid);
}

template <typename E>
int launch(const void* gates, const void* outs, const void* h0,
           const void* douts, const void* dfinal, const int32_t* lengths,
           const int32_t* order, const int32_t* counts, const void* w_h,
           void* dxw, void* dhn, float* db, void* dh0, float* carry, int B,
           int T, int H, cudaStream_t stream) {
  const int sms = gru::device_sms();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  int U = gru::units_per_block(H, sms);
  if (U > kThreads) return (int)cudaErrorInvalidValue;  // phase 1's map
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
  return gru::launch_cooperative(gru_bwd_streamed_kernel<E>, grid,
                                 smem_bytes<E>(U), args, stream);
}

}  // namespace

// cmhse_gru_bwd's contract (gru_bwd.cu), any H a multiple of 4 up to
// kThreads x the SM count, plus the live rows of each step (counts [T],
// int32 on the device: the rows with t < length, the length of the prefix
// of order that step t multiplies).
extern "C" int cmhse_gru_bwd_streamed(
    const void* gates, const void* outs, const void* h0, const void* douts,
    const void* dfinal, const int32_t* lengths, const int32_t* order,
    const int32_t* counts, const void* w_h, void* dxw, void* dhn, float* db,
    void* dh0, void* carry, int B, int T, int H, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % 4 != 0 || dh0 == nullptr ||
      (bf16 != 0) != (carry != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(gates, outs, h0, douts, dfinal, lengths,
                                 order, counts, w_h, dxw, dhn, db, dh0,
                                 static_cast<float*>(carry), B, T, H, s);
  return launch<float>(gates, outs, h0, douts, dfinal, lengths, order,
                       counts, w_h, dxw, dhn, db, dh0,
                       static_cast<float*>(dh0), B, T, H, s);
}
