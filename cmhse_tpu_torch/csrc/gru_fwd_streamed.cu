// Masked GRU forward time loop for Hopper (sm_90a), f32 and bf16: the
// streamed-W_h variant of gru_fwd.cu, for H past cmhse_gru_fwd_max_hidden,
// where a block's slice of W_h no longer fits in shared memory beside its
// staging buffers.
//
// Replaces cmhse_tpu/ops/pallas_gru.py:_gru_kernel as gru_fwd.cu does, in
// all three variants (encode, save_gates, save_gates + with_h0) and both
// element types, with gru_fwd.cu's contract and rounding points (see the
// header there). Every output is the same sum over depth in the same order
// as in gru_fwd.cu's kernel: one fmaf chain, 4 depths at a time, in f32
// (the depths past H, up to a slab, add exact zeros); the same k16
// mma.sync steps (64-depth slabs) in bf16; and the same gate math. So the
// two variants agree bit for bit where both run.
//
// Design. gru_fwd.cu's split: one persistent cooperative grid, at most one
// block per SM, block k owning U consecutive units (U = max(8, ceil(H /
// SMs)), rounded up to even: 16 at H = 2,048, 128 blocks), one grid barrier
// a step, the product's operand h_{t-1} read from outs[:, t - 1] (or h0)
// with L2-only copies (cp.async.cg, ld.global.cg), never through L1, which
// the grid barrier does not make coherent. The same plan of the live rows
// (gru_fwd.cu): only the prefix order[0 : counts[t]] enters the product,
// in chunks, each row's results going to its own position; a chunk past
// the prefix does no product. A row leaves the prefix at the step its
// length ends; then its frozen state (outs[:, t - 1], or h0) is written
// into every later step of outs (and final) at once, one load and T - t
// stores. A step followed by one with no live row needs no grid barrier,
// and the loop ends once no row is live. What differs, but for the gate
// pass, follows from where W_h lives:
//
// - W_h through shared memory. Each depth slab of the block's 3U columns of
//   W_h is staged together with the state slab, in one ring of cp.async
//   stages (f32: 32-depth slabs, 4 stages; bf16: 64-depth slabs, 3
//   stages), so the product reads shared memory only. The pieces come
//   straight from W_h [H, 3H] (no scratch), 16 bytes each (cp.async.cg)
//   when U and H are multiples of 16 bytes' units, else 4 bytes each
//   (cp.async.ca: W_h is read-only for the call, and no alignment is asked
//   of U), stored depth-major: [depth][gate][units]. f32 reads two units of
//   a gate as one 8-byte load; bf16 B fragments come by ldmatrix.trans.
// - One sweep of the state a step. The block's units are split across its
//   warps in slots: 8 units a slot in f32 (a thread owns 8 rows x 2 units,
//   the resident kernel's tile), 16 in bf16 (a warp owns 32 rows, two
//   m-tiles, x 16 units, two n-tiles a gate). With S slots a chunk is 512 /
//   S rows in f32 (S >= 2: 256 at U = 16) and 256 / S in bf16 (S >= 1: 256
//   at U = 16), and each of its state slabs is read from L2 once for all
//   the block's units. Up to 64 units a block (H = 8,448 on 132 SMs); past
//   that the units go in groups of 64, each re-reading the chunk.
// - The gate pass loads the inputs of 8 cells (a thread's (row, unit)
//   pairs) before it computes any, so that their latencies overlap.
// - bf16 with H not a multiple of 8 (rows 8-byte aligned only): the state
//   slab comes by 8-byte ld.global.cg through registers into two buffers,
//   the W_h slab by cp.async beside it, as in gru_fwd.cu.
//
// What bounds it on an H100 (video_low, 512 rows x 64 steps, H = 2,048;
// 27% of the row-steps live; PERF.md, scripts/gru_fwd_streamed_variants.py's
// clock split): the product, 94% of a block's clock in f32 and 74% in
// bf16. In f32 the FMAs of the live rows, at a third of the FFMA peak:
// two warps a scheduler (255 registers) that also issue their slabs'
// copies. In bf16 the tensor cores wait on the copies: each block stages
// every live row's state, n_t x H a step, and its W_h slice; more stages in
// flight, and TMA bulk copies (one a state row, one a depth and gate of
// W_h), measured slower. Each step also pays the gate pass (18% in bf16),
// the frozen rows' writes and one grid barrier.

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
using gru::kThreads;
using gru::ldmatrix_x4;
using gru::mma_bf16;
using gru::sigmoid_f;
using gru::smem_addr;
using gru::to_f;
using gru::wait_staged;

constexpr int kCellRows = 4;  // f32: rows of a gate-pass batch

// How each element type stages a slab and splits the product. A staged
// state row holds one slab of depths plus 16 bytes of padding (so that rows
// start in different bank groups).
template <typename E>
struct Plan;
template <>
struct Plan<float> {
  static constexpr int kThreadRows = 8;  // a thread: 8 rows x 2 units
  static constexpr int kDepth = 32;      // depths a slab
  static constexpr int kRowBytes = 144;  // a staged state row
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

// Units a block owns: the resident split, rounded up to even (a bf16 W_h
// piece is two units).
int stream_units(int H, int sms) {
  const int u = gru::units_per_block(H, sms);
  return u + (u & 1);
}

// Slots of a block of U units: enough to cover them, a power of two.
template <typename E>
__host__ __device__ int slots(int U) {
  using P = Plan<E>;
  int s = P::kMinSlots;
  while (s < P::kMaxSlots && s * P::kSlotUnits < U) s *= 2;
  return s;
}

// Bytes of one staged depth of a group's W_h columns (3 x `units`): an odd
// number of 16-byte pieces, so that the 8 depths of an ldmatrix start in
// 8 different bank groups.
template <typename E>
__host__ __device__ int w_row_bytes(int units) {
  const int b = (3 * units * (int)sizeof(E) + 15) / 16;
  return 16 * (b | 1);
}

template <typename E>
__host__ __device__ int state_bytes(int S) {
  return Plan<E>::kSlotRows / S * Plan<E>::kRowBytes;
}

template <typename E>
__host__ __device__ int stage_bytes(int S) {
  return state_bytes<E>(S) +
         Plan<E>::kDepth * w_row_bytes<E>(S * Plan<E>::kSlotUnits);
}

// the ring, then the chunk's batch rows
template <typename E>
size_t smem_bytes(int U) {
  const int S = slots<E>(U);
  return (size_t)Plan<E>::kStages * stage_bytes<E>(S) +
         Plan<E>::kSlotRows / S * sizeof(int);
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Slab s of the group's W_h columns, depth-major: wbuf + d * w_row holds
// gate g's unit j at (g Ug + j) for depth s kDepth + d. Pieces of kBytes:
// 16 (cp.async.cg) when U and H are multiples of a piece's units, else 4
// (cp.async.ca, W_h being read-only: one f32 unit, two bf16 units; U is
// even). Units past the group's and depths past H are zero.
template <typename E, int kBytes>
__device__ __forceinline__ void stage_w_pieces(unsigned char* wbuf,
                                               const E* __restrict__ w_h,
                                               int H, int u0g, int nug,
                                               int Ug, int w_row, int s,
                                               int tid) {
  constexpr int kPer = kBytes / (int)sizeof(E);  // units a piece
  const int per_depth = 3 * Ug / kPer;
  for (int f = tid; f < Plan<E>::kDepth * per_depth; f += kThreads) {
    const int d = f / per_depth, c = (f % per_depth) * kPer;
    const int g = c / Ug, j = c % Ug;
    const int k = s * Plan<E>::kDepth + d;
    const bool in = j < nug && k < H;
    unsigned char* dst = wbuf + d * w_row + c * (int)sizeof(E);
    const E* src = in ? w_h + (size_t)k * 3 * H + g * H + u0g + j : w_h;
    if constexpr (kBytes == 16)
      cp_async16(dst, src, in);
    else
      gru::cp_async_ca<4>(dst, src, in);
  }
}

template <typename E>
__device__ __forceinline__ void stage_w(unsigned char* wbuf,
                                        const E* __restrict__ w_h, int H,
                                        int u0g, int nug, int Ug, int w_row,
                                        bool wide, int s, int tid) {
  if (wide)
    stage_w_pieces<E, 16>(wbuf, w_h, H, u0g, nug, Ug, w_row, s, tid);
  else
    stage_w_pieces<E, 4>(wbuf, w_h, H, u0g, nug, Ug, w_row, s, tid);
}

// Slab s of the chunk's first `rows` state rows (batch rows rows_s[r]),
// 16-byte cp.async.cg pieces; depths past H are zero. Rows past `rows` are
// not staged (their sums are discarded).
template <typename E>
__device__ __forceinline__ void stage_state(unsigned char* buf,
                                            const E* __restrict__ src,
                                            size_t stride, const int* rows_s,
                                            int rows, int s, int H, int tid) {
  using P = Plan<E>;
  constexpr int kPieces = P::kDepth * (int)sizeof(E) / 16;  // a row's
  constexpr int kElems = 16 / (int)sizeof(E);
  for (int f = tid; f < rows * kPieces; f += kThreads) {
    const int r = f / kPieces, p = f % kPieces;
    const int k = s * P::kDepth + p * kElems;
    const bool in = k < H;
    cp_async16(buf + r * P::kRowBytes + p * 16,
               in ? src + (size_t)rows_s[r] * stride + k : src, in);
  }
}

// What a product needs to stage its slabs: the state rows of the chunk
// and the group's W_h columns.
template <typename E>
struct Slabs {
  unsigned char* ring;
  int stage, state, w_row;  // bytes: a stage, its state part, a W_h depth
  const E* src;
  size_t stride;
  const int* rows_s;
  int rows;
  const E* w_h;
  int H, u0g, nug, Ug;
  bool wide;  // W_h in 16-byte pieces
};

// The cp.async ring over all slabs: kStages - 1 slabs in flight, one block
// barrier a slab; compute(s, buf) multiplies slab s. Every turn commits one
// group (an empty one past the last slab), so one wait count serves all.
template <typename E, typename Compute>
__device__ __forceinline__ void sweep(const Slabs<E>& sl, int tid,
                                      Compute compute) {
  constexpr int kStages = Plan<E>::kStages;
  const int n_slabs = (sl.H + Plan<E>::kDepth - 1) / Plan<E>::kDepth;
  auto turn = [&](int s) {
    if (s < n_slabs) {
      unsigned char* buf = sl.ring + (s % kStages) * sl.stage;
      stage_state<E>(buf, sl.src, sl.stride, sl.rows_s, sl.rows, s, sl.H,
                     tid);
      stage_w<E>(buf + sl.state, sl.w_h, sl.H, sl.u0g, sl.nug, sl.Ug,
                 sl.w_row, sl.wide, s, tid);
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
    compute(s, sl.ring + (s % kStages) * sl.stage);
  }
  __syncthreads();  // every thread is done with the last slabs
}

using FP = Plan<float>;

__device__ __forceinline__ float pick(float2 v, int e) {
  return e == 0 ? v.x : v.y;
}

// f32: acc[i][e][g] = state row (rg + rstride i) of the chunk . W_h column
// (gate g, unit jw + e of the group), over every depth, for i < kIters.
// Per 4 depths a thread makes 12 8-byte loads of W_h and kIters 16-byte
// loads of the state for 24 kIters FMAs, in gru_fwd.cu's order. kIters is
// a template parameter so that no branch stands between a state load and
// its FMAs.
template <int kIters>
__device__ __forceinline__ void product_f32(float (&acc)[FP::kThreadRows][2][3],
                                            const Slabs<float>& sl, int rg,
                                            int rstride, int jw, int tid) {
  constexpr int kRowFloats = FP::kRowBytes / 4;
  sweep<float>(sl, tid, [&](int, const unsigned char* buf) {
    const float* hs = reinterpret_cast<const float*>(buf);
    const unsigned char* wb = buf + sl.state + jw * 4;
#pragma unroll
    for (int kq = 0; kq < FP::kDepth / 4; ++kq) {
      float2 wv[4][3];
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          wv[d][g] = *reinterpret_cast<const float2*>(
              wb + (4 * kq + d) * sl.w_row + g * sl.Ug * 4);
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(
            hs + (rg + rstride * i) * kRowFloats + 4 * kq);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float& a = acc[i][e][g];
            a = fmaf(h.x, pick(wv[0][g], e), a);
            a = fmaf(h.y, pick(wv[1][g], e), a);
            a = fmaf(h.z, pick(wv[2][g], e), a);
            a = fmaf(h.w, pick(wv[3][g], e), a);
          }
      }
    }
  });
}

// product_f32 at the least kIters that covers the chunk's rows.
template <int kIters = 1>
__device__ __forceinline__ void product_f32_rows(
    int iters, float (&acc)[FP::kThreadRows][2][3], const Slabs<float>& sl,
    int rg, int rstride, int jw, int tid) {
  if constexpr (kIters < FP::kThreadRows) {
    if (iters > kIters) {
      product_f32_rows<kIters + 1>(iters, acc, sl, rg, rstride, jw, tid);
      return;
    }
  }
  product_f32<kIters>(acc, sl, rg, rstride, jw, tid);
}

// bf16: c[mt][nt][g] += the warp's m-tile mt (chunk rows a_base + 16 mt ..)
// of the staged state slab times n-tile nt of gate g (units n_base + 8 nt
// of the group), 64 depths in four k16 steps. A by ldmatrix (x4: row
// lane % 16 of the m-tile at depth 8 (lane / 16)); B by ldmatrix.trans
// from the depth-major W_h slab (x4: depth lane % 8 + 8 ((lane / 8) % 2),
// units 8 (lane / 16): both n-tiles of a gate).
__device__ __forceinline__ void mma_slab(float (&c)[2][2][3][4],
                                         const unsigned char* buf,
                                         const Slabs<__nv_bfloat16>& sl,
                                         int a_base, int n_base, int lane) {
  using P = Plan<__nv_bfloat16>;
  constexpr int kRowElems = P::kRowBytes / 2;
  const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(buf);
  const int a_row = a_base + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 8 * (lane / 16);
  const unsigned char* wb =
      buf + sl.state + ((lane % 8) + 8 * ((lane / 8) % 2)) * sl.w_row +
      (n_base + 8 * (lane / 16)) * 2;
#pragma unroll
  for (int kk = 0; kk < P::kDepth / 16; ++kk) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], hs + (a_row + 16 * mt) * kRowElems + 16 * kk + a_k);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      unsigned b[4];
      ldmatrix_x4_trans(b, wb + 16 * kk * sl.w_row + g * sl.Ug * 2);
      const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(c[mt][0][g], a[mt], b0);
        mma_bf16(c[mt][1][g], a[mt], b1);
      }
    }
  }
}

// bf16, H not a multiple of 8: one state slab of the chunk's rows into
// registers, 8-byte L2-coherent loads (16 threads a row's 128 bytes), then
// into shared memory. Depths past H read as 0 (H is a multiple of 4).
using BP = Plan<__nv_bfloat16>;
constexpr int kLoads = BP::kSlotRows * BP::kDepth * 2 / 8 / kThreads;

__device__ __forceinline__ void load_state(uint2 (&v)[kLoads],
                                           const Slabs<__nv_bfloat16>& sl,
                                           int s, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int f = tid + kThreads * q;
    const int r = f / 16;
    const int k = s * BP::kDepth + (f % 16) * 4;
    v[q] = (r < sl.rows && k < sl.H)
               ? __ldcg(reinterpret_cast<const uint2*>(
                     sl.src + (size_t)sl.rows_s[r] * sl.stride + k))
               : make_uint2(0u, 0u);
  }
}

__device__ __forceinline__ void store_state(unsigned char* buf,
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
__device__ __forceinline__ void product_bf16(float (&c)[2][2][3][4],
                                             const Slabs<__nv_bfloat16>& sl,
                                             bool active, int a_base,
                                             int n_base, int tid) {
  const int lane = tid % 32;
  if (sl.H % 8 == 0) {
    sweep<__nv_bfloat16>(sl, tid, [&](int, const unsigned char* buf) {
      if (active) mma_slab(c, buf, sl, a_base, n_base, lane);
    });
    return;
  }
  constexpr int kK = Plan<__nv_bfloat16>::kDepth;
  const int n_slabs = (sl.H + kK - 1) / kK;
  uint2 next[kLoads];
  load_state(next, sl, 0, tid);
  stage_w<__nv_bfloat16>(sl.ring + sl.state, sl.w_h, sl.H, sl.u0g, sl.nug,
                         sl.Ug, sl.w_row, sl.wide, 0, tid);
  commit_staged();
  store_state(sl.ring, next, sl.rows, tid);
  wait_staged<0>();
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    // the other buffer's last reads (slab s - 1) ended at a barrier
    unsigned char* other = sl.ring + ((s + 1) % 2) * sl.stage;
    if (s + 1 < n_slabs) {
      load_state(next, sl, s + 1, tid);
      stage_w<__nv_bfloat16>(other + sl.state, sl.w_h, sl.H, sl.u0g, sl.nug,
                             sl.Ug, sl.w_row, sl.wide, s + 1, tid);
      commit_staged();
    }
    if (active) mma_slab(c, sl.ring + (s % 2) * sl.stage, sl, a_base, n_base,
                         lane);
    if (s + 1 < n_slabs) {
      store_state(other, next, sl.rows, tid);
      wait_staged<0>();
    }
    __syncthreads();
  }
}

// What one live row-step of one unit reads besides its product: the gate
// pass loads a batch of these before it computes any, so that their
// latencies overlap.
struct Cell {
  float xr, xz, xn, br, bz, bn, h_prev;
};

template <typename E, bool kWithH0>
__device__ __forceinline__ Cell load_cell(int b, int u, int t, int T, int H,
                                          const E* __restrict__ xw,
                                          const float* __restrict__ b_h,
                                          const E* __restrict__ h_init,
                                          const E* __restrict__ outs,
                                          const float* __restrict__ carry) {
  constexpr bool kLowp = std::is_same<E, __nv_bfloat16>::value;
  const size_t bu = (size_t)b * H + u;
  const size_t bt = (size_t)b * T + t;
  Cell c;
  if (t == 0)
    c.h_prev = kWithH0 ? to_f(h_init[bu]) : 0.0f;
  else if constexpr (kLowp)
    c.h_prev = carry[bu];  // written by this block at step t - 1
  else
    c.h_prev = outs[(bt - 1) * H + u];  // the f32 carry
  const E* x = xw + bt * 3 * H;
  c.xr = to_f(x[u]);
  c.xz = to_f(x[H + u]);
  c.xn = to_f(x[2 * H + u]);
  c.br = b_h[u];
  c.bz = b_h[H + u];
  c.bn = b_h[2 * H + u];
  return c;
}

// One live row-step of one unit: gru_fwd.cu's gate math, in its order. hr,
// hz, hn are the unit's three columns of h_{t-1} @ W_h. The two products
// that meet an addition are fused as the compiler fuses gru_fwd.cu's
// expressions, written out so that no change around them can fuse them
// otherwise (a last-bit difference would compound over the steps).
template <typename E, bool kSaveGates>
__device__ __forceinline__ void store_cell(const Cell& c, float hr, float hz,
                                           float hn, int b, int u, int t,
                                           int T, int H, E* __restrict__ outs,
                                           E* __restrict__ final_h,
                                           E* __restrict__ gates,
                                           float* __restrict__ carry) {
  constexpr bool kLowp = std::is_same<E, __nv_bfloat16>::value;
  const size_t bu = (size_t)b * H + u;
  const size_t bt = (size_t)b * T + t;
  const float ghn = hn + c.bn;
  const float r = sigmoid_f(c.xr + (hr + c.br));
  const float z = sigmoid_f(c.xz + (hz + c.bz));
  const float n = tanhf(fmaf(r, ghn, c.xn));
  const float h_new = fmaf(z, c.h_prev, (1.0f - z) * n);
  if constexpr (kSaveGates) {
    E* gt = gates + bt * 4 * H + u;
    gt[0] = from_f<E>(r);
    gt[H] = from_f<E>(z);
    gt[2 * H] = from_f<E>(n);
    gt[3 * H] = from_f<E>(ghn);
  }
  outs[bt * H + u] = from_f<E>(h_new);
  if constexpr (kLowp) carry[bu] = h_new;
  if (t == T - 1) final_h[bu] = from_f<E>(h_new);
}

template <typename E, bool kSaveGates, bool kWithH0>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_streamed_kernel(const E* __restrict__ xw,             // [B, T, 3H]
                        const E* __restrict__ w_h,            // [H, 3H]
                        const float* __restrict__ b_h,        // [3H]
                        const int32_t* __restrict__ order,    // [B]
                        const int32_t* __restrict__ counts,   // [T]
                        const E* __restrict__ h_init,  // [B, H] (kWithH0)
                        E* __restrict__ outs,          // [B, T, H]
                        E* __restrict__ final_h,       // [B, H]
                        E* __restrict__ gates,  // [B, T, 4H] (kSaveGates)
                        float* __restrict__ carry,  // [B, H] f32 (bf16 only)
                        int B, int T, int H, int U) {
  using P = Plan<E>;
  constexpr bool kLowp = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = slots<E>(U);
  const int Ug = S * P::kSlotUnits;  // units of a group
  const int chunk = P::kSlotRows / S;
  Slabs<E> sl;
  sl.ring = smem;
  sl.stage = stage_bytes<E>(S);
  sl.state = state_bytes<E>(S);
  sl.w_row = w_row_bytes<E>(Ug);
  sl.w_h = w_h;
  sl.H = H;
  sl.Ug = Ug;
  constexpr int kPer16 = 16 / (int)sizeof(E);  // units of a 16-byte piece
  sl.wide = U % kPer16 == 0 && H % kPer16 == 0;
  int* rows_s = reinterpret_cast<int*>(smem + P::kStages * sl.stage);
  sl.rows_s = rows_s;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per_slot = kThreads / 32 / S;  // warps a slot
  const int slot = warp / per_slot, wi = warp % per_slot;
  const int u0 = blockIdx.x * U;
  const int n_units = min(U, H - u0);  // > 0: the grid is ceil(H / U)

  for (int t = 0; t < T; ++t) {
    const int n_t = counts[t];
    // the product's operand h_{t-1}: outs[:, t - 1], or h0 at t = 0
    sl.src = t > 0 ? outs + (size_t)(t - 1) * H : h_init;
    sl.stride = t > 0 ? (size_t)T * H : (size_t)H;
    const bool product = t > 0 || kWithH0;
    for (int c0 = 0; c0 < n_t; c0 += chunk) {
      sl.rows = min(chunk, n_t - c0);
      __syncthreads();  // the previous chunk's gate pass is done with rows_s
      for (int r = tid; r < sl.rows; r += kThreads) rows_s[r] = order[c0 + r];
      __syncthreads();
      for (int g0 = 0; g0 < n_units; g0 += Ug) {
        sl.u0g = u0 + g0;
        sl.nug = min(Ug, n_units - g0);
        if constexpr (!kLowp) {
          const int rstride = 8 * per_slot;  // a slot's row groups
          const int rg = wi * 8 + lane / 4;  // rows rg, rg + rstride, ...
          const int jw = slot * P::kSlotUnits + 2 * (lane % 4);
          float acc[P::kThreadRows][2][3] = {};
          if (product)
            product_f32_rows(sl.rows / rstride + (sl.rows % rstride != 0),
                             acc, sl, rg, rstride, jw, tid);
          // the gate pass, kCellRows rows x 2 units at a time
#pragma unroll
          for (int i0 = 0; i0 < P::kThreadRows; i0 += kCellRows) {
            Cell cell[kCellRows][2];
#pragma unroll
            for (int i = 0; i < kCellRows; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = rg + rstride * (i0 + i), j = jw + e;
                if (r < sl.rows && j < sl.nug)
                  cell[i][e] = load_cell<E, kWithH0>(
                      rows_s[r], sl.u0g + j, t, T, H, xw, b_h, h_init, outs,
                      carry);
              }
#pragma unroll
            for (int i = 0; i < kCellRows; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = rg + rstride * (i0 + i), j = jw + e;
                if (r < sl.rows && j < sl.nug)
                  store_cell<E, kSaveGates>(
                      cell[i][e], acc[i0 + i][e][0], acc[i0 + i][e][1],
                      acc[i0 + i][e][2], rows_s[r], sl.u0g + j, t, T, H,
                      outs, final_h, gates, carry);
              }
          }
        } else {
          const int a_base = wi * 32;  // the warp's rows of the chunk
          const int n_base = slot * P::kSlotUnits;
          float c[2][2][3][4] = {};
          if (product)
            product_bf16(c, sl, a_base < sl.rows, a_base, n_base, tid);
          // the gate pass, an m-tile at a time. C fragment:
          // c[mt][nt][g][2 h + e] is row lane / 4 + 8 h of m-tile mt, unit
          // 2 (lane % 4) + e of n-tile nt
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            Cell cell[2][2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int r = a_base + 16 * mt + lane / 4 + 8 * h;
                  const int j = n_base + 8 * nt + 2 * (lane % 4) + e;
                  if (r < sl.rows && j < sl.nug)
                    cell[nt][h][e] = load_cell<E, kWithH0>(
                        rows_s[r], sl.u0g + j, t, T, H, xw, b_h, h_init,
                        outs, carry);
                }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int r = a_base + 16 * mt + lane / 4 + 8 * h;
                  const int j = n_base + 8 * nt + 2 * (lane % 4) + e;
                  if (r < sl.rows && j < sl.nug)
                    store_cell<E, kSaveGates>(
                        cell[nt][h][e], c[mt][nt][0][2 * h + e],
                        c[mt][nt][1][2 * h + e], c[mt][nt][2][2 * h + e],
                        rows_s[r], sl.u0g + j, t, T, H, outs, final_h, gates,
                        carry);
                }
          }
        }
      }
    }
    // the rows whose last live step was t - 1 (length t; at t = 0 the
    // length-0 rows) keep their state from here on: outs[:, t - 1] (this
    // block's units, written by this block) or h0, written into outs[:, t:]
    // and final at once
    const int dying = (t > 0 ? counts[t - 1] : B) - n_t;
    for (int i = tid; i < dying * n_units; i += kThreads) {
      const int b = order[n_t + i / n_units], u = u0 + i % n_units;
      const size_t bu = (size_t)b * H + u;
      const size_t b0 = (size_t)b * T;
      const E v = t > 0 ? outs[(b0 + t - 1) * H + u]
                        : kWithH0 ? h_init[bu] : from_f<E>(0.0f);
      for (int s = t; s < T; ++s) outs[(b0 + s) * H + u] = v;
      final_h[bu] = v;
    }
    if (n_t == 0) break;  // every row is written to the end
    if (t + 1 < T) {
      if (counts[t + 1] > 0)
        cg::this_grid().sync();  // outs[:, t] is complete
      else
        __syncthreads();  // no product reads it: only this block's writes
    }
  }
}

template <typename E, bool kSaveGates, bool kWithH0>
int launch(const void* xw, const void* w_h, const float* b_h,
           const int32_t* order, const int32_t* counts, const void* h0,
           void* outs, void* final_h, void* gates, float* carry, int B,
           int T, int H, cudaStream_t stream) {
  const int sms = gru::device_sms();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  int U = stream_units(H, sms);
  const int grid = (H + U - 1) / U;
  const E* xw_e = static_cast<const E*>(xw);
  const E* w_e = static_cast<const E*>(w_h);
  const E* h0_e = static_cast<const E*>(h0);
  E* outs_e = static_cast<E*>(outs);
  E* final_e = static_cast<E*>(final_h);
  E* gates_e = static_cast<E*>(gates);
  void* args[] = {(void*)&xw_e,    (void*)&w_e,     (void*)&b_h,
                  (void*)&order,   (void*)&counts,  (void*)&h0_e,
                  (void*)&outs_e,  (void*)&final_e, (void*)&gates_e,
                  (void*)&carry,   (void*)&B,       (void*)&T,
                  (void*)&H,       (void*)&U};
  return gru::launch_cooperative(
      gru_fwd_streamed_kernel<E, kSaveGates, kWithH0>, grid,
      smem_bytes<E>(U), args, stream);
}

template <typename E>
int dispatch(const void* xw, const void* w_h, const float* b_h,
             const int32_t* order, const int32_t* counts, const void* h0,
             void* outs, void* final_h, void* gates, float* carry, int B,
             int T, int H, cudaStream_t s) {
  if (gates != nullptr && h0 != nullptr)
    return launch<E, true, true>(xw, w_h, b_h, order, counts, h0, outs,
                                 final_h, gates, carry, B, T, H, s);
  if (gates != nullptr)
    return launch<E, true, false>(xw, w_h, b_h, order, counts, h0, outs,
                                  final_h, gates, carry, B, T, H, s);
  if (h0 != nullptr)
    return launch<E, false, true>(xw, w_h, b_h, order, counts, h0, outs,
                                  final_h, gates, carry, B, T, H, s);
  return launch<E, false, false>(xw, w_h, b_h, order, counts, h0, outs,
                                 final_h, gates, carry, B, T, H, s);
}

}  // namespace

// cmhse_gru_fwd's contract and arguments (gru_fwd.cu), any H a multiple of
// 4.
extern "C" int cmhse_gru_fwd_streamed(const void* xw, const void* w_h,
                                      const float* b_h, const int32_t* order,
                                      const int32_t* counts, const void* h0,
                                      void* outs, void* final_h, void* gates,
                                      void* carry, int B, int T, int H,
                                      int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % 4 != 0 ||
      (bf16 != 0) != (carry != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* c = static_cast<float*>(carry);
  if (bf16)
    return dispatch<__nv_bfloat16>(xw, w_h, b_h, order, counts, h0, outs,
                                   final_h, gates, c, B, T, H, s);
  return dispatch<float>(xw, w_h, b_h, order, counts, h0, outs, final_h,
                         gates, c, B, T, H, s);
}
