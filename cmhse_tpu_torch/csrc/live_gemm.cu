// Products over the GRU's live row-steps for Hopper (sm_90a), f32.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA as
// dense matrix products over every row-step (b, t) of a padded [B, T, .]
// batch. Added because most of those row-steps are padding: in a cmhse_full
// training step 76% of the frame steps and 81% of the word steps carry no
// data, so dense products spend about three quarters of their FLOPs adding
// exact zeros (K2 writes zero gradients at masked steps) or computing
// projections that K1 never reads. This kernel multiplies only the live
// row-steps, t < lengths[b], in two forms that share one walk of them:
//
//   row form        c[rs] = a[rs] @ W (+ bias)        for each live rs
//                   the input projection xw = x @ W_i + b_i (W [K, N]) and
//                   its gradient dX = g @ W_i^T (W read as [N, K])
//   reduction form  dw = sum over live rs of a'[rs]^T g[rs]   (+ db = sum g)
//                   dW_i = x^T g with db_i, and dW_h = h_prev^T [dr' dz' dhn]
//                   where h_prev[(b, t)] = a[(b, t - 1)], or h0[b] (zeros
//                   when null) at t = 0, and the columns of g come from two
//                   arrays (dxw's first 2H, then dhn)
//
// The walk. The plan of the live rows is the GRU kernels' (gru_kernel.py):
// `order` sorts the rows by length, longest first, and starts[t] counts the
// live row-steps before step t (starts[0] = 0, starts[T] = all of them). So
// live row-step m < starts[T], numbered time-major, lies at the t with
// starts[t] <= m < starts[t + 1] (a binary search) and in batch row
// order[m - starts[t]]. Nothing is read back to the host and no size depends
// on the data: the grid is fixed by the shapes, and tiles past starts[T],
// which only the device knows, do nothing. A CUDA graph that captures a call
// walks each replay's own lengths.
//
// What bounds it on an H100: the FFMAs of the live row-steps, 2 x live x K x
// N each (f32 at 67 TFLOP/s; TF32 would break the port's f32 parity). The
// operands are small beside that (W_i 6 MB, the live rows of x 16 MB at
// video_low), and each is read from L2 by many tiles.
//
// Design: a classic SIMT SGEMM core. 128 x 128 output tiles, 256 threads
// each holding 8 x 8 outputs in registers: the row form one block an SM at
// ~170 registers, the reduction two at 128 (its warps of a second block
// hide the shared loads' latency: 17% faster on the H100 than one block;
// capped at 128 the row form spills and is slower). Depth slabs of BK = 16
// are staged by 16-byte cp.async (L2 only, no register staging; 4-byte
// copies where a row is not 16-byte aligned) into a 3-stage shared-memory
// ring, one barrier a slab. Each operand keeps its memory layout in shared
// memory, so no copy transposes: one whose depth is contiguous (x and g
// rows in the row form, W read as [N, K]) is kept K-major ([128][BK + 4],
// rows 20 floats apart so that 8 rows read at once lie in 8 bank groups)
// and read as 16-byte loads of four depths of a row; one whose rows are
// contiguous (W [K, N]; both operands of the reduction, whose depth is the
// row-steps) is kept MN-major ([BK][128]) and read as 16-byte loads of four
// rows at one depth. Either way a thread makes 16 shared loads for 256
// FMAs. Every sum runs over depth in one fixed order with no atomics, so
// the results are bitwise the same from run to run.
//   Row form: a persistent grid of one block an SM walks the tiles (128
//   live row-steps x 128 columns), numbered row-tile-major, so a block stops
//   at its first tile past starts[T]. A tile's 128 row-steps are found once
//   (one binary search a thread) and kept in shared memory; the rows of `a`
//   are gathered through them and the outputs scattered to them, with the
//   bias added in the epilogue. Dead rows of c are not written. A layer of
//   few row-steps and a long depth (the high-level GRUs' and the decoders'
//   512 row-steps, dX's K = 3,072) would leave most SMs idle, so its depth
//   is split until every resident block would have a tile at full density
//   (up to 8 splits); the partial rows go to a workspace at their live
//   indices and a second pass adds them in split order.
//   Reduction form: the depth is the live row-steps, split into S equal
//   ranges (S from the shapes and the card's SMs, up to 8: the fewest waves
//   of blocks a split were every row-step live, at least 8 slabs a split);
//   block (tile, split) sums its range, and for S > 1 a second pass adds
//   the S partial tiles in split order. Sixteen threads walk the range a
//   slab ahead of the copies, each keeping its step and only advancing it.
//   db is the product's extra row: the row M of a' reads 1 on every live
//   row-step (a 16-byte unit {1, 0, 0, 0} in device memory stands in for
//   it), so the column sums come from the same FMAs.
//
// The grouped forms (kernels moe_*): the routed experts of a mixture-of-
// experts layer. Each group of slots has its own weight: the slots are the
// assignments of tokens to the experts held here, sorted by expert on the
// device (live_gemm.py's moe_plan), and gstarts[e] counts the slots before
// expert e, so gstarts[G] is known only to the device.
//
//   row form        c[c_idx[s]] = scale[s] * (a[a_idx[s]] @ W_e)  for each
//                   slot s of group e: the gate/up product (a gathered by
//                   token), the down product (the router's score applied,
//                   scattered to the token's assignment) and their dX (W_e
//                   read as [N, K])
//   reduction form  dW_e = sum over the slots s of group e of
//                   a[a_idx[s]]^T g[g_idx[s]]
//
// They share the SGEMM core above. Row form: a persistent grid of one block
// an SM walks the tiles (128 slots of one group x 128 columns), numbered
// row-tile-major over the groups' row tiles in group order; each block
// counts the row tiles before each group from gstarts once, finds a tile's
// group by a binary search of those counts, and stops at its first tile past
// the last group's. The grid is sized from the number of slots, which bounds
// the row tiles (slots / 128 + G), never from gstarts. Reduction form: one
// block a (group, 128 x 128 tile of dW_e), summing the group's slots in slot
// order, no split; a group with no slot writes zeros. No atomics: the
// results are bitwise the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows a tile
constexpr int BN = 128;      // output columns a tile
constexpr int BK = 16;       // depth of a stage
constexpr int LDK = BK + 4;  // row stride (floats) of a K-major slab
constexpr int STAGES = 3;
constexpr int NT = 256;      // 16 x 16 threads of 8 x 8 outputs
constexpr int MAX_SPLITS = 8;

// The reduction's row M of a' (the column sums): one, then the zeros of the
// rest of its 16-byte unit.
__device__ __align__(16) float kUnit[4] = {1.0f, 0.0f, 0.0f, 0.0f};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC floats global -> shared; `in` false zero-fills them and reads nothing.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src,
                                         bool in) {
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The plan of the live rows.
struct Plan {
  const int32_t* order;   // [B] rows by length, longest first
  const int32_t* starts;  // [T + 1] live row-steps before each step
  int T;
};

// The step of live row-step m < starts[T]: starts[t] <= m < starts[t + 1].
__device__ __forceinline__ int step_of(const Plan& p, int m) {
  int lo = 0, hi = p.T;  // starts[lo] <= m < starts[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(p.starts + mid) <= m)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// b * T + t of live row-step m, which lies at step t.
__device__ __forceinline__ int row_step(const Plan& p, int m, int t) {
  return __ldg(p.order + (m - __ldg(p.starts + t))) * p.T + t;
}

// The tile row (or column) of a thread's i-th output, 0 <= i < 8, for its
// group g (0..15): rows g + 16 i of an operand kept K-major (read a row at a
// time), 4g .. 4g + 3 and 64 + 4g .. 64 + 4g + 3 of one kept MN-major (read
// four rows at a time).
template <bool KMAJOR>
__device__ __forceinline__ int frag_row(int g, int i) {
  return KMAJOR ? g + 16 * i : 4 * g + (i & 3) + 64 * (i >> 2);
}

template <bool KMAJOR>
__host__ __device__ constexpr int slab_floats() {
  return KMAJOR ? 128 * LDK : BK * 128;
}

// f[d][i]: depth c + d of the thread's row i of a staged slab.
template <bool KMAJOR>
__device__ __forceinline__ void load_frag(float (&f)[4][8], const float* s,
                                          int g, int c) {
  if constexpr (KMAJOR) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(s + (g + 16 * i) * LDK + c);
      f[0][i] = v.x;
      f[1][i] = v.y;
      f[2][i] = v.z;
      f[3][i] = v.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float* row = s + (c + d) * 128;
      const float4 lo = *reinterpret_cast<const float4*>(row + 4 * g);
      const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * g);
      f[d][0] = lo.x;
      f[d][1] = lo.y;
      f[d][2] = lo.z;
      f[d][3] = lo.w;
      f[d][4] = hi.x;
      f[d][5] = hi.y;
      f[d][6] = hi.z;
      f[d][7] = hi.w;
    }
  }
}

// Stage depths k0 .. k0 + BK - 1 of 128 rows into a K-major slab: row r
// from row_ptr(r) (null: a zero row); depths past K read as zero (K is a
// multiple of VEC).
template <int VEC, class RowPtr>
__device__ __forceinline__ void stage_kmajor(uint32_t dst, int k0, int K,
                                             int tid, const float* any,
                                             RowPtr&& row_ptr) {
  constexpr int PER_ROW = BK / VEC, STEP = NT / PER_ROW;
  const int k = VEC * (tid % PER_ROW);
#pragma unroll
  for (int i = 0; i < 128 / STEP; ++i) {
    const int r = tid / PER_ROW + STEP * i;
    const float* p = row_ptr(r);
    const bool in = p != nullptr && k0 + k < K;
    cp_async<VEC>(dst + (r * LDK + k) * 4, in ? p + k0 + k : any, in);
  }
}

// Stage BK depths of 128 values into an MN-major slab: the VEC values at
// depth kr, from n on, from src(kr, n) (null: zeros).
template <int VEC, class Src>
__device__ __forceinline__ void stage_mnmajor(uint32_t dst, int tid,
                                              const float* any, Src&& src) {
  constexpr int PER_ROW = 128 / VEC;
#pragma unroll
  for (int i = 0; i < BK * PER_ROW / NT; ++i) {
    const int e = tid + NT * i, kr = e / PER_ROW, n = VEC * (e % PER_ROW);
    const float* p = src(kr, n);
    cp_async<VEC>(dst + (kr * 128 + n) * 4, p != nullptr ? p : any,
                  p != nullptr);
  }
}

// acc = a tile's products over `slabs` slabs, which stage(s, a_dst, b_dst)
// copies into the ring; before(s) runs at the top of iteration s, after
// its barrier. Returns with every stage free. Each accumulator sums its
// depths in order.
template <bool A_K, bool B_K, class Stage, class Before>
__device__ __forceinline__ void mainloop(float (&acc)[8][8], float* smem,
                                         int slabs, int mg, int ng,
                                         Stage&& stage, Before&& before) {
  constexpr int A_FL = slab_floats<A_K>();
  constexpr int STAGE_FL = A_FL + slab_floats<B_K>();
  const uint32_t base = smem_u32(smem);
  auto issue = [&](int s) {
    if (s < slabs) {
      const uint32_t a = base + (s % STAGES) * STAGE_FL * 4;
      stage(s, a, a + A_FL * 4);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < slabs; ++s) {
    // slab s has landed (for every thread, after the barrier), and every
    // thread is done with slab s - 1, whose stage the next copy reuses
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    before(s);
    issue(s + STAGES - 1);
    const float* A = smem + (s % STAGES) * STAGE_FL;
    const float* B = A + A_FL;
#pragma unroll
    for (int c = 0; c < BK; c += 4) {
      float a[4][8], b[4][8];
      load_frag<A_K>(a, A, mg, c);
      load_frag<B_K>(b, B, ng, c);
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[d][i], b[d][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Row form. W_NK: W is [N, K] (dX = g @ W_i^T), else [K, N]. With
// splits > 1 the depth is split that many ways and each block writes its
// partial tile to work [splits, B * T, N] at the live row-steps' indices
// (no bias); live_rows_sum_kernel adds them.
template <bool W_NK, int VEC>
__global__ void __launch_bounds__(NT, 1)
    live_rows_kernel(const float* __restrict__ a, int lda,
                     const float* __restrict__ w, int ldw,
                     const float* __restrict__ bias,  // [N] or null
                     float* __restrict__ c, int ldc,
                     float* __restrict__ work, int splits, int rows,
                     Plan plan, int N, int K, int n_tiles, int tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int rows_s[BM];  // each tile row's b * T + t; -1 past the live
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mg = (warp / 2) * 4 + lane / 8, ng = (warp % 2) * 8 + lane % 8;
  const int live = __ldg(plan.starts + plan.T);
  const int per = ((K + BK - 1) / BK + splits - 1) / splits;  // slabs a split
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int split = tile % splits, mn = tile / splits;
    const int m0 = (mn / n_tiles) * BM, n0 = (mn % n_tiles) * BN;
    if (m0 >= live) break;  // so is every later tile
    const int k_begin = min(K, split * per * BK);
    const int k_end = min(K, k_begin + per * BK);
    const int slabs = (k_end - k_begin + BK - 1) / BK;
    __syncthreads();        // the last tile's epilogue is done with rows_s
    if (tid < BM) {
      const int m = m0 + tid;
      rows_s[tid] = m < live ? row_step(plan, m, step_of(plan, m)) : -1;
    }
    __syncthreads();
    float acc[8][8];
    mainloop<true, W_NK>(
        acc, smem, slabs, mg, ng,
        [&](int s, uint32_t a_dst, uint32_t b_dst) {
          const int k0 = k_begin + s * BK;
          stage_kmajor<VEC>(a_dst, k0, k_end, tid, a,
                            [&](int r) -> const float* {
                              const int rs = rows_s[r];
                              return rs < 0 ? nullptr : a + (size_t)rs * lda;
                            });
          if constexpr (W_NK)
            stage_kmajor<VEC>(b_dst, k0, k_end, tid, w,
                              [&](int r) -> const float* {
                                return n0 + r < N ? w + (size_t)(n0 + r) * ldw
                                                  : nullptr;
                              });
          else
            stage_mnmajor<VEC>(
                b_dst, tid, w, [&](int kr, int n) -> const float* {
                  return k0 + kr < k_end && n0 + n < N
                             ? w + (size_t)(k0 + kr) * ldw + n0 + n
                             : nullptr;
                });
        },
        [](int) {});
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = frag_row<true>(mg, i), rs = rows_s[r];
      if (rs < 0) continue;
      float* out = splits > 1 ? work + ((size_t)split * rows + m0 + r) * N
                              : c + (size_t)rs * ldc;
      const float* add = splits > 1 ? nullptr : bias;
      if constexpr (!W_NK && VEC == 4) {
        // four consecutive columns, within N (a multiple of 4) or past it
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 64 * h + 4 * ng;
          if (n >= N) continue;
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
          if (add != nullptr) {
            v.x += add[n];
            v.y += add[n + 1];
            v.z += add[n + 2];
            v.w += add[n + 3];
          }
          *reinterpret_cast<float4*>(out + n) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + frag_row<W_NK>(ng, j);
          if (n < N) out[n] = add != nullptr ? acc[i][j] + add[n] : acc[i][j];
        }
      }
    }
  }
}

// The row form's second pass: each live row-step's partial rows added in
// split order, the bias added, scattered to its row of c.
__global__ void live_rows_sum_kernel(const float* __restrict__ work,
                                     int splits, int rows, int N,
                                     const float* __restrict__ bias,
                                     float* __restrict__ c, int ldc,
                                     Plan plan) {
  const int live = __ldg(plan.starts + plan.T);
  for (int m = blockIdx.x; m < live; m += gridDim.x) {
    float* out = c + (size_t)row_step(plan, m, step_of(plan, m)) * ldc;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float s = work[(size_t)m * N + n];
      for (int k = 1; k < splits; ++k)
        s += work[((size_t)k * rows + m) * N + n];
      out[n] = bias != nullptr ? s + bias[n] : s;
    }
  }
}

// Reduction form: dw [M, N] (and db [N], a' row M) over the live row-steps,
// split `splits` ways; partial tiles go to work [splits, M + 1 (with db), N]
// when splits > 1.
template <int VEC>
__global__ void __launch_bounds__(NT, 2)
    live_reduce_kernel(const float* __restrict__ a, int lda, int shift,
                       const float* __restrict__ h0,  // [B, M], stride lda
                       const float* __restrict__ g0, int ldg0,
                       const float* __restrict__ g1, int ldg1, int n_split,
                       float* __restrict__ dw, float* __restrict__ db,
                       float* __restrict__ work, int splits, Plan plan, int M,
                       int N, int n_tiles, int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RING = STAGES + 1;
  // b * T + t (-1: none) and t of each row of the slabs staged next
  __shared__ int rs_s[RING][BK], ts_s[RING][BK];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mg = (warp / 2) * 4 + lane / 8, ng = (warp % 2) * 8 + lane % 8;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
  const int rows_out = M + (db != nullptr ? 1 : 0);
  const int live = __ldg(plan.starts + plan.T);
  const int chunk = ((live + splits - 1) / splits + BK - 1) / BK * BK;
  const int k_begin = min(live, split * chunk);
  const int k_end = min(live, k_begin + chunk);
  const int slabs = (k_end - k_begin + BK - 1) / BK;
  // thread r < BK walks row-steps k_begin + r, + BK, + 2 BK, ...
  int t_walk = 0;
  if (tid < BK && k_begin + tid < k_end) t_walk = step_of(plan, k_begin + tid);
  auto walk = [&](int s) {
    if (tid < BK) {
      const int k = k_begin + BK * s + tid;
      int rs = -1;
      if (k < k_end) {
        while (__ldg(plan.starts + t_walk + 1) <= k) ++t_walk;
        rs = row_step(plan, k, t_walk);
      }
      rs_s[s % RING][tid] = rs;
      ts_s[s % RING][tid] = t_walk;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) walk(s);
  __syncthreads();
  float acc[8][8];
  mainloop<false, false>(
      acc, smem, slabs, mg, ng,
      [&](int s, uint32_t a_dst, uint32_t b_dst) {
        const int* rs = rs_s[s % RING];
        const int* ts = ts_s[s % RING];
        stage_mnmajor<VEC>(a_dst, tid, a, [&](int kr, int m) -> const float* {
          const int r = rs[kr];
          m += m0;
          if (r < 0 || m >= rows_out) return nullptr;
          if (m == M) return kUnit;  // db's row (M is a multiple of VEC)
          if (!shift) return a + (size_t)r * lda + m;
          if (ts[kr] > 0) return a + (size_t)(r - 1) * lda + m;
          return h0 != nullptr ? h0 + (size_t)(r / plan.T) * lda + m
                               : nullptr;
        });
        stage_mnmajor<VEC>(b_dst, tid, g0, [&](int kr, int n) -> const float* {
          const int r = rs[kr];
          n += n0;
          if (r < 0 || n >= N) return nullptr;
          return n < n_split ? g0 + (size_t)r * ldg0 + n
                             : g1 + (size_t)r * ldg1 + (n - n_split);
        });
      },
      [&](int s) { walk(s + STAGES); });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + frag_row<false>(mg, i);
    if (m >= rows_out) continue;
    float* out = splits > 1 ? work + ((size_t)split * rows_out + m) * N
                            : (m < M ? dw + (size_t)m * N : db);
    if constexpr (VEC == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 64 * h + 4 * ng;
        if (n < N)
          *reinterpret_cast<float4*>(out + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + frag_row<false>(ng, j);
        if (n < N) out[n] = acc[i][j];
      }
    }
  }
}

// The reduction's second pass: the splits' partial tiles added in split
// order.
__global__ void live_reduce_sum_kernel(const float* __restrict__ work,
                                       int splits, int M, int N, int rows_out,
                                       float* __restrict__ dw,
                                       float* __restrict__ db) {
  const size_t plane = (size_t)rows_out * N, body = (size_t)M * N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < plane;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = work[e];
    for (int k = 1; k < splits; ++k) s += work[k * plane + e];
    if (e < body)
      dw[e] = s;
    else
      db[e - body] = s;
  }
}

int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem, int* resident) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  const int sms = device_sms();
  if (sms == 0) return cudaErrorInvalidDevice;
  *resident = (per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <bool W_NK>
constexpr int rows_smem() {
  return STAGES * (slab_floats<true>() + slab_floats<W_NK>()) * 4;
}

template <bool W_NK, int VEC>
int launch_rows(const float* a, int lda, const float* w, int ldw,
                const float* bias, float* c, int ldc, float* work, int splits,
                Plan plan, int B, int N, int K, cudaStream_t stream) {
  auto kernel = live_rows_kernel<W_NK, VEC>;
  int resident = 0;
  cudaError_t err = prepare(kernel, rows_smem<W_NK>(), &resident);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * plan.T;
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles =
      (long long)((rows + BM - 1) / BM) * n_tiles * splits;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, NT, rows_smem<W_NK>(), stream>>>(
      a, lda, w, ldw, bias, c, ldc, work, splits, rows, plan, N, K, n_tiles,
      (int)tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  live_rows_sum_kernel<<<rows < resident * 8 ? rows : resident * 8, NT, 0,
                         stream>>>(work, splits, rows, N, bias, c, ldc, plan);
  return (int)cudaGetLastError();
}

// The row form's splits: the fewest that give every resident block a tile
// were every row-step live, with at least 8 slabs of the depth a split. A
// layer of few row-steps and a long depth (dX of the high-level GRUs: 4 x 8
// tiles of K = 3,072) would otherwise busy a quarter of the SMs; a layer
// that fills the card keeps one split, since each split writes and rereads
// every live output row.
int rows_splits(int rows, int N, int K, int* splits) {
  int resident = 0;
  cudaError_t err =
      prepare(live_rows_kernel<true, 4>, rows_smem<true>(), &resident);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((rows + BM - 1) / BM) * ((N + BN - 1) / BN);
  int most = (K + BK - 1) / BK / 8;
  most = most < 1 ? 1 : (most > MAX_SPLITS ? MAX_SPLITS : most);
  int s = 1;
  while (s < most && tiles * s < resident) ++s;
  *splits = s;
  return (int)cudaSuccess;
}

constexpr int kReduceSmem = STAGES * 2 * slab_floats<false>() * 4;

// The reduction's splits: the fewest waves of blocks a split were every
// row-step live, over splits that leave each at least 8 slabs of the
// row-steps; ties go to fewer splits. (Its partial tiles are the weight's
// size, a small pass beside the product.)
int reduce_splits(int rows_out, int N, int rows, int* splits) {
  int resident = 0;
  cudaError_t err = prepare(live_reduce_kernel<4>, kReduceSmem, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((rows_out + BM - 1) / BM) * ((N + BN - 1) / BN);
  int most = rows / (8 * BK);
  most = most < 1 ? 1 : (most > MAX_SPLITS ? MAX_SPLITS : most);
  int best = 1;
  long long best_waves = (tiles + resident - 1) / resident;
  for (int s = 2; s <= most; ++s) {
    const long long waves = (tiles * s + resident - 1) / resident;
    if (waves * best < best_waves * s) {  // waves / s < best_waves / best
      best = s;
      best_waves = waves;
    }
  }
  *splits = best;
  return (int)cudaSuccess;
}

template <int VEC>
int launch_reduce(const float* a, int lda, int shift, const float* h0,
                  const float* g0, int ldg0, const float* g1, int ldg1,
                  int n_split, float* dw, float* db, float* work, int splits,
                  Plan plan, int M, int N, cudaStream_t stream) {
  auto kernel = live_reduce_kernel<VEC>;
  int resident = 0;
  cudaError_t err = prepare(kernel, kReduceSmem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int rows_out = M + (db != nullptr ? 1 : 0);
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)((rows_out + BM - 1) / BM) * n_tiles;
  if (tiles * splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(tiles * splits), NT, kReduceSmem, stream>>>(
      a, lda, shift, h0, g0, ldg0, g1, ldg1, n_split, dw, db, work, splits,
      plan, M, N, n_tiles, (int)tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  // about four sums a thread, at most 8 blocks an SM
  const size_t plane = (size_t)rows_out * N, most = (size_t)resident * 8;
  const size_t blocks = (plane + 4 * NT - 1) / (4 * NT);
  live_reduce_sum_kernel<<<(unsigned)(blocks < most ? blocks : most), NT, 0,
                           stream>>>(work, splits, M, N, rows_out, dw, db);
  return (int)cudaGetLastError();
}


// ---- the grouped forms (routed experts) ------------------------------------

constexpr int MAX_GROUPS = 256;

// Row tiles before each group (tiles_s[0 .. G]), counted by one thread.
__device__ __forceinline__ void group_tiles(const int32_t* gstarts, int G,
                                            int* tiles_s) {
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int g = 0; g < G; ++g) {
      tiles_s[g] = acc;
      acc += (__ldg(gstarts + g + 1) - __ldg(gstarts + g) + BM - 1) / BM;
    }
    tiles_s[G] = acc;
  }
  __syncthreads();
}

// Grouped row form. W_NK: each group's W is [N, K], else [K, N]; group e's
// starts w_stride floats after group e - 1's. a_idx / c_idx null: the slot
// itself; scale null: 1.
template <bool W_NK, int VEC>
__global__ void __launch_bounds__(NT, 1)
    moe_rows_kernel(const float* __restrict__ a, int lda,
                    const int32_t* __restrict__ a_idx,
                    const float* __restrict__ w, int ldw, int w_stride,
                    const float* __restrict__ scale, float* __restrict__ c,
                    int ldc, const int32_t* __restrict__ c_idx,
                    const int32_t* __restrict__ gstarts, int G, int N, int K,
                    int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int slot_s[BM];  // each tile row's slot; -1 past its group
  __shared__ int arow_s[BM];  // and its row of a
  __shared__ int tiles_s[MAX_GROUPS + 1];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mg = (warp / 2) * 4 + lane / 8, ng = (warp % 2) * 8 + lane % 8;
  group_tiles(gstarts, G, tiles_s);
  const int tiles = tiles_s[G] * n_tiles;
  const int slabs = (K + BK - 1) / BK;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / n_tiles, n0 = (tile % n_tiles) * BN;
    int lo = 0, hi = G;  // the last group with tiles_s[lo] <= mt
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (tiles_s[mid] <= mt)
        lo = mid;
      else
        hi = mid;
    }
    const int end = __ldg(gstarts + lo + 1);
    const int m0 = __ldg(gstarts + lo) + (mt - tiles_s[lo]) * BM;
    const float* wg = w + (size_t)lo * w_stride;
    __syncthreads();  // the last tile's epilogue is done with slot_s
    if (tid < BM) {
      const int s = m0 + tid;
      slot_s[tid] = s < end ? s : -1;
      arow_s[tid] = s < end ? (a_idx != nullptr ? __ldg(a_idx + s) : s) : -1;
    }
    __syncthreads();
    float acc[8][8];
    mainloop<true, W_NK>(
        acc, smem, slabs, mg, ng,
        [&](int s, uint32_t a_dst, uint32_t b_dst) {
          const int k0 = s * BK;
          stage_kmajor<VEC>(a_dst, k0, K, tid, a, [&](int r) -> const float* {
            const int ar = arow_s[r];
            return ar < 0 ? nullptr : a + (size_t)ar * lda;
          });
          if constexpr (W_NK)
            stage_kmajor<VEC>(b_dst, k0, K, tid, wg,
                              [&](int r) -> const float* {
                                return n0 + r < N ? wg + (size_t)(n0 + r) * ldw
                                                  : nullptr;
                              });
          else
            stage_mnmajor<VEC>(
                b_dst, tid, wg, [&](int kr, int n) -> const float* {
                  return k0 + kr < K && n0 + n < N
                             ? wg + (size_t)(k0 + kr) * ldw + n0 + n
                             : nullptr;
                });
        },
        [](int) {});
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = frag_row<true>(mg, i), slot = slot_s[r];
      if (slot < 0) continue;
      float* out =
          c + (size_t)(c_idx != nullptr ? __ldg(c_idx + slot) : slot) * ldc;
      const float sc = scale != nullptr ? __ldg(scale + slot) : 1.0f;
      if constexpr (!W_NK && VEC == 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 64 * h + 4 * ng;
          if (n >= N) continue;
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
          if (scale != nullptr) {
            v.x *= sc;
            v.y *= sc;
            v.z *= sc;
            v.w *= sc;
          }
          *reinterpret_cast<float4*>(out + n) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + frag_row<W_NK>(ng, j);
          if (n < N) out[n] = scale != nullptr ? acc[i][j] * sc : acc[i][j];
        }
      }
    }
  }
}

// Grouped reduction form: block (group e, tile) sums the group's slots;
// dw [G, M, N].
template <int VEC>
__global__ void __launch_bounds__(NT, 2)
    moe_reduce_kernel(const float* __restrict__ a, int lda,
                      const int32_t* __restrict__ a_idx,
                      const float* __restrict__ g, int ldg,
                      const int32_t* __restrict__ g_idx,
                      float* __restrict__ dw,
                      const int32_t* __restrict__ gstarts, int M, int N,
                      int n_tiles, int per_group) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RING = STAGES + 1;
  // rows of a and of g of the slots staged next (-1: none)
  __shared__ int ra_s[RING][BK], rg_s[RING][BK];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mg = (warp / 2) * 4 + lane / 8, ng = (warp % 2) * 8 + lane % 8;
  const int grp = blockIdx.x / per_group, tile = blockIdx.x % per_group;
  const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
  const int k_begin = __ldg(gstarts + grp), k_end = __ldg(gstarts + grp + 1);
  const int slabs = (k_end - k_begin + BK - 1) / BK;
  auto walk = [&](int s) {
    if (tid < BK) {
      const int k = k_begin + BK * s + tid;
      int ra = -1, rg = -1;
      if (k < k_end) {
        ra = a_idx != nullptr ? __ldg(a_idx + k) : k;
        rg = g_idx != nullptr ? __ldg(g_idx + k) : k;
      }
      ra_s[s % RING][tid] = ra;
      rg_s[s % RING][tid] = rg;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) walk(s);
  __syncthreads();
  float acc[8][8];
  mainloop<false, false>(
      acc, smem, slabs, mg, ng,
      [&](int s, uint32_t a_dst, uint32_t b_dst) {
        const int* ra = ra_s[s % RING];
        const int* rg = rg_s[s % RING];
        stage_mnmajor<VEC>(a_dst, tid, a, [&](int kr, int m) -> const float* {
          const int r = ra[kr];
          m += m0;
          return r < 0 || m >= M ? nullptr : a + (size_t)r * lda + m;
        });
        stage_mnmajor<VEC>(b_dst, tid, g, [&](int kr, int n) -> const float* {
          const int r = rg[kr];
          n += n0;
          return r < 0 || n >= N ? nullptr : g + (size_t)r * ldg + n;
        });
      },
      [&](int s) { walk(s + STAGES); });
  float* base = dw + (size_t)grp * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + frag_row<false>(mg, i);
    if (m >= M) continue;
    float* out = base + (size_t)m * N;
    if constexpr (VEC == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 64 * h + 4 * ng;
        if (n < N)
          *reinterpret_cast<float4*>(out + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + frag_row<false>(ng, j);
        if (n < N) out[n] = acc[i][j];
      }
    }
  }
}

template <bool W_NK, int VEC>
int launch_moe_rows(const float* a, int lda, const int* a_idx, const float* w,
                    int ldw, int w_stride, const float* scale, float* c,
                    int ldc, const int* c_idx, const int* gstarts, int G,
                    int slots, int N, int K, cudaStream_t stream) {
  auto kernel = moe_rows_kernel<W_NK, VEC>;
  int resident = 0;
  cudaError_t err = prepare(kernel, rows_smem<W_NK>(), &resident);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BN - 1) / BN;
  // the most row tiles the groups can have: every slot in a group
  const long long bound =
      ((long long)(slots + BM - 1) / BM + G) * (long long)n_tiles;
  if (bound > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(bound < resident ? bound : resident);
  kernel<<<grid, NT, rows_smem<W_NK>(), stream>>>(
      a, lda, a_idx, w, ldw, w_stride, scale, c, ldc, c_idx, gstarts, G, N, K,
      n_tiles);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_moe_reduce(const float* a, int lda, const int* a_idx,
                      const float* g, int ldg, const int* g_idx, float* dw,
                      const int* gstarts, int G, int M, int N,
                      cudaStream_t stream) {
  auto kernel = moe_reduce_kernel<VEC>;
  int resident = 0;
  cudaError_t err = prepare(kernel, kReduceSmem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BN - 1) / BN;
  const long long per_group = (long long)((M + BM - 1) / BM) * n_tiles;
  if (per_group * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(per_group * G), NT, kReduceSmem, stream>>>(
      a, lda, a_idx, g, ldg, g_idx, dw, gstarts, M, N, n_tiles,
      (int)per_group);
  return (int)cudaGetLastError();
}

}  // namespace

// Row form: c[rs] = a[rs] @ W (+ bias) for each live row-step rs = b * T + t
// of the plan (order [B], starts [T + 1]); a [B * T, K] (row stride lda),
// W [K, N] or, with w_nk, [N, K] (row stride ldw), bias [N] or null, c
// [B * T, N] (row stride ldc), whose dead rows are not written. splits from
// cmhse_live_rows_splits; work [splits, B * T, N] when splits > 1 (else
// null).
extern "C" int cmhse_live_rows(const float* a, int lda, const float* w,
                               int ldw, int w_nk, const float* bias, float* c,
                               int ldc, float* work, int splits,
                               const int* order, const int* starts, int B,
                               int T, int N, int K, void* stream) {
  if (B <= 0 || T <= 0 || N <= 0 || K < 0 || splits < 1 ||
      splits > MAX_SPLITS || (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan plan{order, starts, T};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(a) && aligned16(w) && aligned16(c) &&
                   aligned16(work) && lda % 4 == 0 && ldw % 4 == 0 &&
                   ldc % 4 == 0 && K % 4 == 0 && N % 4 == 0;
  if (w_nk)
    return vec ? launch_rows<true, 4>(a, lda, w, ldw, bias, c, ldc, work,
                                      splits, plan, B, N, K, s)
               : launch_rows<true, 1>(a, lda, w, ldw, bias, c, ldc, work,
                                      splits, plan, B, N, K, s);
  return vec ? launch_rows<false, 4>(a, lda, w, ldw, bias, c, ldc, work,
                                     splits, plan, B, N, K, s)
             : launch_rows<false, 1>(a, lda, w, ldw, bias, c, ldc, work,
                                     splits, plan, B, N, K, s);
}

// The splits cmhse_live_rows takes for `rows` = B * T row-steps, N columns
// and depth K on the current device; a negative value is a CUDA error code,
// negated.
extern "C" int cmhse_live_rows_splits(int rows, int N, int K) {
  if (rows < 0 || N <= 0 || K < 0) return -(int)cudaErrorInvalidValue;
  int splits = 1;
  const int err = rows_splits(rows, N, K, &splits);
  return err != 0 ? -err : splits;
}

// Reduction form: dw [M, N] = sum over live row-steps rs of a'[rs]^T g[rs],
// and with db (non-null) db [N] = sum of g[rs]. a' [rs] = a[rs] (row
// stride lda), or with shift a[rs - 1] at t > 0 and h0[b] (row stride lda;
// zeros when null) at t = 0. g[rs] = columns 0 .. n_split - 1 of g0 [B * T,
// ldg0], then n_split .. N - 1 of g1 [B * T, ldg1]. splits from
// cmhse_live_reduce_splits; work [splits, M + (db ? 1 : 0), N] when
// splits > 1 (else null).
extern "C" int cmhse_live_reduce(const float* a, int lda, int shift,
                                 const float* h0, const float* g0, int ldg0,
                                 const float* g1, int ldg1, int n_split,
                                 float* dw, float* db, float* work,
                                 int splits, const int* order,
                                 const int* starts, int B, int T, int M,
                                 int N, void* stream) {
  if (B <= 0 || T <= 0 || M <= 0 || N <= 0 || n_split < 0 || n_split > N ||
      (n_split < N && g1 == nullptr) || splits < 1 || splits > MAX_SPLITS ||
      (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan plan{order, starts, T};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(a) && aligned16(h0) && aligned16(g0) &&
                   aligned16(g1) && aligned16(dw) && aligned16(db) &&
                   aligned16(work) && lda % 4 == 0 && ldg0 % 4 == 0 &&
                   ldg1 % 4 == 0 && n_split % 4 == 0 && M % 4 == 0 &&
                   N % 4 == 0;
  return vec ? launch_reduce<4>(a, lda, shift, h0, g0, ldg0, g1, ldg1,
                                n_split, dw, db, work, splits, plan, M, N, s)
             : launch_reduce<1>(a, lda, shift, h0, g0, ldg0, g1, ldg1,
                                n_split, dw, db, work, splits, plan, M, N, s);
}

// The splits cmhse_live_reduce takes for an output of rows_out rows (M, +1
// with db) x N columns over `rows` = B * T row-steps on the current device;
// a negative value is a CUDA error code, negated.
extern "C" int cmhse_live_reduce_splits(int rows_out, int N, int rows) {
  if (rows_out <= 0 || N <= 0 || rows < 0) return -(int)cudaErrorInvalidValue;
  int splits = 1;
  const int err = reduce_splits(rows_out, N, rows, &splits);
  return err != 0 ? -err : splits;
}

// Grouped row form: for each slot s of group e (gstarts[e] <= s <
// gstarts[e + 1], e < G), c[c_idx[s]] = scale[s] * (a[a_idx[s]] @ W_e),
// W_e = w + e * w_stride, [K, N] or, with w_nk, [N, K] (row stride ldw);
// a_idx / c_idx null read the slot itself, scale null 1. a rows of K (row
// stride lda), c rows of N (row stride ldc); rows of c no slot names are
// not written. `slots` bounds gstarts[G] (the grid is sized from it).
extern "C" int cmhse_moe_rows(const float* a, int lda, const int* a_idx,
                              const float* w, int ldw, int w_stride, int w_nk,
                              const float* scale, float* c, int ldc,
                              const int* c_idx, const int* gstarts, int G,
                              int slots, int N, int K, void* stream) {
  if (G <= 0 || G > MAX_GROUPS || slots < 0 || N <= 0 || K < 0 ||
      w_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(a) && aligned16(w) && aligned16(c) &&
                   lda % 4 == 0 && ldw % 4 == 0 && ldc % 4 == 0 &&
                   w_stride % 4 == 0 && K % 4 == 0 && N % 4 == 0;
  if (w_nk)
    return vec ? launch_moe_rows<true, 4>(a, lda, a_idx, w, ldw, w_stride,
                                          scale, c, ldc, c_idx, gstarts, G,
                                          slots, N, K, s)
               : launch_moe_rows<true, 1>(a, lda, a_idx, w, ldw, w_stride,
                                          scale, c, ldc, c_idx, gstarts, G,
                                          slots, N, K, s);
  return vec ? launch_moe_rows<false, 4>(a, lda, a_idx, w, ldw, w_stride,
                                         scale, c, ldc, c_idx, gstarts, G,
                                         slots, N, K, s)
             : launch_moe_rows<false, 1>(a, lda, a_idx, w, ldw, w_stride,
                                         scale, c, ldc, c_idx, gstarts, G,
                                         slots, N, K, s);
}

// Grouped reduction form: dw [G, M, N], dw[e] = sum over the slots s of
// group e of a[a_idx[s]]^T g[g_idx[s]] (a rows of M, row stride lda; g rows
// of N, row stride ldg; a null index reads the slot itself). Every entry of
// dw is written.
extern "C" int cmhse_moe_reduce(const float* a, int lda, const int* a_idx,
                                const float* g, int ldg, const int* g_idx,
                                float* dw, const int* gstarts, int G, int M,
                                int N, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(a) && aligned16(g) && aligned16(dw) &&
                   lda % 4 == 0 && ldg % 4 == 0 && M % 4 == 0 && N % 4 == 0;
  return vec ? launch_moe_reduce<4>(a, lda, a_idx, g, ldg, g_idx, dw, gstarts,
                                    G, M, N, s)
             : launch_moe_reduce<1>(a, lda, a_idx, g, ldg, g_idx, dw, gstarts,
                                    G, M, N, s);
}
