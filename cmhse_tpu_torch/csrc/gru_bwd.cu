// Masked GRU backward time loop (BPTT) for Hopper (sm_90a), f32.
//
// Replaces cmhse_tpu/ops/pallas_gru_grad.py:_gru_bwd_kernel, with and
// without the seeded h0. It reads the gates [r, z, n, hn] that the
// gate-saving forward (gru_fwd.cu) wrote and walks time backwards:
//
//   dh  = dh_carry + douts[t]             (dfinal seeds dh_carry at t = T-1)
//   live (t < len):
//     dn = dh (1 - z)    dz = dh (h_prev - n)    dn' = dn (1 - n^2)
//     dr = dn' hn        dhn = dn' r   dz' = dz z (1 - z)   dr' = dr r (1 - r)
//     dxw[t] = [dr', dz', dn']        dhn[t] = dhn
//     dh_carry = dh z + [dr', dz', dhn] @ W_h^T
//   masked (t >= len): dxw[t] = dhn[t] = 0, dh_carry = dh (passed through)
//   dh0 = dh_carry after the t = 0 step
//
// with h_prev = outs[t - 1], or h0 (zeros unseeded) at t = 0. A masked step
// selects on t < len and never reads its gates (the forward leaves them
// unwritten), so garbage there cannot leak in as NaN * 0. The bias sums of
// [dr', dz', dn', dhn] over the block's rows and all steps leave as one
// [4H] partial per block, which the wrapper sums: no float atomics, so the
// result does not change from run to run.
//
// Design. The forward's shape: one block owns kRows = 8 batch rows and ALL
// H units and runs the reversed time loop itself, so blocks never talk to
// each other. Each thread owns kUnits consecutive units (j..j+3, and
// j + 1024 when H is larger) for all 8 rows, in both phases of a step:
//   1. the gate gradients of its units, from the saved gates, into shared
//      memory as dhw [3H][kRows] (k-major, two 16-byte broadcast loads per
//      k), and dh z (or the pass-through dh) into the carry dh [H][kRows];
//   2. after one barrier, its units' columns of dhw @ W_h^T (K = 3H), read
//      row by row from a transposed copy W_h^T [3H, H] that the wrapper
//      makes once per call, 16-byte loads with kPrefetch rows in flight,
//      added to the carry of the live rows.
// A thread reads and writes only its own units of the carry, so the carry
// needs no double buffer; a second barrier keeps the next step's phase 1
// from overwriting dhw while phase 2 still reads it. Shared memory is
// 4 * 32 * H bytes (128 KB at H = 1024), so H is at most 1,816.
//
// What bounds it on an H100: as in the forward, W_h^T (12.6 MB at H = 1024)
// does not fit on chip, so every block streams all of it from L2 once per
// live step at 8 FMAs per element read, and a call costs T steps of one
// SM's work on B / 8 blocks (64 of 132 SMs at 512 rows, 8 at 64 rows).
// Steps where all 8 rows are masked skip the product. Splitting W_h^T
// across the SMs is the same later redesign as the forward's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;      // batch rows per block
constexpr int kUnits = 4;     // consecutive hidden units per thread (a float4)
constexpr int kPrefetch = 4;  // W_h^T rows whose loads run ahead of the FMAs
constexpr int kThreads = 256;
constexpr int kMaxGroups = 2;  // unit groups per thread: H <= 2 * 4 * 256
static_assert(kRows == 8, "the float4 dhw loads below assume 8 rows");

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float4& acc, float h, float4 w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

__device__ __forceinline__ float& at(float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const float* __restrict__ gates,     // [B, T, 4H]
               const float* __restrict__ outs,      // [B, T, H]
               const float* __restrict__ h_init,    // [B, H] or null
               const float* __restrict__ douts,     // [B, T, H] or null
               const float* __restrict__ dfinal,    // [B, H] or null
               const int32_t* __restrict__ lengths, // [B]
               const float* __restrict__ w_hT,      // [3H, H]
               float* __restrict__ dxw,             // [B, T, 3H]
               float* __restrict__ dhn_out,         // [B, T, H]
               float* __restrict__ db_part,         // [gridDim.x, 4H]
               float* __restrict__ dh0,             // [B, H] or null
               int B, int T, int H) {
  extern __shared__ float4 smem4[];
  float* dh_s = reinterpret_cast<float*>(smem4);  // [H][kRows] the carry
  float* dhw_s = dh_s + H * kRows;                // [3H][kRows]
  const int row0 = blockIdx.x * kRows;
  const int stride = kUnits * blockDim.x;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  int len[kRows];
  int max_len = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = row0 + r;
    len[r] = b < B ? lengths[b] : 0;
    max_len = max(max_len, min(len[r], T));
  }
  for (int i = threadIdx.x; i < H * kRows; i += blockDim.x) {
    const int b = row0 + i % kRows;  // k-major: [H][kRows]
    dh_s[i] = (dfinal != nullptr && b < B) ? dfinal[(size_t)b * H + i / kRows]
                                           : 0.0f;
  }
  float4 db[kMaxGroups][4];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
    for (int s = 0; s < 4; ++s) db[g][s] = zero4;
  __syncthreads();  // the carry's seed was written across threads' units

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase 1: gate gradients of this thread's units, all rows -------
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int j = kUnits * threadIdx.x + g * stride;
      if (j >= H) break;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        const bool live = b < B && t < len[r];
        float4 dh = make_float4(dh_s[j * kRows + r], dh_s[(j + 1) * kRows + r],
                                dh_s[(j + 2) * kRows + r],
                                dh_s[(j + 3) * kRows + r]);
        if (douts != nullptr && b < B)
          dh = add4(dh, ldg4(douts + ((size_t)b * T + t) * H + j));
        float4 carry = dh, dr4 = zero4, dz4 = zero4, dn4 = zero4,
               dhn4 = zero4;
        if (live) {
          const float* gp = gates + ((size_t)b * T + t) * 4 * H + j;
          float4 rg = ldg4(gp), zg = ldg4(gp + H), ng = ldg4(gp + 2 * H),
                 hng = ldg4(gp + 3 * H);
          float4 hp = zero4;
          if (t > 0)
            hp = ldg4(outs + ((size_t)b * T + t - 1) * H + j);
          else if (h_init != nullptr)
            hp = ldg4(h_init + (size_t)b * H + j);
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            const float d = at(dh, u), r_ = at(rg, u), z_ = at(zg, u),
                        n_ = at(ng, u);
            const float dn = d * (1.0f - z_);
            const float dz = d * (at(hp, u) - n_);
            const float dn_pre = dn * (1.0f - n_ * n_);
            const float dr = dn_pre * at(hng, u);
            at(dhn4, u) = dn_pre * r_;
            at(dz4, u) = dz * z_ * (1.0f - z_);
            at(dr4, u) = dr * r_ * (1.0f - r_);
            at(dn4, u) = dn_pre;
            at(carry, u) = d * z_;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          dh_s[(j + u) * kRows + r] = at(carry, u);
          dhw_s[(j + u) * kRows + r] = at(dr4, u);
          dhw_s[(H + j + u) * kRows + r] = at(dz4, u);
          dhw_s[(2 * H + j + u) * kRows + r] = at(dhn4, u);
        }
        if (b < B) {
          float* dx = dxw + ((size_t)b * T + t) * 3 * H + j;
          *reinterpret_cast<float4*>(dx) = dr4;
          *reinterpret_cast<float4*>(dx + H) = dz4;
          *reinterpret_cast<float4*>(dx + 2 * H) = dn4;
          *reinterpret_cast<float4*>(dhn_out + ((size_t)b * T + t) * H + j) =
              dhn4;
        }
        db[g][0] = add4(db[g][0], dr4);
        db[g][1] = add4(db[g][1], dz4);
        db[g][2] = add4(db[g][2], dn4);
        db[g][3] = add4(db[g][3], dhn4);
      }
    }
    if (t >= max_len) continue;  // all 8 rows masked: dh passed through
    __syncthreads();  // dhw complete

    // ---- phase 2: carry += dhw @ W_h^T for the live rows ------------------
    const float4* dhw4 = reinterpret_cast<const float4*>(dhw_s);
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int j = kUnits * threadIdx.x + g * stride;
      if (j >= H) break;
      float4 acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = zero4;
      const float* wcol = w_hT + j;
      float4 pw[kPrefetch];
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) pw[p] = ldg4(wcol + (size_t)p * H);
      // 3H is a multiple of kPrefetch (the wrapper checks H % 4 == 0)
      for (int k0 = 0; k0 < 3 * H; k0 += kPrefetch) {
#pragma unroll
        for (int p = 0; p < kPrefetch; ++p) {
          const int k = k0 + p;
          const float4 w = pw[p];
          if (k + kPrefetch < 3 * H)
            pw[p] = ldg4(wcol + (size_t)(k + kPrefetch) * H);
          const float4 d0 = dhw4[2 * k];
          const float4 d1 = dhw4[2 * k + 1];
          const float dv[kRows] = {d0.x, d0.y, d0.z, d0.w,
                                   d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) fma4(acc[r], dv[r], w);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!(row0 + r < B && t < len[r])) continue;
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          dh_s[(j + u) * kRows + r] += at(acc[r], u);
      }
    }
    __syncthreads();  // phase 2's reads of dhw are done
  }

#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    const int j = kUnits * threadIdx.x + g * stride;
    if (j >= H) break;
    float* part = db_part + (size_t)blockIdx.x * 4 * H + j;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<float4*>(part + s * H) = db[g][s];
    if (dh0 == nullptr) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = row0 + r;
      if (b < B)
        *reinterpret_cast<float4*>(dh0 + (size_t)b * H + j) =
            make_float4(dh_s[j * kRows + r], dh_s[(j + 1) * kRows + r],
                        dh_s[(j + 2) * kRows + r], dh_s[(j + 3) * kRows + r]);
    }
  }
}

}  // namespace

// H must be a multiple of 4, at most cmhse_gru_bwd_max_hidden(), and every
// pointer 16-byte aligned (the wrapper checks all three). h0, douts, dfinal
// and dh0 may each be null; db_part has one [4H] row per block of 8 rows.
extern "C" int cmhse_gru_bwd(const float* gates, const float* outs,
                             const float* h0, const float* douts,
                             const float* dfinal, const int32_t* lengths,
                             const float* w_hT, float* dxw, float* dhn,
                             float* db_part, float* dh0, int B, int T, int H,
                             void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % kUnits != 0 ||
      H > kMaxGroups * kUnits * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)H * kRows * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      gates, outs, h0, douts, dfinal, lengths, w_hT, dxw, dhn, db_part, dh0,
      B, T, H);
  return (int)cudaGetLastError();
}

// Rows per block: the number of db_part rows is ceil(B / this).
extern "C" int cmhse_gru_bwd_rows_per_block() { return kRows; }

// Largest H the kernel takes: its shared memory (4 * 32 * H bytes) and the
// two unit groups a thread owns.
extern "C" int cmhse_gru_bwd_max_hidden() {
  const int by_smem = 232448 / (4 * kRows * (int)sizeof(float)) / kUnits *
                      kUnits;
  return by_smem < kMaxGroups * kUnits * kThreads ? by_smem
                                                  : kMaxGroups * kUnits *
                                                        kThreads;
}
