// Masked GRU forward time loop for Hopper (sm_90a), f32.
//
// Replaces cmhse_tpu/ops/pallas_gru.py:_gru_kernel, all three of its f32
// variants as template flags of one kernel: the encode path's (no flag), the
// training path's save_gates (also streams the gates [r, z, n, hn] that the
// backward kernel, gru_bwd.cu, reads) and with_h0 (the carry starts at the
// caller's h0, the reconstruction decoder's). The input projection
// x @ W_i + b_i is one large matrix product outside this kernel; the kernel
// runs the sequential part:
//
//   hw = h @ W_h + b_h                         (gate order r, z, n)
//   r = sigmoid(xw_r + hw_r)   z = sigmoid(xw_z + hw_z)
//   n = tanh(xw_n + r * hw_n)  h' = (1 - z) * n + z * h
//   h = t < len ? h' : h       outs[b, t] = h      final[b] = h
//   gates[b, t] = [r, z, n, hw_n]                  (save_gates, t < len only)
//
// The gates of a step at or past a row's length are NOT written (the buffer
// holds whatever it held): the backward selects on t < len and never reads
// them, so no zeros are streamed for padding.
//
// Design. One block owns kRows batch rows and ALL H hidden units, and runs
// the whole time loop itself: batch rows are independent in a GRU, so blocks
// never talk to each other. The state h lives in shared memory in f32,
// double-buffered (read the old state, write the new one, one barrier per
// step), stored k-major ([H][kRows]) so that the kRows values a thread needs
// for one k are two 16-byte broadcast loads. Each thread owns kUnits
// consecutive hidden units j..j+3 (and j + 4 * blockDim, ... when H is
// larger) and accumulates their three gate columns (j, H + j, 2H + j, four
// wide) of h @ W_h for its kRows rows over K = H. W_h is read row by row as
// 16-byte loads, neighbouring threads on neighbouring columns, with
// kPrefetch rows of loads in flight ahead of the FMAs that use them.
//
// What bounds it on an H100: W_h (H x 3H f32, 12.6 MB at H = 1024) does not
// fit in shared memory, so every block streams all of it from L2 once per
// step and does kRows FMAs per W_h element it reads. Measured at H = 1024
// (PERF.md): ~0.19 ms per step whether 8 or 64 blocks run — about half the
// SM's FMA rate and ~65 GB/s of W_h into the SM, both near their limits at
// kRows = 8 — so the time is T steps of one SM's work, and neither more nor
// fewer rows per block shortens it. Rows past the block's longest sequence
// skip the product and only copy the carried state to outs. Known weak
// point: a 512-row call fills 64 of 132 SMs and a 64-row call 8. Splitting
// H across the SMs (a cooperative grid or clusters, each SM keeping a
// ~96 KB slice of W_h in shared memory and exchanging h every step) is the
// later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;      // batch rows per block
constexpr int kUnits = 4;     // consecutive hidden units per thread (a float4)
constexpr int kPrefetch = 4;  // W_h rows whose loads run ahead of the FMAs
constexpr int kThreads = 256;
static_assert(kRows == 8, "the float4 state loads below assume 8 rows");

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float4& acc, float h, float4 w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

__device__ __forceinline__ float get(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <bool kSaveGates, bool kWithH0>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const float* __restrict__ xw,        // [B, T, 3H]
               const float* __restrict__ w_h,       // [H, 3H]
               const float* __restrict__ b_h,       // [3H]
               const int32_t* __restrict__ lengths, // [B]
               const float* __restrict__ h_init,    // [B, H] (kWithH0)
               float* __restrict__ outs,            // [B, T, H]
               float* __restrict__ final_h,         // [B, H]
               float* __restrict__ gates,           // [B, T, 4H] (kSaveGates)
               int B, int T, int H) {
  extern __shared__ float4 smem4[];
  float* cur = reinterpret_cast<float*>(smem4);  // [H][kRows]
  float* nxt = cur + H * kRows;                  // [H][kRows]
  const int H3 = 3 * H;
  const int row0 = blockIdx.x * kRows;
  const int stride = kUnits * blockDim.x;

  int len[kRows];
  int max_len = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = row0 + r;
    len[r] = b < B ? lengths[b] : 0;
    max_len = max(max_len, min(len[r], T));
  }
  for (int i = threadIdx.x; i < H * kRows; i += blockDim.x) {
    if constexpr (kWithH0) {
      const int b = row0 + i % kRows;  // cur is k-major: [H][kRows]
      cur[i] = b < B ? h_init[(size_t)b * H + i / kRows] : 0.0f;
    } else {
      cur[i] = 0.0f;
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t >= max_len) {
      // every row of this block is past its length: the state is frozen
      for (int j = kUnits * threadIdx.x; j < H; j += stride) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int b = row0 + r;
          if (b < B)
            *reinterpret_cast<float4*>(&outs[((size_t)b * T + t) * H + j]) =
                make_float4(cur[j * kRows + r], cur[(j + 1) * kRows + r],
                            cur[(j + 2) * kRows + r], cur[(j + 3) * kRows + r]);
        }
      }
      continue;
    }
    const float4* cur4 = reinterpret_cast<const float4*>(cur);
    for (int j = kUnits * threadIdx.x; j < H; j += stride) {
      float4 ar[kRows], az[kRows], an[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ar[r] = az[r] = an[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float* wcol = w_h + j;
      float4 pr[kPrefetch], pz[kPrefetch], pn[kPrefetch];
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const float* wrow = wcol + (size_t)p * H3;
        pr[p] = ldg4(wrow);
        pz[p] = ldg4(wrow + H);
        pn[p] = ldg4(wrow + 2 * H);
      }
      // H is a multiple of kPrefetch (the wrapper checks H % 4 == 0)
      for (int k0 = 0; k0 < H; k0 += kPrefetch) {
#pragma unroll
        for (int p = 0; p < kPrefetch; ++p) {
          const int k = k0 + p;
          const float4 wr = pr[p], wz = pz[p], wn = pn[p];
          if (k + kPrefetch < H) {
            const float* wrow = wcol + (size_t)(k + kPrefetch) * H3;
            pr[p] = ldg4(wrow);
            pz[p] = ldg4(wrow + H);
            pn[p] = ldg4(wrow + 2 * H);
          }
          const float4 h0 = cur4[2 * k];
          const float4 h1 = cur4[2 * k + 1];
          const float hv[kRows] = {h0.x, h0.y, h0.z, h0.w,
                                   h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            fma4(ar[r], hv[r], wr);
            fma4(az[r], hv[r], wz);
            fma4(an[r], hv[r], wn);
          }
        }
      }
      const float4 br = ldg4(b_h + j), bz = ldg4(b_h + H + j),
                   bn = ldg4(b_h + 2 * H + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        const bool live = b < B && t < len[r];
        float4 xr = br, xz = bz, xn = bn;  // placeholders when not live
        if (live) {
          const float* x = xw + ((size_t)b * T + t) * H3;
          xr = ldg4(x + j);
          xz = ldg4(x + H + j);
          xn = ldg4(x + 2 * H + j);
        }
        float hn[kUnits], gr[kUnits], gz[kUnits], gn[kUnits], ghn[kUnits];
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const float h_prev = cur[(j + u) * kRows + r];
          float h_new = h_prev;
          if (live) {
            ghn[u] = get(an[r], u) + get(bn, u);
            gr[u] = sigmoid_f(get(xr, u) + (get(ar[r], u) + get(br, u)));
            gz[u] = sigmoid_f(get(xz, u) + (get(az[r], u) + get(bz, u)));
            gn[u] = tanhf(get(xn, u) + gr[u] * ghn[u]);
            h_new = (1.0f - gz[u]) * gn[u] + gz[u] * h_prev;
          }
          nxt[(j + u) * kRows + r] = h_new;
          hn[u] = h_new;
        }
        if constexpr (kSaveGates) {
          if (live) {
            float* g = gates + ((size_t)b * T + t) * 4 * H + j;
            *reinterpret_cast<float4*>(g) =
                make_float4(gr[0], gr[1], gr[2], gr[3]);
            *reinterpret_cast<float4*>(g + H) =
                make_float4(gz[0], gz[1], gz[2], gz[3]);
            *reinterpret_cast<float4*>(g + 2 * H) =
                make_float4(gn[0], gn[1], gn[2], gn[3]);
            *reinterpret_cast<float4*>(g + 3 * H) =
                make_float4(ghn[0], ghn[1], ghn[2], ghn[3]);
          }
        }
        if (b < B)
          *reinterpret_cast<float4*>(&outs[((size_t)b * T + t) * H + j]) =
              make_float4(hn[0], hn[1], hn[2], hn[3]);
      }
    }
    __syncthreads();  // all reads of cur are done and nxt is complete
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int j = kUnits * threadIdx.x; j < H; j += stride) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = row0 + r;
      if (b < B)
        *reinterpret_cast<float4*>(&final_h[(size_t)b * H + j]) =
            make_float4(cur[j * kRows + r], cur[(j + 1) * kRows + r],
                        cur[(j + 2) * kRows + r], cur[(j + 3) * kRows + r]);
    }
  }
}

template <bool kSaveGates, bool kWithH0>
int launch_gru_fwd(const float* xw, const float* w_h, const float* b_h,
                   const int32_t* lengths, const float* h0, float* outs,
                   float* final_h, float* gates, int B, int T, int H,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)H * kRows * sizeof(float);
  auto kernel = gru_fwd_kernel<kSaveGates, kWithH0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(xw, w_h, b_h, lengths, h0, outs,
                                           final_h, gates, B, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// H must be a multiple of 4 and every pointer 16-byte aligned (the wrapper
// checks both). h0 (the seeded variant) and gates (the gate-saving variant)
// may each be null; the instantiation is chosen by which are given.
extern "C" int cmhse_gru_fwd(const float* xw, const float* w_h,
                             const float* b_h, const int32_t* lengths,
                             const float* h0, float* outs, float* final_h,
                             float* gates, int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % kUnits != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (gates != nullptr && h0 != nullptr)
    return launch_gru_fwd<true, true>(xw, w_h, b_h, lengths, h0, outs,
                                      final_h, gates, B, T, H, s);
  if (gates != nullptr)
    return launch_gru_fwd<true, false>(xw, w_h, b_h, lengths, h0, outs,
                                       final_h, gates, B, T, H, s);
  if (h0 != nullptr)
    return launch_gru_fwd<false, true>(xw, w_h, b_h, lengths, h0, outs,
                                       final_h, gates, B, T, H, s);
  return launch_gru_fwd<false, false>(xw, w_h, b_h, lengths, h0, outs,
                                      final_h, gates, B, T, H, s);
}

// Message for an error code returned by any launcher of this library.
extern "C" const char* cmhse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
